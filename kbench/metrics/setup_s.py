"""setup_s: seconds from the process's start to the window's start (imports,
weights drawn on the card, quantization, caches, warm-up); the harness's clock."""


def read(run):
    return run.setup_s
