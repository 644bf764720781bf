"""moe.device_share.serve: the routed experts' grouped GEMM's (the `moe`
kernel family) device time over the card's busy time in the traced slice, in
percent. Nothing where the slice ran none of its kernels."""


def read(run):
    sl = run.slice
    if sl is None or not sl.device_s.get("moe") or not sl.busy_s:
        return None
    return 100.0 * sl.device_s["moe"] / sl.busy_s
