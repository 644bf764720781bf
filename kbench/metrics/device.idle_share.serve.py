"""device.idle_share.serve: the share of the traced slice in which no kernel,
copy or set ran on the card (1 - busy_s / window_s), in percent. Device
trace."""


def read(run):
    sl = run.slice
    return None if sl is None else 100.0 * (1.0 - sl.busy_s / sl.window_s)
