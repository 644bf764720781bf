"""flash_roofline.serve: the flash kernel's (csrc/flash_attention.cu) share of
its roofline over the traced slice, in percent: the least time of every
recorded launch (roofline/costs.py::flash_cost at its shapes, causal pairs
within q_offset and kv_len) over the kernel's device time in the trace."""


def read(run):
    return None if run.slice is None else run.slice.roofline_pct("flash")
