"""int4_roofline.stream: the int4 kernels' (csrc/int4_matvec.cu, GEMV and GEMM)
share of their roofline over the traced slice, in percent: the least time of
every recorded launch (roofline/costs.py::int4_cost at its shapes) over the
kernels' device time in the trace."""


def read(run):
    return None if run.slice is None else run.slice.roofline_pct("int4")
