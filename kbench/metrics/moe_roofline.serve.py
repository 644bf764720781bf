"""moe_roofline.serve: the routed experts' grouped GEMM's (the `moe` kernel
family, torch's CUTLASS grouped GEMM) share of its roofline over the traced
slice, in percent: the least time of every recorded launch
(roofline/kernels/moe.py::bound_s: its FLOPs, or the weights of the experts
that received rows and the rows read and written) over the kernels' device
time in the trace."""


def read(run):
    return None if run.slice is None else run.slice.roofline_pct("moe")
