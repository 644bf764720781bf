"""moe: the program's grouped GEMM of the routed experts
(`kjarni_tpu_torch/ops/moe.py::grouped_mm`, torch's CUTLASS grouped GEMM on
sm90 in bf16): x [M, K], its rows sorted by expert, times w [E, K, N] over
the groups' end offsets, one GEMM kernel a call. torch also launches a small
kernel that lays out the groups' pointers (`prepare_grouped_gemm_data`); it
is not this family's. Calls in f32 take torch's fallback loop and are not
this family's either."""

import importlib.util

import torch

from kbench.roofline.costs import bound_s as _bound_s

KERNELS = ("GroupProblemShape",)
PROGRAM = "kjarni_tpu_torch.ops.moe"


def _entry() -> str:
    """The program's grouped GEMM; for a program that has none (one older
    than this family), a stand-in that nothing calls, so that its traced
    runs install this family and read nothing from it."""
    try:
        found = importlib.util.find_spec(PROGRAM) is not None
    except ImportError:
        found = False
    return f"{PROGRAM}:grouped_mm" if found else "kbench.roofline.absent:entry"


ENTRY = _entry()


def record(args, kwargs):
    """(M, K, N, E, element bytes, offs), or None for an f32 call. offs is
    the call's own device tensor of offsets, which the program never writes
    again: it is read on the host only once the slice has ended."""
    x, w, offs = [*args, *(kwargs[n] for n in ("x", "w", "offs")[len(args):])]
    if x.dtype != torch.bfloat16:
        return None
    M, K = x.shape
    E, _, N = w.shape
    return (M, K, N, E, x.element_size(), offs)


def bound_s(rec) -> float:
    """max(2 M K N / the bf16 peak, bytes / HBM rate); bytes: the weights of
    the experts that received rows, the rows read and the rows written."""
    M, K, N, E, eb, offs = rec
    ends = torch.as_tensor(offs).cpu().long()
    used = int((torch.diff(ends, prepend=ends.new_zeros(1)) > 0).sum())
    return _bound_s(2.0 * M * K * N, eb * (used * K * N + M * K + M * N))
