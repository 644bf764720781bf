"""int4: the program's int4 GEMV and GEMMs (csrc/int4_matvec.cu), x [M, K] @
packed w4 [K/2, N] with f32 scales [G, N], one launch a call."""

from kbench.roofline.costs import bound_s as _bound_s, int4_cost

KERNELS = ("int4_gemv_kernel", "int4_gemm_kernel")
ENTRY = "kjarni_tpu_torch.ops.kernels.int4_matvec:int4_matvec"


def record(args, kwargs):
    """(M, K, N, G, x bytes read, y bytes written): the GEMV reads x in its
    own type, the GEMMs read it as bf16; y comes back in x's type."""
    x, w4, scale = [*args, *(kwargs[n] for n in ("x", "w4", "scale")[len(args):])]
    M, K = x.shape
    xb = x.element_size() if M == 1 else 2
    return (M, K, w4.shape[1], scale.shape[0], xb, x.element_size())


def bound_s(rec) -> float:
    M, K, N, G, xb, yb = rec
    return _bound_s(*int4_cost(M, K, N, G, xb, yb))
