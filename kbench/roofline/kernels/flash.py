"""flash: the program's bf16 flash attention kernel (csrc/flash_attention.cu),
q [B, H, S, D] against k/v [B, Hkv, T, D], one launch a call. Calls on f32
tensors run another kernel (csrc/flash_attention_f32.cu) and are not this
family's."""

from kbench.roofline.costs import bound_s as _bound_s, flash_cost

KERNELS = ("flash_fwd_kernel",)
ENTRY = "kjarni_tpu_torch.ops.kernels.flash_attention:flash_attention"


def record(args, kwargs):
    """(B, H, Hkv, S, T, D, causal, window, q_offset, kv_len), or None for
    an f32 call."""
    q, k = [*args, *(kwargs[n] for n in ("q", "k")[len(args):])][:2]
    if q.dtype.itemsize != 2:
        return None
    B, H, S, D = q.shape
    kv_len = kwargs.get("kv_len")
    return (B, H, k.shape[1], S, k.shape[2], D, kwargs.get("causal", False),
            kwargs.get("window"), int(kwargs.get("q_offset", 0)),
            k.shape[2] if kv_len is None else int(kv_len))


def bound_s(rec) -> float:
    return _bound_s(*flash_cost(*rec))
