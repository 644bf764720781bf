"""The causal-LM training step over the ("dp", "tp") mesh (port of
kjarni_tpu/parallel/train.py).

`causal_lm_loss` is the masked next-token cross-entropy over llama's
`forward_all_logits`, and `sgd_train_step` one SGD step `p - lr * g` on
every float leaf, as in the JAX package. Autograd runs through plain
PyTorch: the forward attends with the plain attention (no flash, as JAX's
loss) and no KV cache is written (models/llama.py's cache-free path).

The JAX package jits one program over sharded arrays and GSPMD inserts the
collectives. Here each rank holds its shard (parallel/mesh.py) and its dp
rows of the batch, and the collectives are explicit:
- tp: llama's forward takes the tp group's Comm; its Megatron pair
  (`Comm.copy_in` / `reduce_out`) and the head's `gather_out` carry the
  gradients across ranks, so a sharded leaf's gradient is its shard of the
  whole gradient and a replicated one is whole on every rank;
- dp: each rank's loss is its rows' summed nll over the global mask count
  (one all-reduce of the count), so the gradients summed over dp
  (`Comm.sum_grads`) are those of JAX's global mean, masks that differ
  across ranks included; the loss is that sum too.

Leaves. Every float leaf is a leaf of its own, as in JAX's pytree: the
rope tables take their gradient and step, and a tied head (the port keeps
`lm_head` as a view `embed.t()`) becomes a separate leaf with its own
gradient, as JAX's `embed.T` array is. After the step the head is no
longer tied. An integer (quantized) leaf makes `jax.value_and_grad` raise
TypeError, and it does here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models import llama as kllama
from .comm import Comm


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif torch.is_tensor(tree):
        yield path, tree


def _rebuild(tree, new: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, path + (k,)) for k, v in tree.items()}
    return new.get(path, tree)


def _check_float(params: dict) -> None:
    for path, t in _leaves(params):
        if not t.is_floating_point():
            raise TypeError(
                f"the training step differentiates every leaf and "
                f"{'/'.join(path)} is {t.dtype}: grad requires floating-point "
                f"params (quantized params cannot be trained)")


def causal_lm_loss(params: dict, cfg: kllama.DecoderConfig, ids: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor,
                   tp: Optional[Comm] = None, dp: Optional[Comm] = None
                   ) -> torch.Tensor:
    """Next-token cross-entropy. ids/labels/mask: [B, S], this rank's rows.

    sum(nll * m) / max(sum(m), 1) over the whole batch: under dp the count
    is summed over the group and the result is this rank's share, whose sum
    over dp is the loss (sgd_train_step sums it)."""
    logits, _, _ = kllama.forward_all_logits(params, cfg, ids, None, None, 0, tp=tp)
    # f32 at least, as JAX's astype(float32); an f64 reference stays f64
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    m = mask.to(logp.dtype)
    count = m.sum()
    if dp is not None:
        count = dp.all_reduce(count.detach().clone())
    return (nll * m).sum() / torch.clamp(count, min=1.0)


def loss_and_grads(params: dict, cfg: kllama.DecoderConfig, ids: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor,
                   tp: Optional[Comm] = None, dp: Optional[Comm] = None
                   ) -> tuple[torch.Tensor, dict]:
    """JAX's `value_and_grad(causal_lm_loss)`: (loss, gradients in the
    params' tree) of this rank's shard, summed over dp. The params must not
    be inference tensors (build them outside `torch.inference_mode()`, not
    from a DecoderLM)."""
    _check_float(params)
    paths, leaves = [], []
    for path, t in _leaves(params):
        paths.append(path)
        # a leaf of its own even where it shares storage (the tied head)
        leaves.append(t.detach().requires_grad_(True))
    with torch.enable_grad():
        loss = causal_lm_loss(_rebuild(params, dict(zip(paths, leaves))), cfg,
                              ids, labels, mask, tp=tp, dp=dp)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    loss = loss.detach()
    if dp is not None:
        grads = dp.sum_grads(grads)
        loss = dp.all_reduce(loss.clone())
    return loss, _rebuild(params, dict(zip(paths, grads)))


def sgd_train_step(params: dict, cfg: kllama.DecoderConfig, ids: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor, lr: float = 1e-3,
                   tp: Optional[Comm] = None, dp: Optional[Comm] = None
                   ) -> tuple[dict, torch.Tensor]:
    """One SGD step: (new params, loss). `params` is this rank's shard
    (parallel/mesh.py) and is left as it was; ids/labels/mask are this
    rank's dp rows."""
    loss, grads = loss_and_grads(params, cfg, ids, labels, mask, tp=tp, dp=dp)
    g = dict(_leaves(grads))
    new = {p: t.detach() - lr * g[p].to(t.dtype) for p, t in _leaves(params)}
    return _rebuild(params, new), loss
