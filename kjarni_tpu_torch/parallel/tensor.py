"""Tensor-parallel pieces of the encoder and encoder-decoder forwards (BERT,
T5, BART, Whisper), on whatever layout a family's rule gave each leaf.

The JAX package shards these families' params by a rule tree and GSPMD
computes the same numbers whatever the layout; a dim that does not divide
tp replicates its leaf there (parallel/mesh.py). Here each rank computes
with the leaves it holds, leaf by leaf:
- a column-parallel linear (q, k, v, fc1, wi, the head) is `x @ w + b` on
  this rank's columns, or on all of them where the leaf is replicated;
  attention runs on the heads the q/k/v widths hold (`local_heads`);
- a row-parallel linear (`row`: o, fc2, wo, cross_o) multiplies this
  rank's slice of its input by its rows and sums the partial products over
  the group, its bias added once after the sum; where the rule left the
  input whole (nomic's gate and up, which it does not name) the rank takes
  its own slice of it first, and a replicated weight needs no sum;
- a per-head table the rule replicates (T5's and mpnet's relative position
  biases) gives each rank its own heads' part (`own_heads`);
- a column-parallel head's logits are gathered (`gather_cols`).
With tp None every function is the plain single-process op.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.errors import InvalidConfigError


def local_heads(width: int, head_dim: int) -> int:
    """The heads a q/k/v projection of `width` output columns holds."""
    if width % head_dim:
        raise InvalidConfigError(
            f"a tensor-parallel shard of {width} columns splits a head of "
            f"{head_dim}: the heads must divide tp")
    return width // head_dim


def own_heads(t: torch.Tensor, n_local: int, tp, dim: int = 1) -> torch.Tensor:
    """This rank's n_local heads of a per-head tensor whose `dim` holds every
    head (a mask that broadcasts over heads, size 1, passes as it is)."""
    if tp is None or t.shape[dim] in (1, n_local):
        return t
    return t.narrow(dim, tp.rank * n_local, n_local)


def row(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], tp,
        full_k: int) -> torch.Tensor:
    """x @ w (+ b) for a row-parallel w [K_local, N] of a K = full_k input."""
    k = w.shape[-2]
    if tp is not None and x.shape[-1] != k:
        x = x.narrow(-1, tp.rank * k, k)
    y = x @ w
    if tp is not None and k != full_k:
        y = tp.reduce_out(y)
    return y if b is None else y + b


def gather_cols(y: torch.Tensor, tp, full_n: int) -> torch.Tensor:
    """A column-parallel output's columns from every rank (a replicated
    head's output is whole already)."""
    if tp is None or y.shape[-1] == full_n:
        return y
    return tp.gather_out(y, dim=-1)
