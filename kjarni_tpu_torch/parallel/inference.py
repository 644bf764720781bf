"""Data-parallel encoder batches (port of kjarni_tpu/parallel/inference.py).

Every rank holds the whole (small) encoder, takes its share of the batch's
rows, encodes and pools them (or scores them with a head), and only those
per-row results are all-gathered over the group, so each rank returns the
whole batch. The rows are padded to a multiple of the group's size first; a
pad row has mask 1, so pooling never divides by zero, and the pad rows are
dropped from the result.

The JAX package's `replicate_params` and `dp_batch_sharding` place arrays on
a device mesh. Under SPMD each rank loads its own copy of the params, and
`rows_data_parallel` takes its rows itself, so neither has a counterpart.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models import bert as kbert
from ..ops.pooling import mean_pool
from .comm import Comm
from .mesh import Mesh


def rows_data_parallel(fn: Callable[..., torch.Tensor], comm: Comm,
                       ids: torch.Tensor, mask: torch.Tensor,
                       *rest: torch.Tensor) -> torch.Tensor:
    """fn over this rank's share of the rows of (ids, mask, *rest), the
    results all-gathered along rows: fn's output for the whole batch on
    every rank. Pad rows (ids 0, mask 1, rest 0) make the rows divide."""
    n = ids.shape[0]
    pad = (-n) % comm.size

    def padded(t, value):
        if not pad:
            return t
        return torch.cat([t, t.new_full((pad, *t.shape[1:]), value)])

    ids, mask = padded(ids, 0), padded(mask, 1)
    rest = [padded(t, 0) for t in rest]
    per = ids.shape[0] // comm.size
    mine = slice(comm.rank * per, (comm.rank + 1) * per)
    out = fn(ids[mine], mask[mine], *(t[mine] for t in rest))
    return comm.all_gather(out, dim=0)[:n]


def encode_data_parallel(params, cfg: kbert.BertConfig, mesh: Mesh,
                         ids: np.ndarray, mask: np.ndarray,
                         token_type: Optional[np.ndarray] = None,
                         normalize: bool = True) -> np.ndarray:
    """Mean-pooled (and L2-normalized) embeddings [n, H] f32 for a batch
    whose rows split over every rank of the mesh, computed on the params'
    device; the same on every rank."""
    comm = Comm()   # the mesh spans the whole group: rows split over every rank
    if token_type is None:
        token_type = np.zeros_like(ids)

    def fwd(i, m, t):
        hidden = kbert.encode_auto(params, cfg, i, m, t)
        pooled = mean_pool(hidden, m)
        if normalize:
            norm = torch.linalg.norm(pooled.float(), dim=-1, keepdim=True)
            pooled = pooled / norm.clamp_min(1e-12).to(pooled.dtype)
        return pooled

    device = params["embeddings"]["word"].device

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(device)

    with torch.inference_mode():
        out = rows_data_parallel(fwd, comm, dev(ids), dev(mask), dev(token_type))
    return out.float().cpu().numpy()
