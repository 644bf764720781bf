"""Process meshes and sharding rules for the port's SPMD parallel paths (port
of kjarni_tpu/parallel/mesh.py).

The JAX package places one array across a device mesh and lets GSPMD insert
the collectives. Here each rank is its own process holding only its shard:
`make_mesh` lays the default process group's ranks out on named axes, a rule
tree says which axes each leaf of a param dict is split over, and
`shard_params_with` returns this rank's slice of every leaf. The models call
the collectives themselves (parallel/comm.py).

A rule is a tuple with one entry per dim of the leaf: an axis name or None,
as a JAX PartitionSpec. A rule whose length differs from the leaf's rank
replicates the leaf, as the JAX package's `_match_structure` does, unless it
holds an Ellipsis: `(..., "tp")` splits the last dim of a leaf of any rank.
A dim that does not divide its axis replicates the whole leaf, as there: a
tiny test vocabulary that does not divide tp leaves the lm head replicated,
and every rank then computes the whole head. `()` replicates.

The Megatron layout (`llama_param_sharding`): q, k, v (and their biases),
gate, up and the lm head column-parallel, o and down row-parallel, the
embedding, norms and rope tables replicated. Quantized weights:
- int8 {"w", "scale" [.., N]}: a column-parallel scale is sliced with its
  columns, a row-parallel one replicated (as in the JAX package).
- int4 {"w4" [.., K/2, N], "scale" [.., G, N]}: column-parallel slices both
  along N; the JAX package replicates this rank-3 scale, which a rank here
  cannot, since it computes only its own columns. Row-parallel cannot take
  the JAX package's slice of w4: packed row j holds input rows j and K/2 + j
  (the half-split packing), so a slice of the packed rows holds two
  non-contiguous runs of input rows, which GSPMD reshards x to match. A rank
  here holds a contiguous slice of x (its heads, its part of the FFN), so
  its w4 is a fresh half-split packing of its own K/n input rows, with their
  own groups scale[r*G/n:(r+1)*G/n]: the same numbers, regrouped. A slice
  that breaks a group raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.errors import InvalidConfigError
from ..models.llama import pack_int4
from ..ops.kernels.int4_matvec import unpack_int4
from .comm import Comm


class Mesh:
    """The default group's ranks laid out row-major over named axes (the JAX
    package's `np.asarray(devices).reshape(...)`): `shape` {axis: size},
    this rank's `coords` {axis: index}, and per axis the `Comm` of the ranks
    that share every other coordinate with this one. Every rank builds the
    same mesh in the same order (new_group is collective)."""

    def __init__(self, axes: dict[str, int]):
        if not (dist.is_available() and dist.is_initialized()):
            raise InvalidConfigError(
                "a mesh needs an initialized torch.distributed process group "
                "(launch with torchrun, or call init_process_group)")
        names, sizes = list(axes), [int(s) for s in axes.values()]
        world, rank = dist.get_world_size(), dist.get_rank()
        if int(np.prod(sizes)) != world:
            raise ValueError(f"{'*'.join(names)} ({'*'.join(map(str, sizes))}) "
                             f"!= world size ({world})")
        self.shape = dict(zip(names, sizes))
        self.axis_names = tuple(names)
        self.coords = {n: int(c) for n, c in zip(names, np.unravel_index(rank, sizes))}
        grid = np.arange(world).reshape(sizes)
        self._comms: dict[str, Comm] = {}
        for i, name in enumerate(names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
                ranks = [int(r) for r in line]
                group = None
                if 1 < sizes[i] < world:
                    group = dist.new_group(ranks)
                if rank in ranks:
                    self._comms[name] = Comm(ranks, group)

    def comm(self, axis: str) -> Comm:
        return self._comms[axis]

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None) -> Mesh:
    """A ("dp", "tp") mesh over the default process group. Left out, every
    rank goes on "tp"; dp * tp must equal the world size (ValueError)."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if dp is None and tp is None:
        dp, tp = 1, n
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp ({dp}*{tp}) != world size ({n})")
    return Mesh({"dp": dp, "tp": tp})


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def llama_param_sharding(mesh: Mesh) -> dict:
    """The Megatron rule tree for models/llama.py's param dict: column-parallel
    q/k/v (with their biases), gate, up and lm head; row-parallel o and down;
    everything else replicated. Works for the int8 and int4 forms (module
    docstring); the lm head's rule fits its plain [K, V] form and its
    quantized dict alike."""
    col = {"w": (None, None, "tp"), "w4": (None, None, "tp"), "scale": (..., "tp"),
           "b": (None, "tp")}
    row = {"w": (None, "tp", None), "w4": (None, "tp", None), "scale": (), "b": ()}
    return {
        "embed": (),
        "layers": {"q": col, "k": col, "v": col, "o": row,
                   "gate": col, "up": col, "down": row,
                   "attn_norm": (), "ffn_norm": ()},
        "final_norm": (),
        "lm_head": (..., "tp"),
        "rope_cos": (),
        "rope_sin": (),
    }


def _axes(rule, ndim: int):
    """The axis name (or None) of each of a leaf's dims under `rule`, or None
    where the rule replicates it."""
    if rule is None or len(rule) == 0:
        return None
    rule = tuple(rule)
    if Ellipsis in rule:
        i = rule.index(Ellipsis)
        head, tail = rule[:i], rule[i + 1:]
        if len(head) + len(tail) > ndim:
            return None
        return [*head, *([None] * (ndim - len(head) - len(tail))), *tail]
    return list(rule) if len(rule) == ndim else None


def _slice(t, rule, mesh: Mesh):
    """This rank's slice of one leaf (an owned contiguous copy), or the leaf
    itself where the rule replicates it or a dim does not divide its axis."""
    if not torch.is_tensor(t):
        return t
    axes = _axes(rule, t.ndim)
    if axes is None:
        return t
    cuts = []
    for dim, ax in enumerate(axes):
        n = mesh.size(ax) if ax is not None else 1
        if n == 1:
            continue
        if t.shape[dim] % n:
            return t
        cuts.append((dim, t.shape[dim] // n, mesh.coords[ax]))
    if not cuts:
        return t
    for dim, size, c in cuts:
        t = t.narrow(dim, c * size, size)
    return t.clone(memory_format=torch.contiguous_format)


def _int4_rows(w4: torch.Tensor, scale: torch.Tensor, r: int, n: int):
    """Rank r of n's row-parallel int4 shard: its contiguous K/n input rows
    packed half-split afresh, with their own group scales (module docstring).
    w4 [.., K/2, N], scale [.., G, N]."""
    K = 2 * w4.shape[-2]
    G = scale.shape[-2]
    Kl = K // n
    if K % n or Kl % 2 or (G > 1 and (G % n or (G // n > 1 and (G // n) % 2))):
        raise InvalidConfigError(
            f"int4 row-parallel shard: K = {K} with {G} scale group(s) does not "
            f"split into {n} slices of whole groups (each an even count)")
    lo, hi = unpack_int4(w4)
    q = torch.cat([lo, hi], dim=-2).narrow(-2, r * Kl, Kl).to(torch.int8)
    s = scale if G == 1 else scale.narrow(-2, r * (G // n), G // n)
    return pack_int4(q).contiguous(), s.clone(memory_format=torch.contiguous_format)


def _shard(p, rule, mesh: Mesh):
    if isinstance(p, dict):
        if not isinstance(rule, dict):
            return {k: _shard(v, rule, mesh) for k, v in p.items()}
        w4_axes = _axes(rule.get("w4"), p["w4"].ndim) if "w4" in p else None
        if w4_axes is not None and w4_axes[-2] is not None and mesh.size(w4_axes[-2]) > 1:
            out = {k: _shard(v, rule.get(k, ()), mesh) for k, v in p.items()
                   if k not in ("w4", "scale")}
            ax = w4_axes[-2]
            out["w4"], out["scale"] = _int4_rows(p["w4"], p["scale"], mesh.coords[ax],
                                                 mesh.size(ax))
            return out
        return {k: _shard(v, rule.get(k, ()), mesh) for k, v in p.items()}
    return _slice(p, rule, mesh)


def shard_params_with(params: dict, rules: dict, mesh: Mesh) -> dict:
    """This rank's shard of any family's param dict under a rule tree: a
    leaf with no rule is replicated, a tuple rule over a dict applies to
    each of its leaves."""
    return _shard(params, rules, mesh)


def _gather(t, rule, mesh: Mesh):
    if not torch.is_tensor(t) or not t.is_floating_point():
        return t
    axes = _axes(rule, t.ndim)
    if axes is None:
        return t
    cut = [(dim, ax) for dim, ax in enumerate(axes)
           if ax is not None and mesh.size(ax) > 1]
    if any(t.shape[dim] % mesh.size(ax) for dim, ax in cut):
        # a replicated leaf (_slice's fallback) is the same on every rank; a
        # shard of a width that does not divide its axis again is not
        parts = [p for _, ax in cut for p in mesh.comm(ax).all_gather(t[None], 0).unbind(0)]
        if all(torch.equal(p, t) for p in parts):
            return t
    for dim, ax in cut:
        t = mesh.comm(ax).all_gather(t, dim)
    return t


def gather_params(params: dict, rules: dict, mesh: Mesh) -> dict:
    """The whole param dict from every rank's shard: the inverse of
    `shard_params_with` for float leaves (integer ones come back as this
    rank's shard). Collective: every rank calls it and gets the same dict.
    A leaf whose shard width does not divide its axis again is taken for
    replicated (the sharding fallback) when every rank holds the same
    tensor."""
    def go(p, rule):
        if isinstance(p, dict):
            return {k: go(v, rule.get(k, ()) if isinstance(rule, dict) else rule)
                    for k, v in p.items()}
        return _gather(p, rule, mesh)
    return go(params, rules)


def shard_llama_params(params: dict, mesh: Mesh) -> dict:
    """This rank's tensor-parallel shard of a llama param dict (the forward
    functions take the tp group as `tp=mesh.comm("tp")`)."""
    return shard_params_with(params, llama_param_sharding(mesh), mesh)


def shard_cache(cache, mesh: Mesh):
    """This rank's part of a KV cache: batch on "dp", KV heads on "tp", per
    leaf, replicated where a dim does not divide. Takes plain [L, B, Hkv, T,
    D] tensors, int8 caches {"q": [L, B, Hkv, T, D], "s": [L, B, Hkv, T]}
    and (k, v) tuples of either."""
    if isinstance(cache, tuple):
        return tuple(shard_cache(c, mesh) for c in cache)
    if isinstance(cache, dict):
        return {k: shard_cache(v, mesh) for k, v in cache.items()}
    if cache.ndim < 4:
        return cache
    # one axis at a time, so a dim that does not divide replicates only itself
    for dim, ax in ((1, "dp"), (2, "tp")):
        cache = _slice(cache, (*([None] * dim), ax, ...), mesh)
    return cache


def encoder_param_sharding(mesh: Mesh) -> dict:
    """The rule tree for the BERT encoder (models/bert.py): tp over heads and
    the FFN."""
    col = {"w": (None, None, "tp"), "b": (None, "tp")}
    row = {"w": (None, "tp", None), "b": (None, None)}
    norm = {"weight": (), "bias": ()}
    return {
        "embeddings": {"word": (), "position": (), "token_type": (), "norm": norm},
        "layers": {"q": col, "k": col, "v": col, "o": row, "attn_norm": norm,
                   "fc1": col, "fc2": row, "ffn_norm": norm},
        "pooler": {"w": (), "b": ()},
        "rel_bias": (),
    }


def t5_param_sharding(mesh: Mesh) -> dict:
    """The rule tree for models/t5.py: Megatron tp on both stacks;
    cross-attention shards like self-attention."""
    col, row = (None, None, "tp"), (None, "tp", None)
    stack = {"q": col, "k": col, "v": col, "o": row,
             "cross_q": col, "cross_k": col, "cross_v": col, "cross_o": row,
             "wi": col, "wi0": col, "wi1": col, "wo": row,
             "attn_norm": (), "ffn_norm": (), "self_norm": (), "cross_norm": ()}
    return {"shared": (), "enc": stack, "dec": stack, "enc_rel_bias": (),
            "dec_rel_bias": (), "enc_final_norm": (), "dec_final_norm": (),
            "lm_head": (None, "tp")}


def _encdec_stack_sharding() -> dict:
    """The layout BART's and Whisper's stacks share ({"w", "b"} linears)."""
    col = {"w": (None, None, "tp"), "b": (None, "tp")}
    row = {"w": (None, "tp", None), "b": (None, None)}
    norm = {"weight": (), "bias": ()}
    return {"q": col, "k": col, "v": col, "o": row,
            "cross_q": col, "cross_k": col, "cross_v": col, "cross_o": row,
            "fc1": col, "fc2": row,
            "attn_norm": norm, "ffn_norm": norm, "self_norm": norm, "cross_norm": norm}


def bart_param_sharding(mesh: Mesh) -> dict:
    """The rule tree for models/bart.py."""
    stack = _encdec_stack_sharding()
    return {"shared": (), "enc_pos": (), "dec_pos": (),
            "enc_emb_norm": (), "dec_emb_norm": (), "enc": stack, "dec": stack,
            "lm_head": (None, "tp"), "final_logits_bias": ("tp",)}


def whisper_param_sharding(mesh: Mesh) -> dict:
    """The rule tree for models/whisper.py."""
    stack = _encdec_stack_sharding()
    return {"conv1_w": (), "conv1_b": (), "conv2_w": (), "conv2_b": (),
            "enc_pos": (), "dec_pos": (), "embed": (), "enc": stack, "dec": stack,
            "enc_final_norm": (), "dec_final_norm": (), "lm_head": (None, "tp")}
