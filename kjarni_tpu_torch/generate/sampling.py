"""Sampling: greedy / top-k / top-p / min-p, penalties, n-gram blocking
(port of kjarni_tpu/generate/sampling.py).

The whole chain runs on the logits' device over a FIXED-capacity token
buffer, as in the JAX package. Draws come from a `torch.Generator` seeded from
`GenerationConfig.seed`; they cannot equal `jax.random`'s, so the tests hold
the filter masks and greedy choices against the JAX package, not the draws.

Semantics notes (matched to the reference): the repetition penalty applies
once per *occurrence*, compounding for repeated tokens (penalty**count).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Cf. common/mod.rs:19 (defaults match)."""

    temperature: float = 0.7
    top_k: Optional[int] = 50
    top_p: Optional[float] = 0.9
    min_p: Optional[float] = 0.1


@dataclasses.dataclass(frozen=True)
class BeamSearchParams:
    """Cf. common/mod.rs:39."""

    num_beams: int = 4
    length_penalty: float = 1.0
    early_stopping: bool = True


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Cf. common/mod.rs:68 GenerationConfig (defaults match)."""

    max_new_tokens: Optional[int] = 50
    max_length: int = 100
    min_length: int = 0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    add_bos_token: bool = True
    strategy: str = "sample"  # "greedy" | "sample" | "beam"
    sampling: SamplingParams = SamplingParams()
    beam: BeamSearchParams = BeamSearchParams()
    seed: Optional[int] = None

    @staticmethod
    def greedy(**kw) -> "GenerationConfig":
        return GenerationConfig(strategy="greedy", **kw)


def _scatter_add(dst: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """dst.at[r, index].add(src, mode="drop") per row of dst [B, V]:
    out-of-range indices are dropped."""
    V = dst.shape[-1]
    ok = (index >= 0) & (index < V)
    return dst.scatter_add(-1, index.clamp(0, V - 1),
                           torch.where(ok, src, torch.zeros_like(src)))


def _lengths(length, rows: int, device) -> torch.Tensor:
    """`length` (an int, or a tensor of one per row) as a [B, 1] tensor."""
    return torch.as_tensor(length, device=device).reshape(-1, 1).expand(rows, 1)


def apply_repetition_penalty(logits: torch.Tensor, tokens: torch.Tensor,
                             valid: torch.Tensor, penalty) -> torch.Tensor:
    """logits [V]; tokens [T] history buffer; valid [T] 0/1 mask; or the
    same with a leading batch axis, row by row. `penalty` is one float, or a
    [B] tensor of one per row (the continuous engine's slots).

    Per-occurrence compounding, sign-dependent divide/multiply (sampling.rs:8).
    """
    lg = logits.reshape(-1, logits.shape[-1])
    counts = _scatter_add(torch.zeros(lg.shape, dtype=torch.float32, device=lg.device),
                          tokens.long().reshape(lg.shape[0], -1),
                          valid.float().reshape(lg.shape[0], -1))
    factor = torch.pow(torch.as_tensor(penalty, dtype=torch.float32,
                                       device=logits.device).reshape(-1, 1), counts)
    return torch.where(lg < 0, lg * factor, lg / factor).reshape(logits.shape)


def apply_no_repeat_ngram(logits: torch.Tensor, tokens: torch.Tensor,
                          length, ngram_size: int) -> torch.Tensor:
    """Ban tokens that would complete a repeated n-gram (sampling.rs:32).

    tokens: [T] fixed buffer holding `length` tokens, or [B, T] with one
    length per row. The current prefix is the last n-1 valid tokens; every
    historical window matching that prefix bans its completing token.
    """
    n = ngram_size
    T = tokens.shape[-1]
    if n <= 1 or T < n:
        return logits
    dev = tokens.device
    lg = logits.reshape(-1, logits.shape[-1])
    tokens = tokens.long().reshape(lg.shape[0], T)
    length = _lengths(length, lg.shape[0], dev)
    prefix_idx = length - (n - 1) + torch.arange(n - 1, device=dev)
    prefix = tokens.gather(1, prefix_idx.clamp(0, T - 1))
    starts = torch.arange(T - n + 1, device=dev)
    windows = tokens[:, starts[:, None] + torch.arange(n - 1, device=dev)[None, :]]
    match = (windows == prefix[:, None, :]).all(dim=-1)
    valid = (starts + n <= length) & (length >= n - 1)
    banned = tokens[:, starts + n - 1]
    delta = _scatter_add(torch.zeros_like(lg), banned,
                         torch.where(match & valid, NEG_INF, 0.0).to(lg.dtype))
    return (lg + delta).reshape(logits.shape)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the top-k logits of each row (ties at the cutoff kept), NEG_INF
    the rest."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    cutoff = torch.topk(logits, k).values[..., -1:]
    return torch.where(logits >= cutoff, logits, NEG_INF)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering (sampling.rs:154): keep the smallest prefix of the
    sorted distribution whose mass before each kept token is <= p (the token
    that crosses p is kept)."""
    sorted_logits = torch.sort(logits, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) <= p
    cutoff = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits >= cutoff, logits, NEG_INF)


def min_p_filter(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """Drop tokens with prob < min_p * max_prob (sampling.rs:131)."""
    probs = torch.softmax(logits, dim=-1)
    cutoff = probs.amax(dim=-1, keepdim=True) * min_p
    return torch.where(probs >= cutoff, logits, NEG_INF)


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 params: SamplingParams, greedy: bool) -> torch.Tensor:
    """Full sampling chain (sampling.rs:81). logits [V] -> 0-d int64 tensor,
    or [B, V] -> [B], one draw per row from the one generator (the JAX
    package vmaps the [V] form). Greedy takes the first maximum of each row,
    as the JAX package's fast_argmax does."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    if params.top_k is not None:
        logits = top_k_filter(logits, params.top_k)
    if params.top_p is not None:
        logits = top_p_filter(logits, params.top_p)
    if params.min_p is not None:
        logits = min_p_filter(logits, params.min_p)
    temp = 1.0 if params.temperature < 1e-5 else params.temperature
    probs = torch.softmax(logits / temp, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def process_logits(logits: torch.Tensor, tokens: torch.Tensor, length,
                   cfg_penalty: float, ngram_size: int) -> torch.Tensor:
    """Penalty + ngram chain applied before sampling, in f32
    (generator.rs:330-376). logits [V] with tokens [T] holding `length`
    tokens, or logits [B, V] with tokens [B, T] and a length per row (the
    JAX package vmaps the [V] form)."""
    logits = logits.float()
    if cfg_penalty != 1.0:
        rows = logits.reshape(-1, logits.shape[-1]).shape[0]
        valid = (torch.arange(tokens.shape[-1], device=tokens.device)
                 < _lengths(length, rows, tokens.device)).reshape(tokens.shape)
        logits = apply_repetition_penalty(logits, tokens, valid, cfg_penalty)
    if ngram_size > 0:
        logits = apply_no_repeat_ngram(logits, tokens, length, ngram_size)
    return logits
