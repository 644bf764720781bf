"""Beam search for seq2seq generation, on the host (a copy of
kjarni_tpu/generate/beam.py, which is numpy and imports no JAX).

Cf. kjarni-transformers/src/encoder_decoder/beams.rs: BeamHypothesis with
length-penalty-normalized scores (:18,24), beam_step (:236), run_beam_search
(:362) and the streaming variant (:424). All num_beams decode in one batched
step; the backend reorders its self-cache by the beam parents first. Host code
only does the top-2k bookkeeping on a [k, V] logprob matrix per step. It
drives the streaming path and is the reference for the device loop
(generate/beam_fused.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .sampling import BeamSearchParams


@dataclasses.dataclass
class BeamHypothesis:
    """Cf. beams.rs:18 — normalized_score = score / len^length_penalty."""

    tokens: list[int]
    score: float
    length_penalty: float = 1.0

    @property
    def normalized_score(self) -> float:
        L = max(len(self.tokens), 1)
        return self.score / (L ** self.length_penalty)


@dataclasses.dataclass
class BeamSearchConfig:
    num_beams: int = 4
    max_length: int = 128
    min_length: int = 0
    length_penalty: float = 1.0
    early_stopping: bool = True
    no_repeat_ngram_size: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    forced_bos_token_id: Optional[int] = None
    forced_eos_token_id: Optional[int] = None

    @staticmethod
    def from_params(p: BeamSearchParams, **kw) -> "BeamSearchConfig":
        return BeamSearchConfig(num_beams=p.num_beams,
                                length_penalty=p.length_penalty,
                                early_stopping=p.early_stopping, **kw)


def _ban_repeated_ngrams(logprobs: np.ndarray, tokens: list[int], n: int) -> None:
    """Host-side no-repeat-ngram for one beam (cf. sampling.rs:32)."""
    if n <= 0 or len(tokens) < n - 1:
        return
    prefix = tuple(tokens[-(n - 1):]) if n > 1 else ()
    for i in range(len(tokens) - n + 1):
        if tuple(tokens[i:i + n - 1]) == prefix:
            logprobs[tokens[i + n - 1]] = -np.inf


def beam_search(step_fn: Callable, cfg: BeamSearchConfig,
                stream_callback: Optional[Callable[[int], None]] = None
                ) -> BeamHypothesis:
    """Run beam search.

    step_fn(tokens [k] int32, pos int, beam_parents [k] int32) -> logits
    [k, V] float32 — the backend decodes one token per beam, reordering its
    cache by beam_parents first (identity on step 0).

    Returns the best finished hypothesis (cf. run_beam_search beams.rs:362).
    """
    k = cfg.num_beams
    beam_tokens: list[list[int]] = [[cfg.decoder_start_token_id] for _ in range(k)]
    beam_scores = np.zeros(k, dtype=np.float64)
    beam_scores[1:] = -1e9  # only beam 0 is live on the first step
    parents = np.arange(k, dtype=np.int32)
    finished: list[BeamHypothesis] = []

    for step in range(cfg.max_length):
        cur = np.asarray([bt[-1] for bt in beam_tokens], dtype=np.int32)
        logits = np.asarray(step_fn(cur, step, parents), dtype=np.float32)
        # log softmax
        m = logits.max(axis=-1, keepdims=True)
        lp = logits - m
        lp = lp - np.log(np.exp(lp).sum(axis=-1, keepdims=True))

        gen_len = step + 1
        for b in range(k):
            if gen_len < cfg.min_length + 1:
                lp[b, cfg.eos_token_id] = -np.inf
            if cfg.forced_bos_token_id is not None and step == 0:
                keep = lp[b, cfg.forced_bos_token_id]
                lp[b, :] = -np.inf
                lp[b, cfg.forced_bos_token_id] = keep
            # force EOS as the final token when max_length is reached (HF/BART
            # forced_eos_token_id semantics)
            if cfg.forced_eos_token_id is not None and step == cfg.max_length - 1:
                keep = lp[b, cfg.forced_eos_token_id]
                lp[b, :] = -np.inf
                lp[b, cfg.forced_eos_token_id] = keep
            _ban_repeated_ngrams(lp[b], beam_tokens[b][1:],
                                 cfg.no_repeat_ngram_size)

        cand = beam_scores[:, None] + lp  # [k, V]
        V = cand.shape[1]
        flat = cand.reshape(-1)
        top = np.argpartition(-flat, min(2 * k, flat.size - 1))[:2 * k]
        top = top[np.argsort(-flat[top])]

        new_tokens: list[list[int]] = []
        new_scores: list[float] = []
        new_parents: list[int] = []
        for idx in top:
            b, tok = divmod(int(idx), V)
            score = float(flat[idx])
            if tok == cfg.eos_token_id:
                finished.append(BeamHypothesis(
                    tokens=beam_tokens[b][1:], score=score,
                    length_penalty=cfg.length_penalty))
                continue
            new_tokens.append(beam_tokens[b] + [tok])
            new_scores.append(score)
            new_parents.append(b)
            if len(new_tokens) == k:
                break

        if not new_tokens:
            break
        beam_tokens = new_tokens
        beam_scores = np.asarray(new_scores)
        parents = np.asarray(new_parents, dtype=np.int32)

        if stream_callback is not None:
            stream_callback(beam_tokens[0][-1])

        if cfg.early_stopping and len(finished) >= k:
            break
        if not cfg.early_stopping and finished:
            # no hope: best alive can't beat worst kept finished
            best_alive = beam_scores.max() / (
                (step + 2) ** cfg.length_penalty if cfg.length_penalty else 1.0)
            worst_kept = sorted(
                (h.normalized_score for h in finished), reverse=True)[:k][-1]
            if len(finished) >= k and best_alive < worst_kept:
                break

    if not finished:
        # fall back to best alive beam
        b = int(np.argmax(beam_scores))
        finished.append(BeamHypothesis(tokens=beam_tokens[b][1:],
                                       score=float(beam_scores[b]),
                                       length_penalty=cfg.length_penalty))
    finished.sort(key=lambda h: -h.normalized_score)
    return finished[0]
