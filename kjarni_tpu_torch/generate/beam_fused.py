"""Beam search on the device: the whole loop over device tensors (port of
kjarni_tpu/generate/beam_fused.py).

The JAX package runs decode, log-softmax, constraint masking, top-2k,
finished-hypothesis tracking and the beam reorder as one `lax.while_loop`.
Here the loop is a Python loop over device tensors with the same body; the
host reads one flag per step (stop or go on) and the tokens once at the end.
Every tie-break of the JAX program is kept:

- `lax.top_k` takes the lower index among equal values; `torch.topk` makes
  no such promise on CUDA, so the 2k candidates come from a stable
  descending sort of the k * V scores.
- `jnp.argsort` is stable; here `torch.argsort(stable=True)`.
- `torch.argmin`/`argmax` return the first index, as `jnp`'s do.

Semantics equal the host loop (generate/beam.py): the same candidate order,
length-penalty normalization, forced BOS/EOS, min-length and early stopping.
"""

from __future__ import annotations

from typing import Callable

import torch

from .beam import BeamSearchConfig
from .sampling import apply_no_repeat_ngram

NEG = -1e9


def build_fused_beam(decode_fn: Callable, cfg: BeamSearchConfig,
                     vocab_size: int, max_len_cap: int):
    """Build the beam loop.

    decode_fn(tokens [k, 1], sk, sv, pos, parents) -> (logits [k, V], sk, sv)
    must reorder its self-cache by `parents` before decoding (identity at
    step 0). Returns run(sk, sv) -> (best_tokens [max_len], best_len).
    """
    k = cfg.num_beams
    V = vocab_size
    L = min(cfg.max_length, max_len_cap)
    lp_pow = cfg.length_penalty

    def norm_score(raw, length):
        Lf = torch.clamp(torch.as_tensor(length, device=raw.device), min=1).float()
        return raw / torch.pow(Lf, lp_pow)

    def run(sk, sv):
        dev = sk.device
        beam_toks = torch.full((k, L + 1), cfg.decoder_start_token_id,
                               dtype=torch.long, device=dev)
        scores = torch.full((k,), NEG, dtype=torch.float32, device=dev)
        scores[0] = 0.0
        parents = torch.arange(k, device=dev)
        fin_toks = torch.zeros((k, L + 1), dtype=torch.long, device=dev)
        fin_lens = torch.zeros(k, dtype=torch.long, device=dev)
        fin_norm = torch.full((k,), float("-inf"), dtype=torch.float32, device=dev)
        fin_count = torch.zeros((), dtype=torch.long, device=dev)
        slots = torch.arange(k, device=dev)
        vocab = torch.arange(V, device=dev)

        step = 0
        while step < L:
            cur = beam_toks[:, step:step + 1]
            logits, sk, sv = decode_fn(cur, sk, sv, step, parents)
            lp = torch.log_softmax(logits.float(), dim=-1)

            gen_len = step + 1
            # min-length: suppress EOS until allowed (host: gen_len < min+1)
            if gen_len < cfg.min_length + 1:
                lp = torch.where(vocab[None, :] == cfg.eos_token_id, NEG, lp)
            if cfg.forced_bos_token_id is not None and step == 0:
                lp = torch.where(vocab[None, :] == cfg.forced_bos_token_id, lp, NEG)
            if cfg.forced_eos_token_id is not None and step == L - 1:
                lp = torch.where(vocab[None, :] == cfg.forced_eos_token_id, lp, NEG)
            if cfg.no_repeat_ngram_size > 0:
                # history excludes the start token (host: tokens[1:])
                lp = apply_no_repeat_ngram(lp, beam_toks[:, 1:], step,
                                           cfg.no_repeat_ngram_size)

            cand = scores[:, None] + lp
            vals, idx = torch.sort(cand.reshape(-1), descending=True, stable=True)
            vals, idx = vals[:2 * k], idx[:2 * k]
            cand_b = idx // V
            cand_t = idx % V
            is_eos = cand_t == cfg.eos_token_id
            # host ordering: candidate j is processed while fewer than k
            # non-eos have been taken so far
            alive = (~is_eos).long()
            non_eos_before = torch.cumsum(alive, 0) - alive
            processed = non_eos_before < k

            # --- finished pool update (insert eos candidates, keep k best) ---
            take = processed & is_eos
            ns = norm_score(vals, step)
            for j in range(2 * k):
                worst = torch.argmin(fin_norm)
                do = take[j] & (ns[j] > fin_norm[worst])
                sel = (slots == worst) & do
                fin_toks = torch.where(sel[:, None], beam_toks[cand_b[j]][None, :],
                                       fin_toks)
                fin_lens = torch.where(sel, step, fin_lens)
                fin_norm = torch.where(sel, ns[j], fin_norm)
            fin_count = fin_count + take.long().sum()

            # --- pick the first k non-eos candidates as the new beams ---
            alive_rank = torch.where(~is_eos & processed, non_eos_before, 2 * k)
            order = torch.argsort(alive_rank, stable=True)[:k]
            ok = alive_rank[order] < 2 * k
            parents = torch.where(ok, cand_b[order], 0)
            new_tokens = torch.where(ok, cand_t[order], cfg.eos_token_id)
            scores = torch.where(ok, vals[order], NEG)

            beam_toks = beam_toks[parents]
            beam_toks[:, step + 1] = new_tokens

            stop = ~ok.any()
            if cfg.early_stopping:
                stop = stop | (fin_count >= k)
            else:
                kth_best = torch.sort(fin_norm).values[0]  # worst of the kept k
                best_alive = scores.max()
                if lp_pow:
                    best_alive = best_alive / torch.pow(
                        torch.tensor(float(step + 2), device=dev), lp_pow)
                stop = stop | ((fin_count >= k) & (best_alive < kth_best))
            step += 1
            if bool(stop):       # the one host sync of a step
                break

        # fallback: no finished hypothesis -> best alive beam (host behavior)
        if int(fin_count) == 0:
            best_row, best_len = beam_toks[torch.argmax(scores)], step
        else:
            best_fin = torch.argmax(fin_norm)
            best_row, best_len = fin_toks[best_fin], int(fin_lens[best_fin])
        # strip the start token: emitted tokens live at positions 1..best_len
        return torch.roll(best_row, -1)[:L], best_len

    return run
