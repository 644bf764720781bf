"""The comparison that decides `correct`.

After the window has closed and the program's state is freed, two samples of
the requests the window finished, drawn from the seed and each always holding
the longest and the shortest, one of greedy and one of sampled requests, run
through the plain reference (`reference/decoder.py`, the forward of the
configuration's architecture module, `kbench/arch/`) over each prompt with its
served tokens. Two numbers are compared, each against the cell's limit:

- `max_logit_gap`, of greedy tokens: how far the reference's logit of the
  served token lies below the reference's best logit at that position. A sound
  greedy program picks the reference's best, or a token within rounding of it;
  a wrong one picks tokens the reference ranks lower.
- `nucleus_excess`, of sampled tokens: the sum, over the sample, of how far
  each served token's reference logit lies below the reference's nucleus, the
  smallest logit that top-p keeps (0 for a token inside it). The nucleus is
  taken as the program's sampler defines it (the order of the original's
  `sampling.rs`: top-k, top-p and min-p on the raw logits, then the
  temperature), so a sound sampler serves tokens inside it to within rounding,
  and the sum stays near 0; one that skips top-p serves some tenth of its
  tokens below it, and one that draws from another slot's row most. A sum and
  not the widest: a sampler that skips top-p puts only a few tokens a little
  below the cut, as rounding can put one. The temperature does not move the
  nucleus, so this number cannot see a wrong temperature.

The control (`control=True`) puts the reference itself, one precision down
(`precision="fp8"`), in the program's place: at the same positions of the same
prompts and served greedy tokens, it reads the gap of the token the control
ranks first, and its verdict under the cell's limit is returned. It also reads
two faults of a sampler from the reference's own rows: tokens drawn from the
whole tempered distribution (top-p skipped) and the served tokens scored
against the next sampled request's rows (another slot's row).

A request that never finished, or that returned another number of tokens than
it asked for (no stop token is live), fails the run as well.
"""

from __future__ import annotations

import random
from pathlib import Path

from . import lookup
from .reference.decoder import logits_at


def pick(served: list, seed: int, min_tokens: int, max_requests: int,
         greedy: bool = True) -> list:
    """A sample of the finished greedy (or sampled) requests: the longest and
    the shortest (prompt and output; the two ends of the prompt buckets, so of
    the admission plans), then others in an order drawn from the seed, until
    the sample holds min_tokens served tokens or max_requests requests."""
    done = [s for s in served
            if s.request.greedy == greedy and s.done_s is not None and s.tokens]
    if not done:
        return []
    done.sort(key=lambda s: (len(s.request.token_ids) + len(s.tokens), s.request.index))
    out = [done[-1]] + ([done[0]] if len(done) > 1 else [])
    rest = done[1:-1]
    random.Random(f"sample:{seed}:{greedy}").shuffle(rest)
    n = sum(len(s.tokens) for s in out)
    for s in rest:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(s)
        n += len(s.tokens)
    return out


def teacher_forced(sample: list) -> tuple[list, list]:
    """Each sampled request's sequence (prompt and every served token but
    the last) and the rows whose logits predict its served tokens."""
    seqs, rows = [], []
    for s in sample:
        p = len(s.request.token_ids)
        seqs.append(list(s.request.token_ids) + list(s.tokens[:-1]))
        rows.append(list(range(p - 1, p - 1 + len(s.tokens))))
    return seqs, rows


def _gap(ref, chosen) -> float:
    """The widest gap of chosen tokens below the reference's best: ref
    [n, V] f32 logits, chosen [n] token ids."""
    import torch
    chosen = torch.as_tensor(chosen, device=ref.device)
    best = ref.max(dim=-1).values
    return float((best - ref.gather(1, chosen[:, None])[:, 0]).max())


def nucleus_cut(ref, top_p: float):
    """[n] the smallest logit that top-p keeps in each row of ref [n, V]:
    of the logits sorted high to low, each one whose softmax mass before it is
    at most top_p (the token that crosses top_p is kept)."""
    import torch
    srt = torch.sort(ref, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    return torch.where(before <= top_p, srt, torch.full_like(srt, float("inf"))).amin(dim=-1)


def _excess(ref, chosen, top_p: float) -> float:
    """The sum of how far chosen tokens lie below the reference's nucleus."""
    import torch
    chosen = torch.as_tensor(chosen, device=ref.device)
    n = min(len(chosen), ref.shape[0])
    ref, chosen = ref[:n], chosen[:n]
    below = nucleus_cut(ref, top_p) - ref.gather(1, chosen[:, None])[:, 0]
    return float(below.clamp_min(0).sum())


def _sampler_faults(refs: list, sample: list, seed: int) -> dict:
    """Readings of `nucleus_excess` for two faults of a sampler, made from
    the reference's rows: top-p skipped (tokens drawn from the whole tempered
    distribution) and another slot's row (each request's served tokens
    against the next request's rows)."""
    import torch
    gen = torch.Generator(device=refs[0].device).manual_seed(seed % 2 ** 63)
    no_top_p, wrong_row = [], []
    for j, (r, s) in enumerate(zip(refs, sample)):
        sp = s.request.sampling
        probs = torch.softmax(r / max(sp["temperature"], 1e-5), dim=-1)
        drawn = torch.multinomial(probs, 1, generator=gen)[:, 0]
        no_top_p.append(_excess(r, drawn, sp["top_p"]))
        if len(sample) > 1:
            other = refs[(j + 1) % len(sample)]
            wrong_row.append(_excess(other, s.tokens, sp["top_p"]))
    out = {"no_top_p": sum(no_top_p)}
    if wrong_row:
        out["wrong_row"] = sum(wrong_row)
    return out


def gaps(hf: dict, seed: int, greedy: list, sampled: list, device, quant,
         control: bool = False, kroot: Path = lookup.KROOT) -> dict:
    """The readings: "max_logit_gap" and "tokens" of the greedy sample,
    "nucleus_excess" and "sampled_tokens" of the sampled one; with control,
    "control_gap" (the fp8 control's widest gap) and "sampler_faults"."""
    out = {"max_logit_gap": None, "tokens": 0, "nucleus_excess": None, "sampled_tokens": 0}
    both = greedy + sampled
    if not both:
        return out
    seqs, rows = teacher_forced(both)
    ref = logits_at(hf, seed, seqs, rows, device, quant=quant, kroot=kroot)
    rg, rs = ref[:len(greedy)], ref[len(greedy):]
    if greedy:
        out["max_logit_gap"] = max(_gap(r, s.tokens) for r, s in zip(rg, greedy))
        out["tokens"] = sum(len(s.tokens) for s in greedy)
    if sampled:
        out["nucleus_excess"] = sum(_excess(r, s.tokens, s.request.sampling["top_p"])
                                    for r, s in zip(rs, sampled))
        out["sampled_tokens"] = sum(len(s.tokens) for s in sampled)
    if control and greedy:
        low = logits_at(hf, seed, seqs[:len(greedy)], rows[:len(greedy)], device,
                        quant=quant, precision="fp8", kroot=kroot)
        out["control_gap"] = max(_gap(r, c.argmax(dim=-1)) for r, c in zip(rg, low))
    if control and sampled:
        out["sampler_faults"] = _sampler_faults(rs, sampled, seed)
    return out


def judge(window, hf: dict, seed: int, limits: dict, device, quant,
          control: bool = False, kroot: Path = lookup.KROOT) -> tuple[bool, dict, dict]:
    """(correct, checks {name: {"value", "limit"}}, the readings). With
    control, the readings also hold "control_correct": the control's verdict
    under the cell's limit, and "faults_correct": each sampler fault's."""
    unfinished = sum(1 for s in window.served if s.done_s is None)
    wrong_len = sum(1 for s in window.served
                    if s.done_s is not None and len(s.tokens) != s.request.max_new_tokens)
    n_tok, n_req = limits["sample_tokens"], limits["sample_requests"]
    greedy = pick(window.served, seed, n_tok, n_req)
    nucleus = "max_nucleus_excess" in limits
    sampled = pick(window.served, seed, n_tok, n_req, greedy=False) if nucleus else []
    read = gaps(hf, seed, greedy, sampled, device, quant, control, kroot)
    gap = read["max_logit_gap"]
    checks = {"max_logit_gap": {"value": gap, "limit": limits["max_logit_gap"]}}
    ok = gap is not None and gap <= limits["max_logit_gap"]
    if nucleus:
        ng = read["nucleus_excess"]
        checks["nucleus_excess"] = {"value": ng, "limit": limits["max_nucleus_excess"]}
        checks["sampled_tokens_scored"] = {"value": read["sampled_tokens"],
                                           "at_least": limits["min_scored"]}
        ok = ok and ng is not None and ng <= limits["max_nucleus_excess"] and \
            read["sampled_tokens"] >= limits["min_scored"]
    checks.update({"unfinished": {"value": unfinished, "limit": 0},
                   "wrong_length": {"value": wrong_len, "limit": 0},
                   "tokens_scored": {"value": read["tokens"], "at_least": limits["min_scored"]}})
    ok = ok and unfinished == 0 and wrong_len == 0 and read["tokens"] >= limits["min_scored"]
    if "control_gap" in read:
        read["control_correct"] = read["control_gap"] <= limits["max_logit_gap"]
    if "sampler_faults" in read:
        read["faults_correct"] = {k: v <= limits["max_nucleus_excess"]
                                  for k, v in read["sampler_faults"].items()}
    return ok, checks, read
