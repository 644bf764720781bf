"""Token-level continuous batching: a slot-based decode engine (port of
kjarni_tpu/generate/continuous.py).

Requests join and leave a running decode mid-flight, for both decoder
families (llama / qwen2 / mistral / phi3 and gpt2). The layout:

  * a fixed number of slots S, each one row of one KV cache
    [L, S, Hkv, T, D] (int8 {"q", "s"} dicts under kv_cache="int8");
  * one batched forward per decode step for ALL slots, each at its own
    position: the model's per-row decode (pos_start a [S] tensor), the
    counterpart of the JAX engine's vmap of the B = 1 forward over the slot
    axis. Inactive slots compute in lockstep at a position inside their own
    row (0, 1, ...), so they never write another slot's row;
  * all per-slot decode state on the device: last token, temperature,
    top-k / top-p / min-p, repetition penalty, the n-gram flag, a
    128-token history ring, and one torch.Generator per slot seeded from
    the request's seed (default: its id).

A window of k decode steps is a host loop of k forwards whose only device
-> host sync is the packed [S, k + 1] token block read back once at its end
(column 0 is the window's entry token, which reports the token sampled at
admission). Admission prefills every joining request of one prompt bucket
in one batched forward (lanes), broadcasting a registered prefix's KV into
[0:m] and prefilling the right-padded suffixes at pos_start = m, under the
same memory plan as the JAX engine (plain / flash / chunked).

While a torch profiler runs, the engine records its spans
(core/profiling.py): kjarni.engine.step, .admit_wave and .decode (with the
card's time), .readback and .deliver, and for each request submitted while
recording a kjarni.engine.first_token record, from its submit to the
readback that delivers its first token.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..core import profiling
from ..core.bucketing import seq_bucket
from ..core.errors import GenerationError
from ..core.kvcache import slice_working
from .sampling import (NEG_INF, SamplingParams, apply_no_repeat_ngram,
                       apply_repetition_penalty, min_p_filter, top_p_filter)

_HIST_BUF = 128   # per-slot generated-token history window for penalties


def _filter_slots(logits: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                  min_p: torch.Tensor) -> torch.Tensor:
    """Each row of logits [N, V] filtered by its own parameters ([N]
    tensors), NEG_INF where dropped: the dynamic top-k keeps logits >= the
    k-th largest (k <= 0 is off), then top-p (1.0 keeps all) and min-p (0.0
    keeps all), as the JAX engine's _sample_slot."""
    V = logits.shape[-1]
    tk = top_k[:, None]
    kth = torch.sort(logits, dim=-1, descending=True).values.gather(
        1, (tk - 1).clamp(0, V - 1))
    lg = torch.where((tk > 0) & (logits < kth), NEG_INF, logits)
    lg = top_p_filter(lg, top_p[:, None])
    return min_p_filter(lg, min_p[:, None])


def _sample_slot(logits: torch.Tensor, generators: list, rows: list,
                 temp: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                 min_p: torch.Tensor) -> torch.Tensor:
    """One token per row of logits [N, V] (f32, penalties applied), each row
    with its own parameters ([N] tensors; temp <= 0 means greedy). `rows`
    (host ints) are the rows that sample: each draws from generators[row]
    over its _filter_slots set at its temperature. The other rows take the
    first maximum."""
    tok = torch.argmax(logits, dim=-1)
    if not rows:
        return tok
    idx = torch.tensor(rows, device=logits.device)
    lg = _filter_slots(logits[idx], top_k[idx], top_p[idx], min_p[idx])
    probs = torch.softmax(lg / temp[idx][:, None].clamp_min(1e-5), dim=-1)
    draws = [torch.multinomial(probs[j], 1, generator=generators[r])
             for j, r in enumerate(rows)]
    tok[idx] = torch.cat(draws)
    return tok


def _hist_append(h: torch.Tensor, hl: torch.Tensor, tok: torch.Tensor):
    """Append one token per row to the rolling [N, _HIST_BUF] history rings
    h holding hl [N] tokens each; a full ring drops its oldest token."""
    h_app = h.scatter(1, hl.clamp(0, _HIST_BUF - 1)[:, None], tok[:, None])
    h_roll = torch.roll(h, -1, dims=1)
    h_roll[:, -1] = tok
    h = torch.where((hl >= _HIST_BUF)[:, None], h_roll, h_app)
    return h, torch.clamp(hl + 1, max=_HIST_BUF)


@dataclasses.dataclass
class _Slot:
    request_id: int = -1
    active: bool = False
    pos: int = 0                 # cache write frontier (== tokens in cache)
    remaining: int = 0           # max_new_tokens budget left
    pending_first: bool = False  # admission token not yet reported to host
    plain: bool = True           # greedy, no penalties: fast-path eligible
    sampled: bool = False        # temperature > 0: draws from its generator
    generated: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FinishedRequest:
    request_id: int
    token_ids: list
    text: str
    finish_reason: str           # "eos" | "length"


class ContinuousEngine:
    """Slot-based continuous-batching engine over a DecoderLM (any family).

    Usage:
        eng = ContinuousEngine(lm, slots=8)
        rid = eng.submit("prompt", max_new_tokens=64)   # joins mid-decode
        eng.step()                   # one window (k tokens), all slots
        done = eng.drain()                              # finished requests
    """

    @torch.inference_mode()
    def __init__(self, lm, slots: int = 8, max_context: Optional[int] = None,
                 no_repeat_ngram_size: int = 0, steps_per_sync: int = 8,
                 auto_prefix_min: int = 32, max_prefixes: int = 8):
        self.lm = lm
        self.family = lm.family   # llama family or gpt2: same forward shape
        self.cfg = lm.config
        self.S = slots
        self.T = max_context or lm.max_context
        self.device = dev = lm.device
        self._dtype = lm._cache_dtype
        # the model's cache form; under kv_cache="int8" {"q": int8
        # [L, S, Hkv, T, D], "s": f32 [L, S, Hkv, T]}, position axis 3 in both
        self.cache_k, self.cache_v = lm._new_cache(slots, self.T)
        self._slots = [_Slot() for _ in range(slots)]
        # per-slot decode state on the device; the host reads back only the
        # packed [S, k+1] window token block
        self._last_tok = torch.zeros(slots, dtype=torch.long, device=dev)
        self._temp = torch.zeros(slots, dtype=torch.float32, device=dev)
        self._top_k = torch.zeros(slots, dtype=torch.long, device=dev)
        self._top_p = torch.ones(slots, dtype=torch.float32, device=dev)
        self._min_p = torch.zeros(slots, dtype=torch.float32, device=dev)
        self._gens = [torch.Generator(device=dev).manual_seed(i) for i in range(slots)]
        # penalties over a rolling generated-token history window; the
        # n-gram size is per engine, switched on per slot
        self.no_repeat_ngram_size = no_repeat_ngram_size
        self._penalty = torch.ones(slots, dtype=torch.float32, device=dev)
        self._ngram_on = torch.zeros(slots, dtype=torch.bool, device=dev)
        self._hist = torch.zeros((slots, _HIST_BUF), dtype=torch.long, device=dev)
        self._hist_len = torch.zeros(slots, dtype=torch.long, device=dev)
        self._next_id = 0
        self._queue: list[tuple] = []                   # waiting requests
        self._finished: list[FinishedRequest] = []
        # rid -> (recording session, submit time in ns) of a request
        # submitted while a profiler records, until its first token
        self._stamps: dict[int, tuple] = {}
        # serving telemetry (surfaced at /v1/batch_stats)
        self.stats = {"submitted": 0, "finished": 0, "windows": 0,
                      "admission_waves": 0, "prefix_hits": 0, "tokens": 0}
        # shared-prefix prompt cache: a table of up to `max_prefixes`
        # prefilled prefixes (one per system prompt); admission matches each
        # prompt against the longest. auto_prefix_min > 0 also learns
        # prefixes from traffic; 0 disables that.
        self._prefixes: list[tuple[list, tuple]] = []   # (ids, (k, v))
        self.max_prefixes = max_prefixes
        self.auto_prefix_min = auto_prefix_min
        self._auto_candidate: Optional[list] = None
        # up to `steps_per_sync` decode steps per window; the window adapts
        # down to the least-loaded slot's outstanding tokens
        self.steps_per_sync = max(int(steps_per_sync), 1)
        # working-cache bucket granularity; tests shrink it to cross
        # buckets on tiny models
        self._kv_bucket_step = 512
        # admission memory gate: above this f32-score byte bound a wave takes
        # flash (on the card, llama family) or chunked prefill instead of one
        # [n, H, S, T] score block; tests shrink it to force those plans
        self._admit_score_limit = 2_000_000_000
        self._flash_ok = bool(getattr(lm, "_flash_ok", False))
        self._admit_plans: dict = {}   # (bucket, m) -> chosen memory plan

    # ------------------------------------------------------------------

    def register_prefix(self, prompt: str) -> int:
        """Prefill `prompt` once; every later submit whose token ids start
        with it gets the cached KV copied into its slot, and admission
        computes only the suffix. Up to `max_prefixes` prefixes; each prompt
        admits against its longest match. Returns the cached token count."""
        return self._register_prefix_ids(
            self.lm.encode_prompt(prompt, add_bos=True))

    def _match_prefix(self, ids: list) -> tuple[int, int]:
        """(table index, prefix length) of the longest registered prefix
        `ids` extends by at least one token; (-1, 0) on a miss."""
        best, m = -1, 0
        for pi, (pids, _) in enumerate(self._prefixes):
            P = len(pids)
            if P > m and len(ids) > P and ids[:P] == pids:
                best, m = pi, P
        return best, m

    @torch.inference_mode()
    def _register_prefix_ids(self, ids: list) -> int:
        if len(ids) + 1 + self.steps_per_sync >= self.T:
            raise GenerationError(
                f"prefix ({len(ids)} tokens) leaves no room in slot "
                f"capacity {self.T}")
        ids = list(ids)
        for pids, _ in self._prefixes:
            if pids == ids:
                return len(ids)            # already cached
        if len(self._prefixes) >= self.max_prefixes:
            raise GenerationError(
                f"prefix table is full ({self.max_prefixes}); raise "
                f"max_prefixes or drop one workload's prefix")
        ck1, cv1 = self.lm._new_cache(1, len(ids))
        use_flash = self._flash_ok and len(ids) >= self.lm._flash_min_seq
        self.family.forward(self.lm.params, self.cfg,
                            torch.tensor([ids], dtype=torch.long, device=self.device),
                            ck1, cv1, 0, use_flash=use_flash, **self.lm.fwd_kw)
        self._prefixes.append((ids, (ck1, cv1)))   # kv: [L, 1, Hkv, P, D]
        return len(ids)

    def _maybe_auto_prefix(self, ids: list) -> None:
        """Learn shared prefixes from traffic: a prompt no registered prefix
        covers becomes the candidate; when a later uncovered prompt shares
        >= auto_prefix_min leading tokens with it, that common prefix is
        registered. Learning stops when the table is full."""
        if not self.auto_prefix_min \
                or len(self._prefixes) >= self.max_prefixes:
            return
        if self._match_prefix(ids)[0] >= 0:
            return                          # already covered by the table
        if self._auto_candidate is None:
            self._auto_candidate = list(ids)
            return
        cand = self._auto_candidate
        limit = min(len(cand), len(ids) - 1)
        m = 0
        while m < limit and cand[m] == ids[m]:
            m += 1
        if m >= self.auto_prefix_min \
                and m + 1 + self.steps_per_sync < self.T:
            self._register_prefix_ids(ids[:m])
            self._auto_candidate = None
        else:
            # keep the newer prompt as candidate so a drifting workload can
            # still converge on its current common prefix
            self._auto_candidate = list(ids)

    def _admit_plan(self, bucket: int, m: int) -> dict:
        """The admission memory plan of a (bucket, m) wave, computed as the
        JAX engine computes it. The wave attends the slot caches over the
        working range [0, kb); a materialized score block costs
        4 * H * bucket * kb bytes per lane in f32, counted over all S lanes
        (the JAX engine pads every wave to S lanes; this one runs the joining
        lanes only). Under the limit: one plain pass. Above it: flash where
        the model takes it, else the suffix in chunks whose score blocks stay
        under the limit."""
        plan = self._admit_plans.get((bucket, m))
        if plan is not None:
            return plan
        cfg = self.cfg
        n_lanes = self.S
        kb = min(-(-(m + bucket) // 256) * 256, self.T)
        eff_kb = self.T if kb >= self.T else kb
        limit = self._admit_score_limit
        score_bytes = 4 * cfg.num_heads * bucket * eff_kb * n_lanes
        chunk = None
        if score_bytes <= limit:
            mode = "plain"
        elif self._flash_ok:
            mode = "flash"
        else:
            mode = "plain"               # bucket < 128: block is tiny anyway
            for c in (2048, 1024, 512, 256, 128):
                if bucket % c == 0 and c < bucket:
                    mode, chunk = "chunked", c
                    if 4 * cfg.num_heads * c * eff_kb * n_lanes <= limit:
                        break            # largest dividing chunk under limit
        plan = {"mode": mode, "chunk": chunk, "kb": eff_kb, "score_bytes": score_bytes}
        self._admit_plans[(bucket, m)] = plan
        return plan

    def _admit_wave(self, grp: list, pi: int, m: int, bucket: int) -> None:
        """Prefill one wave of joining requests (one lane each) into their
        slots: broadcast prefix pi's KV at [0:m], prefill the right-padded
        suffixes at pos_start = m over a [0, kb) working cache, take each
        lane's last hidden row, apply the head, the penalty chain and the
        sampler, then scatter the lanes' caches and state into their slots.
        Nothing is read back: each first token is column 0 of the next
        window's block."""
        plan = self._admit_plan(bucket, m)
        mode, chunk, kb = plan["mode"], plan["chunk"], plan["kb"]
        lm, cfg, dev = self.lm, self.cfg, self.device
        n = len(grp)
        ids_n = torch.zeros((n, bucket), dtype=torch.long)
        tails = torch.zeros((n, _HIST_BUF), dtype=torch.long)
        tail_len, last_idx, slots, rows = [], [], [], []
        fp = torch.zeros((n, 4), dtype=torch.float32)
        tk, ng = [], []
        for j, (slot_idx, req) in enumerate(grp):
            rid, ids, max_new, sampling, seed, rep_pen, ngram_on = req
            sfx = ids[m:]                  # the whole prompt when m == 0
            # right-padded: a real query stops at last_idx, and decode
            # overwrites the padding's K/V before any query reaches it
            ids_n[j, :len(sfx)] = torch.tensor(sfx, dtype=torch.long)
            last_idx.append(len(sfx) - 1)
            slots.append(slot_idx)
            sp = sampling or SamplingParams(temperature=0.0)
            # penalties run over prompt + generated: seed the ring with the
            # prompt tail
            tail = ids[-_HIST_BUF:]
            tails[j, :len(tail)] = torch.tensor(tail, dtype=torch.long)
            tail_len.append(len(tail))
            fp[j] = torch.tensor((sp.temperature, 1.0 if sp.top_p is None else sp.top_p,
                                  sp.min_p or 0.0, rep_pen))
            tk.append(sp.top_k or 0)
            ng.append(bool(ngram_on))
            self._gens[slot_idx] = torch.Generator(device=dev).manual_seed(
                rid if seed is None else seed)
            if sp.temperature > 0.0:
                rows.append(j)

        ck, cv = lm._new_cache(n, kb)      # the lanes' working caches
        if m:
            for dst, src in zip((ck, cv), self._prefixes[pi][1]):
                leaves = zip(dst.values(), src.values()) if isinstance(dst, dict) \
                    else [(dst, src)]
                for d, s_ in leaves:
                    d[:, :, :, :m].copy_(s_)   # [L, 1, Hkv, m(, D)] -> every lane
        ids_d = ids_n.to(dev)
        lanes = torch.arange(n, device=dev)
        if mode == "chunked":
            last_h = torch.zeros((n, cfg.hidden_size), dtype=self._dtype, device=dev)
            for i in range(bucket // chunk):
                x = self.family.forward_hidden(lm.params, cfg,
                                               ids_d[:, i * chunk:(i + 1) * chunk],
                                               ck, cv, m + i * chunk, **lm.fwd_kw)
                sel = [j for j in range(n) if i * chunk <= last_idx[j] < (i + 1) * chunk]
                if sel:
                    sel_t = torch.tensor(sel, device=dev)
                    at = torch.tensor([last_idx[j] - i * chunk for j in sel], device=dev)
                    last_h[sel_t] = x[sel_t, at]
        else:
            x = self.family.forward_hidden(
                lm.params, cfg, ids_d, ck, cv, m, use_flash=(mode == "flash"),
                kv_bucket=(kb if mode == "flash" else None), **lm.fwd_kw)
            last_h = x[lanes, torch.tensor(last_idx, device=dev)]
        logits = self.family.head_logits(lm.params, cfg, last_h, **lm.fwd_kw).float()

        fp, tails = fp.to(dev), tails.to(dev)
        tail_len = torch.tensor(tail_len, dtype=torch.long, device=dev)
        tk = torch.tensor(tk, dtype=torch.long, device=dev)
        ng = torch.tensor(ng, dtype=torch.bool, device=dev)
        valid = torch.arange(_HIST_BUF, device=dev)[None] < tail_len[:, None]
        logits = apply_repetition_penalty(logits, tails, valid, fp[:, 3])
        if self.no_repeat_ngram_size > 1:
            logits = torch.where(ng[:, None], apply_no_repeat_ngram(
                logits, tails, tail_len, self.no_repeat_ngram_size), logits)
        gens = [self._gens[s] for s in slots]
        toks = _sample_slot(logits, gens, rows, fp[:, 0], tk, fp[:, 1], fp[:, 2])
        h, hl = _hist_append(tails, tail_len, toks)

        slots_t = torch.tensor(slots, device=dev)
        for full, w in ((self.cache_k, ck), (self.cache_v, cv)):
            leaves = zip(full.values(), w.values()) if isinstance(full, dict) \
                else [(full, w)]
            for f, w_ in leaves:
                f[:, slots_t, :, :kb] = w_
        self._last_tok[slots_t] = toks
        self._hist[slots_t] = h
        self._hist_len[slots_t] = hl
        self._temp[slots_t] = fp[:, 0]
        self._top_p[slots_t] = fp[:, 1]
        self._min_p[slots_t] = fp[:, 2]
        self._penalty[slots_t] = fp[:, 3]
        self._top_k[slots_t] = tk
        self._ngram_on[slots_t] = ng

    # ------------------------------------------------------------------

    def submit(self, prompt: Optional[str] = None, max_new_tokens: int = 128,
               sampling: Optional[SamplingParams] = None,
               seed: Optional[int] = None,
               repetition_penalty: float = 1.0,
               no_repeat_ngram: bool = False,
               defer_admit: bool = False,
               token_ids: Optional[list] = None) -> int:
        """Queue a request; it joins the running batch at the next step.

        sampling=None (or temperature <= 0) decodes greedily; otherwise the
        slot samples with its own temperature / top_k / top_p / min_p from a
        generator seeded with `seed` (default: the request id).
        repetition_penalty compounds per occurrence over the slot's last
        _HIST_BUF tokens; no_repeat_ngram uses the engine's
        `no_repeat_ngram_size`, switched on per request.

        defer_admit=True only queues, so that the next step() admits a whole
        burst in one batched prefill per bucket (serve_batching's
        ContinuousRunner does this).
        """
        if no_repeat_ngram and self.no_repeat_ngram_size <= 1:
            raise GenerationError(
                "engine was built with no_repeat_ngram_size<=1; pass it to "
                "ContinuousEngine(...) to enable per-request ngram blocking")
        if token_ids is not None:
            ids = list(token_ids)        # pre-encoded (e.g. serve_openai)
        elif prompt is not None:
            ids = self.lm.encode_prompt(prompt, add_bos=True)
        else:
            raise GenerationError("either prompt or token_ids is required")
        self._maybe_auto_prefix(ids)
        # worst-case cache frontier: prefill + decode writes. A slot that
        # finishes mid-window still writes its whole window, so reserve one
        # maximal window of overshoot beyond the max_new-1 decode writes.
        k = self.steps_per_sync
        need = len(ids) + (max_new_tokens - 1) + k
        if need > self.T:
            raise GenerationError(
                f"prompt ({len(ids)} tokens) + max_new_tokens "
                f"({max_new_tokens}) + worst-case {k}-token decode-window "
                f"overshoot ({need} total) exceeds slot capacity {self.T}")
        rid = self._next_id
        self._next_id += 1
        if profiling.recording():
            self._stamps[rid] = (profiling.session(), time.perf_counter_ns())
        self._queue.append((rid, ids, max_new_tokens, sampling, seed,
                            repetition_penalty, no_repeat_ngram))
        self.stats["submitted"] += 1
        if not defer_admit:
            self._admit()
        return rid

    @torch.inference_mode()
    def _admit(self) -> None:
        """Prefill queued requests into free slots: one batched prefill per
        (prefix, prompt bucket) wave, no device -> host sync."""
        pairs = []
        for slot_idx, slot in enumerate(self._slots):
            if not self._queue:
                break
            if slot.active:
                continue
            pairs.append((slot_idx, self._queue.pop(0)))
        if not pairs:
            return
        groups: dict[tuple, list] = {}
        for slot_idx, req in pairs:
            ids = req[1]
            # a prefix hit leaves at least one suffix token for the logits;
            # the suffix bucket is capped at the capacity left after the
            # prefix, so the wave's writes stay inside the slot
            pi, m = self._match_prefix(ids)
            groups.setdefault(
                (pi, m, seq_bucket(len(ids) - m, self.T - m)), []).append(
                (slot_idx, req))
        for (pi, m, bucket), grp in groups.items():
            self.stats["admission_waves"] += 1
            if m:
                self.stats["prefix_hits"] += len(grp)
            with profiling.annotate("kjarni.engine.admit_wave", device=self.device.type == "cuda",
                                    lanes=len(grp), bucket=bucket) as span:
                if span:
                    span.count(prompt_tokens=sum(len(req[1]) - m for _, req in grp))
                self._admit_wave(grp, pi, m, bucket)
            for slot_idx, req in grp:
                rid, ids, max_new, sampling = req[0], req[1], req[2], req[3]
                sp = sampling or SamplingParams(temperature=0.0)
                slot = self._slots[slot_idx]
                slot.request_id = rid
                slot.active = True
                slot.pos = len(ids)
                slot.remaining = max_new
                slot.pending_first = True
                slot.plain = (sp.temperature <= 0.0 and req[5] == 1.0
                              and not req[6])
                slot.sampled = sp.temperature > 0.0
                slot.generated = []

    def _note_token(self, slot_idx: int, tok: int) -> None:
        """Bookkeep one accepted token (the device already appended it to
        the slot's history ring)."""
        slot = self._slots[slot_idx]
        if tok in self.lm.stop_token_ids:
            self._finish(slot_idx, "eos")
            return
        slot.generated.append(tok)
        self.stats["tokens"] += 1
        slot.remaining -= 1
        if slot.remaining <= 0:
            self._finish(slot_idx, "length")

    def _finish(self, slot_idx: int, reason: str) -> None:
        self.stats["finished"] += 1
        slot = self._slots[slot_idx]
        self._finished.append(FinishedRequest(
            request_id=slot.request_id,
            token_ids=list(slot.generated),
            text=self.lm.tokenizer.decode(slot.generated),
            finish_reason=reason))
        slot.active = False

    # ------------------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(s.active for s in self._slots)

    @property
    def num_waiting(self) -> int:
        return len(self._queue)

    def _window(self, k: int, plain: bool, kb: Optional[int], pos: list):
        """k decode steps of every slot over the [0, kb) working slice of
        the slot caches (the whole cache when kb is None). plain: every
        active slot is greedy without penalties, so the step is an argmax
        with no penalty chain, sampler or ring upkeep (stale rings are
        harmless: penalty 1.0 and no n-gram ban ignore them). Returns the
        packed [S, k + 1] block, the window's one readback."""
        lm, dev = self.lm, self.device
        wk = self.cache_k if kb is None else slice_working(self.cache_k, kb, axis=3)
        wv = self.cache_v if kb is None else slice_working(self.cache_v, kb, axis=3)
        pos_d = torch.tensor(pos, dtype=torch.long, device=dev)
        rows = [i for i, s in enumerate(self._slots) if s.active and s.sampled]
        ngram = self.no_repeat_ngram_size
        toks = self._last_tok
        cols = [toks]
        with profiling.annotate("kjarni.engine.decode", device=self.device.type == "cuda", k=k,
                                S=self.S) as span:
            if span:
                span.count(active=sum(s.active for s in self._slots))
            for i in range(k):
                logits, _, _ = self.family.forward(lm.params, self.cfg, toks[:, None],
                                                   wk, wv, pos_d + i, **lm.fwd_kw)
                if plain:
                    toks = torch.argmax(logits, dim=-1)
                else:
                    lg = logits.float()
                    valid = torch.arange(_HIST_BUF, device=dev)[None] < self._hist_len[:, None]
                    lg = apply_repetition_penalty(lg, self._hist, valid, self._penalty)
                    if ngram > 1:
                        lg = torch.where(self._ngram_on[:, None], apply_no_repeat_ngram(
                            lg, self._hist, self._hist_len, ngram), lg)
                    toks = _sample_slot(lg, self._gens, rows, self._temp, self._top_k,
                                        self._top_p, self._min_p)
                    self._hist, self._hist_len = _hist_append(self._hist, self._hist_len,
                                                              toks)
                cols.append(toks)
            self._last_tok = toks
            block = torch.stack(cols, dim=1)
        with profiling.annotate("kjarni.engine.readback"):
            return block.cpu().tolist()

    @torch.inference_mode()
    def step(self) -> None:
        """Decode one window (up to steps_per_sync tokens) for every active
        slot, with one host sync: the packed [S, k+1] token block.

        A slot that finishes mid-window (EOS or budget) has its trailing
        window tokens discarded; the capacity check in submit() reserves the
        overshoot, so those cache writes stay inside the slot.
        """
        with profiling.annotate("kjarni.engine.step"):
            self._admit()   # freed slots pick up waiting requests first
            if self.num_active == 0:
                return
            was_active = [s.active for s in self._slots]
            pending = [s.pending_first for s in self._slots]
            # an inactive slot decodes in lockstep at 0, 1, ... of its own row,
            # always inside the working slice
            pos = [s.pos if s.active else 0 for s in self._slots]
            # adaptive window: the smallest power of two covering the least-
            # loaded active slot's outstanding tokens, capped at steps_per_sync
            needed = min(
                (s.remaining - (1 if s.pending_first else 0)
                 for s in self._slots if s.active))
            k = 1
            while k < needed and k * 2 <= self.steps_per_sync:
                k *= 2
            self.stats["windows"] += 1
            plain = all(s.plain for s in self._slots if s.active)
            # working-cache bucket: the highest active frontier plus this
            # window, rounded up to the bucket step
            kbs = self._kv_bucket_step
            top = max(s.pos for s in self._slots if s.active)
            kb = -(-(top + k + 1) // kbs) * kbs
            if kb >= self.T:
                kb = None
            out = self._window(k, plain, kb, pos)
            first_ns = time.perf_counter_ns() if self._stamps else None
            with profiling.annotate("kjarni.engine.deliver"):
                for i, slot in enumerate(self._slots):
                    if not was_active[i]:
                        continue
                    if pending[i]:
                        # column 0 = the token sampled at admission; its cache
                        # write happened as step 0 of THIS window, so pos does
                        # not advance
                        slot.pending_first = False
                        stamp = self._stamps.pop(slot.request_id, None) if first_ns else None
                        if stamp is not None and stamp[0] == profiling.session():
                            profiling.note("kjarni.engine.first_token", stamp[1], first_ns)
                        self._note_token(i, out[i][0])
                        if not slot.active:
                            continue
                    for j in range(1, k + 1):
                        slot.pos += 1
                        self._note_token(i, out[i][j])
                        if not slot.active:
                            break   # discard the rest of the window
            # slots freed this window admit waiting work at once, so the next
            # step() decodes them
            if self._queue:
                self._admit()

    def drain(self) -> list[FinishedRequest]:
        out, self._finished = self._finished, []
        return out

    def run(self) -> list[FinishedRequest]:
        """Step until every submitted request has finished."""
        while self.num_active or self.num_waiting:
            self.step()
        return self.drain()
