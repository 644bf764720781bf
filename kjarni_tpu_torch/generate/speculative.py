"""Speculative decoding: a draft model proposes, the target verifies in one
forward (port of kjarni_tpu/generate/speculative.py; cf. the reference's
cpu/decoder/speculation.rs).

Each round, on the host:

  1. draft  — k + 1 greedy draft steps, one token (M = 1) each;
  2. target — ONE forward over [cur, d1..dk] with logits at every position;
  3. verify — greedy acceptance (or the probabilistic rule) and the bonus
     token, on the device; the round's one readback is the packed
     [n_acc, next, d1..dk].

Both passes run on a `kv_bucket` working slice of their cache. Rejected
positions need no rollback: the next round overwrites them before any query
attends them. The JAX package also fuses the greedy rounds into one
`lax.while_loop` (its `fused_loop`); here `generate` and `generate_stream`
share this host loop, so both give the same ids.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from ..core.cancellation import CancellationToken
from ..core.errors import GenerationError
from ..core.kvcache import slice_working
from ..core.stats import GenerationStats
from ..models.llama import cache_slots
from .sampling import GenerationConfig
from .stream import StreamDecoder, StreamedToken, TokenType


def verify_greedy(target_logits: torch.Tensor, draft_tokens: torch.Tensor):
    """(accepted count, next token): the drafts up to the first one the
    target's argmax disagrees with, then the target's own token there."""
    k = draft_tokens.shape[0]
    preds = torch.argmax(target_logits, dim=-1)            # [k+1]
    matches = preds[:k] == draft_tokens
    n_acc = torch.argmin(torch.cat([matches, matches.new_zeros(1)]).int())
    return n_acc, preds[n_acc]


def verify_prob(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                draft_tokens: torch.Tensor, generator: torch.Generator):
    """Probabilistic acceptance: draft i is kept with probability
    min(1, p_i / q_i); at the first rejection the next token is drawn from
    the residual max(p - q, 0), and after k acceptances from the target's
    p[k] (the bonus token)."""
    k = draft_tokens.shape[0]
    p = torch.softmax(target_logits.float(), dim=-1)       # [k+1, V]
    q = torch.softmax(draft_logits.float(), dim=-1)        # [k, V]
    p_tok = p[:k].gather(1, draft_tokens[:, None])[:, 0]
    q_tok = q.gather(1, draft_tokens[:, None])[:, 0]
    u = torch.rand(k, generator=generator, device=p.device)
    accept = u < p_tok / q_tok.clamp_min(1e-20)
    n_acc = torch.argmin(torch.cat([accept, accept.new_zeros(1)]).int())
    j = n_acc.clamp(max=k - 1)
    residual = (p[j] - q[j]).clamp_min(0.0)
    residual = residual / residual.sum().clamp_min(1e-20)
    resampled = torch.multinomial(residual + 1e-20, 1, generator=generator)[0]
    bonus = torch.multinomial(p[k] + 1e-20, 1, generator=generator)[0]
    return n_acc, torch.where(n_acc == k, bonus, resampled)


class SpeculativeGenerator:
    """Cf. run_speculative_generation_loop (speculation.rs:42)."""

    def __init__(self, target, draft, num_tokens: int = 4,
                 probabilistic: bool = False):
        if target.config.vocab_size != draft.config.vocab_size:
            raise GenerationError(
                "draft and target models must share a vocabulary")
        self.target = target
        self.draft = draft
        self.k = num_tokens
        self.probabilistic = probabilistic
        # acceptance telemetry, per generation
        self.last_rounds = 0
        self.last_drafted = 0
        self.last_accepted = 0

    @property
    def last_acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target accepted, last generation."""
        return (self.last_accepted / self.last_drafted
                if self.last_drafted else 0.0)

    @staticmethod
    def _prefill(lm, ids: list, ck, cv) -> torch.Tensor:
        """A from-zero prefill through the model's own prefill path (flash at
        a bucket >= 512 on the card); the model keeps no session prefix."""
        lm._session_ids = []
        logits, _, _, _ = lm._prefill_with_reuse(ids, ck, cv)
        return logits

    def _round(self, caches, cur: torch.Tensor, pos: int, generator):
        """One round at cache slot `pos` (cur's slot). Returns (accepted
        count, next token, the k drafted ids) as host ints."""
        target, draft, k = self.target, self.draft, self.k
        tck, tcv, dck, dcv = caches
        kbs = getattr(target, "_kv_bucket_step", 512)
        kb = -(-(pos + k + 2) // kbs) * kbs        # covers pos .. pos + k
        if kb < cache_slots(dck):
            dck, dcv = slice_working(dck, kb, axis=3), slice_working(dcv, kb, axis=3)
        if kb < cache_slots(tck):
            tck, tcv = slice_working(tck, kb, axis=3), slice_working(tcv, kb, axis=3)
        tok = cur.view(1, 1)
        d_toks, d_logits = [], []
        for i in range(k + 1):
            lg, _, _ = draft.family.forward_all_logits(draft.params, draft.config, tok,
                                                       dck, dcv, pos + i,
                                                       **draft.fwd_kw)
            nxt = torch.argmax(lg[0, 0])
            d_toks.append(nxt)
            d_logits.append(lg[0, 0])
            tok = nxt.view(1, 1)
        d_toks = torch.stack(d_toks[:k])
        tokens_in = torch.cat([cur.view(1), d_toks])[None]
        t_logits, _, _ = target.family.forward_all_logits(target.params, target.config,
                                                          tokens_in, tck, tcv, pos,
                                                          **target.fwd_kw)
        if self.probabilistic:
            n_acc, nxt = verify_prob(t_logits[0], torch.stack(d_logits[:k]), d_toks,
                                     generator)
        else:
            n_acc, nxt = verify_greedy(t_logits[0], d_toks)
        packed = torch.cat([n_acc.view(1).long(), nxt.view(1).long(), d_toks]).tolist()
        return packed[0], packed[1], packed[2:]

    @torch.inference_mode()
    def _ids(self, gen: GenerationConfig, prompt, token_ids,
             cancellation: Optional[CancellationToken],
             stats: Optional[GenerationStats] = None) -> Iterator[int]:
        """The generated ids: the target's first token, then each round's
        accepted drafts and its next token, honoring stop ids, max_new and
        the context."""
        target, draft = self.target, self.draft
        if token_ids is None:
            if prompt is None:
                raise GenerationError("either prompt or token_ids is required")
            token_ids = target.encode_prompt(prompt, gen.add_bos_token)
        ids = list(token_ids)[: target.max_context - self.k - 2]
        prompt_len = len(ids)
        self.last_rounds = self.last_drafted = self.last_accepted = 0
        tck, tcv = target._ensure_cache()
        if draft is target:
            # self-drafting: the draft role needs a cache of its own
            dck, dcv = draft.family.init_cache(draft.config, 1, draft.max_context,
                                               draft._cache_dtype, draft.device)
        else:
            dck, dcv = draft._ensure_cache()
        t_logits = self._prefill(target, ids, tck, tcv)
        self._prefill(draft, ids, dck, dcv)
        cur = torch.argmax(t_logits)
        seed = target.sampling_seed(gen.seed)
        generator = torch.Generator(device=target.device).manual_seed(seed)
        max_new = gen.max_new_tokens if gen.max_new_tokens is not None else \
            max(gen.max_length - prompt_len, 0)
        max_pos = min(target.max_context, draft.max_context, gen.max_length)
        stop = target.stop_token_ids
        pos = prompt_len
        n = 0
        c = int(cur)
        if stats is not None:     # the first token is read back: both prefills are done
            stats.mark_prefill(prompt_len)
        if c in stop:
            return
        yield c
        n += 1
        while n < max_new:
            if cancellation is not None and cancellation.is_cancelled:
                return
            if pos + self.k + 2 >= max_pos:
                return
            n_acc, nxt, drafted = self._round((tck, tcv, dck, dcv), cur, pos, generator)
            self.last_rounds += 1
            self.last_drafted += self.k
            self.last_accepted += n_acc
            for t in drafted[:n_acc]:
                if t in stop or n >= max_new:
                    return
                yield t
                n += 1
            if nxt in stop or n >= max_new:
                return
            yield nxt
            n += 1
            cur = torch.tensor(nxt, dtype=torch.long, device=target.device)
            pos += n_acc + 1

    def generate_stream(self, prompt: Optional[str] = None, *,
                        token_ids=None,
                        config: Optional[GenerationConfig] = None,
                        cancellation: Optional[CancellationToken] = None,
                        ) -> Iterator[StreamedToken]:
        gen = config or GenerationConfig.greedy()
        stats = GenerationStats()
        stats.start()
        sdec = StreamDecoder(self.target.tokenizer)
        n = 0
        try:
            for t in self._ids(gen, prompt, token_ids, cancellation, stats):
                n += 1
                yield StreamedToken(sdec.push(t), t, TokenType.GENERATED)
        finally:
            self.target._session_ids = []
            self.draft._session_ids = []
            stats.mark_decode_done(n)
            stats.print_summary()

    def generate(self, prompt: Optional[str] = None, *,
                 token_ids=None,
                 config: Optional[GenerationConfig] = None,
                 cancellation: Optional[CancellationToken] = None) -> str:
        """Blocking speculative generation. Greedy calls decode the ids at
        once, as the JAX package's fused loop returns them; the others join
        the streamed text, as the JAX package does."""
        gen = config or GenerationConfig.greedy()
        if (self.probabilistic or gen.strategy != "greedy"
                or cancellation is not None):
            return "".join(st.text for st in self.generate_stream(
                prompt, token_ids=token_ids, config=gen, cancellation=cancellation))
        try:
            toks = list(self._ids(gen, prompt, token_ids, None))
        finally:
            self.target._session_ids = []
            self.draft._session_ids = []
        return self.target.tokenizer.decode(toks, skip_special_tokens=True)
