"""DecoderLM: a loaded decoder language model (llama family or GPT-2) with a
streaming generator and batched generation (port of
kjarni_tpu/models/decoder_lm.py).

Per request: one prefill forward over the prompt bucket, writing the KV cache
in place and skipping a prefix that is still in the cache from the previous
request; then a host loop, one forward and one host sync (the sampled id) per
token. The JAX package fuses that loop into a `lax.while_loop` with an
on-device stop exit; here the loop is on the host and keeps the same
semantics: the stop token is dropped, and decode attention reads the cache
only up to the current 512-slot bucket. `generate_batch` runs ragged prompts
left-padded in one per-call cache, with a shared prompt prefix prefilled
once and broadcast into every row.

While a torch profiler runs, the stream records its spans
(core/profiling.py): kjarni.stream.request, .start, .prefill (with the
card's time) and one .decode_step a token.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random as _random
import time
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import torch

from ..chat_templates import ChatTemplate, Conversation, template_for_arch
from ..core import profiling
from ..core.bucketing import seq_bucket
from ..core.cancellation import CancellationToken
from ..core.errors import GenerationError, InvalidConfigError
from ..core.kvcache import slice_working
from ..core.placement import ExecutionPlan, resolve_device, to_host_memory
from ..core.stats import GenerationStats
from ..parallel.comm import from_rank0, require_world
from ..parallel.mesh import make_mesh, shard_cache, shard_llama_params
from ..generate.sampling import (GenerationConfig, SamplingParams, process_logits,
                                 sample_token)
from ..generate.stream import StreamDecoder, StreamedToken, TokenType
from ..tokenizer import KjarniTokenizer
from ..tokenizer_native import bpe_from_gguf_metadata
from ..weights.checkpoint import load_checkpoint
from ..weights.gguf import GgufWeights
from ..weights.safetensors_loader import ModelWeights
from . import gpt2 as kgpt2
from . import llama as kllama

DEFAULT_MAX_CONTEXT = 4096
# Cache-reuse prefill takes flash above this many bytes of f32 scores
# (4 * heads * bucket * (reused + bucket)). The JAX package's 2 GB gate was
# tuned on a TPU. On an H100 (chip_smoke.py phase 2, Llama-3.2-1B width, 4096
# cache slots) flash wins at both ends of what reaches the gate: 0.045 ms
# against 3.19 ms for the materialized attention at a 1024 bucket over 765
# reused slots (234 MB of scores), 0.012 ms against 1.60 ms at a 512 bucket
# over 16. The materialized path reads the whole cache, so no crossover lies
# above the 512-token flash bucket, and every reuse prefill there takes flash.
REUSE_FLASH_MIN_SCORE_BYTES = 0

logger = logging.getLogger(__name__)


def _check_tp(tp: int, llama_family: bool, execution_plan, cfg) -> None:
    """The JAX DecoderLM's tp gates (family, plan, devices), the last as a
    process group of tp ranks; and, since each rank computes only its own
    shard, heads, KV heads and the FFN width must divide tp."""
    if not llama_family:
        raise InvalidConfigError(
            "tensor parallelism (tp>1) supports llama-family models "
            "only (llama/qwen2/mistral/phi3)")
    if execution_plan is not None:
        raise InvalidConfigError(
            "tp>1 and execution_plan host-offload are mutually "
            "exclusive (host pinning is a single-chip optimization)")
    require_world(tp, "tp")
    dims = {"heads": cfg.num_heads, "kv heads": cfg.num_kv_heads,
            "intermediate size": cfg.intermediate_size}
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise InvalidConfigError(f"tp={tp} must divide the model's {bad}")


def _to_device(params: dict, device: torch.device) -> dict:
    """A param tree on `device`. A head that is a view of the embedding
    (tied, and replicated under tp) stays a view of the moved table."""
    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        return t.to(device) if torch.is_tensor(t) else t
    out = move(params)
    head, embed = params["lm_head"], params["embed"]
    if torch.is_tensor(head) and \
            head.untyped_storage().data_ptr() == embed.untyped_storage().data_ptr():
        out["lm_head"] = out["embed"].t()
    return out


def not_ported(what: str, item: str) -> InvalidConfigError:
    return InvalidConfigError(
        f"{what} is not ported to kjarni_tpu_torch yet (ROADMAP.md, {item})")


def auto_dtype(dtype, device: torch.device) -> torch.dtype:
    """"auto" -> bf16 on the card, f32 on the CPU (as the JAX package's
    resolve_dtype); names and torch dtypes pass through."""
    if dtype in ("auto", None):
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if isinstance(dtype, str):
        return {"f32": torch.float32, "float32": torch.float32,
                "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}[dtype]
    return dtype


def resolve_dtype(dtype, device: torch.device) -> torch.dtype:
    """The decoder's dtype: auto_dtype, bf16 or f32 on either device. Both
    kernels take both on the card, as the Pallas kernels do: flash has an f32
    kernel, and int4 rounds an f32 x to bf16 and answers in f32."""
    dtype = auto_dtype(dtype, device)
    if dtype not in (torch.bfloat16, torch.float32):
        raise InvalidConfigError(f"unsupported decoder dtype {dtype} (bf16 or f32)")
    return dtype


class DecoderLM:
    """A causal LM ready for generation (cf. DecoderLanguageModel traits.rs:272)."""

    def __init__(self, model_dir: Path, dtype="auto",
                 max_context: Optional[int] = None,
                 quantize: Optional[str] = None,
                 kv_cache: Optional[str] = None,
                 execution_plan=None,
                 tp: Optional[int] = None,
                 device=None):
        if quantize not in (None, "int8", "int4"):
            raise InvalidConfigError(f"unknown quantize mode '{quantize}'")
        if kv_cache not in (None, "int8"):
            raise InvalidConfigError(f"unknown kv_cache mode '{kv_cache}'")
        plan = ExecutionPlan.resolve(execution_plan)   # an unknown plan raises here
        tp = tp if tp is not None and tp > 1 else None
        self.device = resolve_device(device)
        dtype = resolve_dtype(dtype, self.device)
        model_dir = Path(model_dir)
        self.model_dir = model_dir
        # weights source priority: native checkpoint > safetensors > GGUF
        # (gguf_loader.rs fallback order, plus the native fast path)
        gguf_path = model_dir / "model.gguf"
        has_safetensors = (model_dir / "model.safetensors").exists() or \
            (model_dir / "model.safetensors.index.json").exists()
        # under tp the whole model is read, quantized and sharded in host
        # memory, and only this rank's shard goes to its device
        load_device = torch.device("cpu") if tp is not None else self.device
        ws = None
        params = load_checkpoint(model_dir, load_device)   # None without one
        if has_safetensors:
            ws = ModelWeights(model_dir)
        elif gguf_path.exists():
            ws = GgufWeights(gguf_path)
        elif params is None:
            ws = ModelWeights(model_dir)  # raises with a clear error
        cfg_path = model_dir / "config.json"
        if cfg_path.exists():
            hf_cfg = json.loads(cfg_path.read_text())
        else:
            hf_cfg = ws.hf_config()  # GGUF metadata -> HF-style config
        self.hf_config = hf_cfg
        if hf_cfg.get("model_type", "llama") == "gpt2":
            self.family = kgpt2
            self.config = cfg = kgpt2.Gpt2Config.from_hf(hf_cfg)
        else:
            self.family = kllama
            self.config = cfg = kllama.DecoderConfig.from_hf(hf_cfg)
        if kv_cache == "int8" and self.family is not kllama:
            raise InvalidConfigError(
                "kv_cache='int8' supports llama-family models only "
                "(llama/qwen2/mistral/phi3)")
        self._kv_quantized = kv_cache == "int8"
        if tp is not None:
            _check_tp(tp, self.family is kllama, execution_plan, cfg)

        self.max_context = min(cfg.max_seq_len, max_context or DEFAULT_MAX_CONTEXT)
        if params is not None:
            # the checkpoint's dtype rules
            dtype = resolve_dtype(params["embed"].dtype, self.device)
        elif self.family is kllama:
            params = kllama.load_params(ws, cfg, dtype, rope_cache_len=self.max_context,
                                        device=load_device)
        else:
            params = kgpt2.load_params(ws, cfg, dtype, device=load_device)
        # quantize is ignored for gpt2, and for a checkpoint already quantized,
        # as in the JAX package
        if self.family is kllama and not isinstance(params["lm_head"], dict):
            if quantize == "int8":
                params = kllama.quantize_params_int8(params)
            elif quantize == "int4":
                params = kllama.quantize_params_int4(params)

        # tensor parallelism (SPMD): this rank keeps its Megatron shard of
        # the quantized params and a cache of its own KV heads
        # (parallel/mesh.py); models/llama.py runs the collectives over
        # `self.tp`, which every forward call passes in `fwd_kw`
        self._mesh = self.tp = None
        self.fwd_kw: dict = {}
        if tp is not None:
            self._mesh = make_mesh(dp=1, tp=tp)
            self.tp = self._mesh.comm("tp")
            self.fwd_kw = {"tp": self.tp}
            params = _to_device(shard_llama_params(params, self._mesh), self.device)

        # per-stage host offload (ExecutionPlan, execution/plan.rs:4): the
        # embedding table and/or the lm head in host memory, their lookup
        # and matmul on the host (core/placement.py). Llama family only, as
        # in the JAX package: gpt2 ties everything through wte. A quantized
        # (dict) head stays on the device, 4x smaller already. A tied head
        # is a view of the table: under offload_ends it stays a view of the
        # one host copy; offload_head alone copies it to the host and the
        # table stays on the card for the lookup.
        self.execution_plan = plan
        if self.family is kllama and plan != ExecutionPlan():
            head = params["lm_head"]
            embed_host = plan.embeddings == "host"
            head_host = plan.lm_head == "host" and not isinstance(head, dict)
            tied = not isinstance(head, dict) and \
                head.untyped_storage().data_ptr() == \
                params["embed"].untyped_storage().data_ptr()
            params = dict(params)
            if embed_host:
                params["embed"] = to_host_memory(params["embed"])
            if head_host:
                params["lm_head"] = (params["embed"].t() if tied and embed_host
                                     else to_host_memory(head))
            self.config = cfg = dataclasses.replace(
                cfg, embed_on_host=embed_host, lm_head_on_host=head_host)
        self.params = params
        self._cache_dtype = dtype
        self._cache = None  # allocated lazily, reused across generations

        tok_path = model_dir / "tokenizer.json"
        if tok_path.exists():
            self.tokenizer = KjarniTokenizer.from_file(tok_path)
        else:
            # GGUF files embed vocab and merges: the in-tree BPE over them
            bpe = bpe_from_gguf_metadata(ws.metadata) \
                if isinstance(ws, GgufWeights) else None
            if bpe is None:
                raise InvalidConfigError(
                    f"no tokenizer.json in {model_dir} and no GGUF-embedded "
                    f"tokenizer available")
            self.tokenizer = bpe
        self.chat_template: ChatTemplate = template_for_arch(cfg.arch)

        # stop tokens: generation_config.json eos wins over config.json
        eos: tuple[int, ...] = tuple(cfg.eos_token_ids)
        gen_cfg_path = model_dir / "generation_config.json"
        self.hf_generation_config: dict = {}
        if gen_cfg_path.exists():
            self.hf_generation_config = json.loads(gen_cfg_path.read_text())
            g_eos = self.hf_generation_config.get("eos_token_id")
            if g_eos is not None:
                eos = tuple(g_eos) if isinstance(g_eos, list) else (int(g_eos),)
        self.stop_token_ids = set(eos)
        self.bos_token_id = cfg.bos_token_id

        # flash prefill: on the card, llama family, for long prompts
        self._flash_min_seq = 512
        self._flash_ok = self.device.type == "cuda" and self.family is kllama
        # decode attention reads only the current ceil-to-bucket slice of the
        # cache; contexts at or below one bucket read the whole cache
        self._kv_bucket_step = 512
        # conversation prefix reuse: token ids currently in the cache
        self._session_ids: list[int] = []
        self._min_reuse_prefix = 16

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def sampling_seed(self, seed: Optional[int]) -> int:
        """The seed of a sampled generation: the caller's, else a fresh one,
        under tensor parallelism rank 0's, so every rank draws the same
        tokens and runs the same number of steps."""
        if seed is not None:
            return seed
        if self.tp is None:
            return _random.getrandbits(31)
        return from_rank0(lambda: _random.getrandbits(31))

    def _new_cache(self, batch: int, slots: int):
        """A zeroed KV cache of the model's form: int8 under kv_cache="int8",
        this rank's KV heads under tensor parallelism."""
        if self._kv_quantized:
            cache = kllama.init_cache(self.config, batch, slots, self._cache_dtype,
                                      self.device, quantized=True)
        else:
            cache = self.family.init_cache(self.config, batch, slots,
                                           self._cache_dtype, self.device)
        return cache if self._mesh is None else shard_cache(cache, self._mesh)

    def _ensure_cache(self):
        if self._cache is None:
            self._cache = self._new_cache(1, self.max_context)
        return self._cache

    @torch.inference_mode()
    def _prefill_with_reuse(self, ids: list[int], ck, cv):
        """Prefill `ids`, skipping the longest cache-resident common prefix.

        Multi-turn chat re-sends the whole conversation; the K/V of the shared
        prefix is already in the cache from the previous turn, so only the
        suffix is computed (incremental prefill / prompt caching).
        """
        prompt_len = len(ids)
        common = 0
        limit = min(len(self._session_ids), prompt_len - 1)
        while common < limit and self._session_ids[common] == ids[common]:
            common += 1
        if common < self._min_reuse_prefix:
            common = 0

        suffix = ids[common:]
        bucket = seq_bucket(len(suffix), self.max_context - common)
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :len(suffix)] = torch.tensor(suffix, dtype=torch.long)
        use_flash = self._flash_ok and bucket >= self._flash_min_seq
        kv_bucket = None
        if use_flash and common > 0:
            # cache-reuse prefill: flash where the f32 score matrix would
            # pass REUSE_FLASH_MIN_SCORE_BYTES
            score_bytes = 4 * self.config.num_heads * bucket * (common + bucket)
            use_flash = score_bytes > REUSE_FLASH_MIN_SCORE_BYTES
        if use_flash:
            kv_bucket = min(-(-(common + bucket) // 128) * 128, self.max_context)
        with profiling.annotate("kjarni.stream.prefill", device=self.device.type == "cuda",
                                prompt_tokens=len(suffix), bucket=bucket):
            logits, ck, cv = self.family.forward(
                self.params, self.config, padded.to(self.device), ck, cv, common,
                len(suffix) - 1, use_flash=use_flash, kv_bucket=kv_bucket, **self.fwd_kw)
        self.last_prefill_tokens = len(suffix)  # observability for tests/stats
        return logits[0], ck, cv, common

    def _kv_bucket(self, pos: int, slots: Optional[int] = None) -> Optional[int]:
        """Cache slots decode attention reads when writing slot `pos`: the
        ceil-to-bucket fill, or None (the whole cache of `slots`, default
        max_context) once that covers it."""
        kb = -(-(pos + 1) // self._kv_bucket_step) * self._kv_bucket_step
        return None if kb >= (slots or self.max_context) else kb

    @torch.inference_mode()
    def _decode(self, logits, ck, cv, history: torch.Tensor, pos: int,
                gen: GenerationConfig, generator: torch.Generator, steps: int,
                cancellation: Optional[CancellationToken] = None,
                first_read: Optional[Callable[[], None]] = None,
                ) -> Iterator[int]:
        """Sample, then forward the sampled token, one host sync per token.

        Yields at most `steps` generated ids, each after its K/V is in the
        cache. Stops before yielding a stop token (it is dropped, as the JAX
        package's `n = i - done` does) and at the context or max_length limit.
        `first_read` is called once the first token is read back to the host.
        """
        greedy = gen.strategy == "greedy"
        pen, ngram = gen.repetition_penalty, gen.no_repeat_ngram_size
        for _ in range(steps):
            if cancellation is not None and cancellation.is_cancelled:
                return
            if pos >= self.max_context or pos >= gen.max_length:
                return
            with profiling.annotate("kjarni.stream.decode_step"):
                lg = process_logits(logits, history, pos, pen, ngram)
                tok = sample_token(lg, generator, gen.sampling, greedy)
                t = int(tok)
                if first_read is not None:
                    first_read()
                    first_read = None
                if t in self.stop_token_ids:
                    return
                history[pos] = tok
                # the static bucket changes every _kv_bucket_step tokens: the
                # segments of the JAX package's fused loop
                kb = self._kv_bucket(pos)
                wk = ck if kb is None else slice_working(ck, kb, axis=3)
                wv = cv if kb is None else slice_working(cv, kb, axis=3)
                logits, _, _ = self.family.forward(self.params, self.config, tok.view(1, 1),
                                                   wk, wv, pos, **self.fwd_kw)
                logits = logits[0]
            pos += 1
            yield t

    def _start(self, gen: GenerationConfig, prompt, token_ids):
        if token_ids is None:
            if prompt is None:
                raise GenerationError("either prompt or token_ids is required")
            token_ids = self.encode_prompt(prompt, gen.add_bos_token)
        ids = self._bound_prompt(list(token_ids))
        if not ids:
            raise GenerationError("empty prompt")
        history = torch.zeros(self.max_context, dtype=torch.long, device=self.device)
        history[:len(ids)] = torch.tensor(ids, dtype=torch.long)
        seed = self.sampling_seed(gen.seed)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return ids, history, generator

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _bound_prompt(self, ids: list[int]) -> list[int]:
        """Bound a prompt to the context window, keeping the NEWEST tokens."""
        limit = self.max_context - 1
        if len(ids) <= limit:
            return ids
        logger.warning(
            "prompt (%d tokens) exceeds max_context %d; dropping the oldest "
            "%d tokens and keeping the newest %d",
            len(ids), self.max_context, len(ids) - limit, limit)
        return ids[-limit:]

    def encode_prompt(self, prompt: str, add_bos: bool = True) -> list[int]:
        ids = self.tokenizer.encode(prompt, add_special_tokens=False)
        if add_bos and self.bos_token_id is not None and \
                (not ids or ids[0] != self.bos_token_id) and \
                self.config.arch in ("llama", "mistral"):
            ids = [self.bos_token_id] + ids
        return ids

    def apply_chat_template(self, conversation: Conversation) -> str:
        return self.chat_template.apply(conversation)

    def generate_stream(self, prompt: Optional[str] = None, *,
                        token_ids: Optional[Sequence[int]] = None,
                        config: Optional[GenerationConfig] = None,
                        cancellation: Optional[CancellationToken] = None,
                        emit_prompt: bool = False,
                        stats: Optional[GenerationStats] = None,
                        ) -> Iterator[StreamedToken]:
        """Token-streaming generation (cf. generator.rs:183,228).

        `stats` times the prefill up to the first generated token read back
        (so the card's prefill is in it) and the decode from there."""
        with profiling.annotate("kjarni.stream.request") as span:
            gen = config or GenerationConfig()
            stats = stats or GenerationStats()
            with profiling.annotate("kjarni.stream.start"):
                ids, history, generator = self._start(gen, prompt, token_ids)
                stats.start()
                ck, cv = self._ensure_cache()
            prompt_len = len(ids)
            read = False

            def first_read():   # the first token is on the host: the prefill is done
                nonlocal read
                read = True
                stats.mark_prefill(prompt_len)
                if span:
                    span.count(first_token_ns=time.perf_counter_ns())

            logits, ck, cv, _ = self._prefill_with_reuse(ids, ck, cv)
            if emit_prompt:
                for t in ids:
                    yield StreamedToken(self.tokenizer.decode([t], False), t,
                                        TokenType.PROMPT)
            max_new = gen.max_new_tokens if gen.max_new_tokens is not None else \
                max(gen.max_length - prompt_len, 0)
            sdec = StreamDecoder(self.tokenizer)
            emitted: list[int] = []
            try:
                for t in self._decode(logits, ck, cv, history, prompt_len, gen,
                                      generator, max_new, cancellation, first_read):
                    emitted.append(t)
                    yield StreamedToken(sdec.push(t), t, TokenType.GENERATED)
            finally:
                self._session_ids = ids + emitted
                if not read:
                    stats.mark_prefill(prompt_len)
                stats.mark_decode_done(len(emitted))
                stats.print_summary()

    def generate(self, prompt: Optional[str] = None, *,
                 token_ids: Optional[Sequence[int]] = None,
                 config: Optional[GenerationConfig] = None,
                 cancellation: Optional[CancellationToken] = None,
                 fused: bool = True) -> str:
        """Blocking generation returning the full completion. fused=False, or
        a cancellation token, takes the streaming loop, as in the JAX package."""
        if not fused or cancellation is not None:
            return "".join(st.text for st in self.generate_stream(
                prompt, token_ids=token_ids, config=config,
                cancellation=cancellation))
        gen = config or GenerationConfig()
        ids, history, generator = self._start(gen, prompt, token_ids)
        prompt_len = len(ids)
        ck, cv = self._ensure_cache()
        logits, ck, cv, _ = self._prefill_with_reuse(ids, ck, cv)
        max_new = gen.max_new_tokens if gen.max_new_tokens is not None else \
            max(gen.max_length - prompt_len, 0)
        max_steps = max(min(max_new, self.max_context - prompt_len - 1,
                            gen.max_length - prompt_len), 0)
        toks = list(self._decode(logits, ck, cv, history, prompt_len, gen,
                                 generator, max_steps))
        self._session_ids = ids + toks
        return self.tokenizer.decode(toks, skip_special_tokens=True)

    def _shared_batch_prefix(self, ids_list: list) -> int:
        """Longest token prefix common to every row (each row keeps at least
        one suffix token); 0 below _min_reuse_prefix tokens."""
        if len(ids_list) < 2:
            return 0
        first = ids_list[0]
        limit = min(len(r) for r in ids_list) - 1
        p = 0
        while p < limit and all(r[p] == first[p] for r in ids_list):
            p += 1
        return p if p >= self._min_reuse_prefix else 0

    def _prefix_fill(self, ids_p: list):
        """Prefill a shared prompt prefix once at B = 1, padded to its seq
        bucket (the padding's K/V lies past the prefix and is never copied),
        and return that cache for broadcast into the batch cache."""
        pb = seq_bucket(len(ids_p), self.max_context)
        ck, cv = self._new_cache(1, pb)
        ids = torch.zeros((1, pb), dtype=torch.long)
        ids[0, :len(ids_p)] = torch.tensor(ids_p, dtype=torch.long)
        self.family.forward(self.params, self.config, ids.to(self.device), ck, cv, 0,
                            pb - 1, **self.fwd_kw)
        return ck, cv

    @torch.inference_mode()
    def _batch_prefill(self, ids_list: list, P: int, bucket: int, slots: int):
        """The batch's prefill over a fresh [B, slots] cache: each row's
        suffix after the shared P-token prefix, left-padded to `bucket` at
        cache slots P..P+bucket, with per-row RoPE positions and a pad mask
        over the slots. Returns (logits [B, V], ck, cv, pad_mask [B, slots])."""
        B = len(ids_list)
        ids = torch.zeros((B, bucket), dtype=torch.long)
        positions = torch.zeros((B, bucket), dtype=torch.long)
        pad_mask = torch.zeros((B, slots), dtype=torch.long)
        pad_mask[:, :P] = 1       # shared-prefix slots are real for all rows
        for r, row in enumerate(ids_list):
            sfx = row[P:]
            pad = bucket - len(sfx)
            ids[r, pad:] = torch.tensor(sfx, dtype=torch.long)
            positions[r, pad:] = P + torch.arange(len(sfx))
            pad_mask[r, P + pad:P + bucket] = 1
        pad_mask[:, P + bucket:] = 1  # decode slots are always real
        pad_mask = pad_mask.to(self.device)
        ck, cv = self._new_cache(B, slots)
        if P:
            # the prefix's first P slots into every row; the int8 cache's
            # "s" keeps the position axis at 3 too
            for dst, src in zip((ck, cv), self._prefix_fill(ids_list[0][:P])):
                pairs = zip(dst.values(), src.values()) if isinstance(dst, dict) \
                    else [(dst, src)]
                for d, s_ in pairs:
                    d[:, :, :, :P].copy_(s_[:, :, :, :P])
        logits, _, _ = self.family.forward(
            self.params, self.config, ids.to(self.device), ck, cv, P, bucket - 1,
            positions=positions.to(self.device), pad_mask=pad_mask, **self.fwd_kw)
        return logits, ck, cv, pad_mask

    @torch.inference_mode()
    def generate_batch(self, prompts: Sequence[str], *,
                       config: Optional[GenerationConfig] = None) -> list[str]:
        """Batched generation over ragged prompts (left-padded).

        Greedy output per row equals the unbatched generate() for the same
        prompt. Rows sharing a leading token prefix of >= _min_reuse_prefix
        tokens (a system prompt) prefill it once at B = 1 and broadcast its
        K/V into every row; the batch prefill then computes only the
        suffixes. Decode runs one forward for the whole batch per step,
        reading the cache up to the current _kv_bucket_step bucket; a row
        that samples a stop token is done (it emits nothing more), and the
        loop ends when every row is done. No flash: the padded batch takes
        the plain attention with the pad mask, as in the JAX package.
        """
        gen = config or GenerationConfig()
        if not prompts:
            return []
        ids_list = [self._bound_prompt(self.encode_prompt(p, gen.add_bos_token))
                    for p in prompts]
        B = len(ids_list)
        max_len = max(len(i) for i in ids_list)
        P = self._shared_batch_prefix(ids_list)
        self._batch_prefix_len = P    # observability for tests/stats
        bucket = seq_bucket(max(len(r) - P for r in ids_list), self.max_context - P)
        max_new = gen.max_new_tokens if gen.max_new_tokens is not None else \
            max(gen.max_length - max_len, 0)
        max_steps = int(max(min(max_new, self.max_context - P - bucket - 1), 0))
        self.last_batch_steps = 0     # decode forwards of the last call
        if max_steps == 0:
            return ["" for _ in prompts]
        # the cache lives for this call only: prompt + generation, rounded to
        # 256 slots, not max_context
        slots = min(self.max_context, -(-(P + bucket + max_steps + 1) // 256) * 256)
        logits, ck, cv, pad_mask = self._batch_prefill(ids_list, P, bucket, slots)

        dev = self.device
        history = torch.zeros((B, self.max_context), dtype=torch.long)
        for r, row in enumerate(ids_list):
            history[r, :len(row)] = torch.tensor(row, dtype=torch.long)
        history = history.to(dev)
        lens0_d = torch.tensor([len(r) for r in ids_list], dtype=torch.long, device=dev)
        rows = torch.arange(B, device=dev)
        seed = self.sampling_seed(gen.seed)
        generator = torch.Generator(device=dev).manual_seed(seed)
        stop = torch.tensor(sorted(self.stop_token_ids) or [-1], device=dev)
        greedy = gen.strategy == "greedy"
        pen, ngram = gen.repetition_penalty, gen.no_repeat_ngram_size
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        out = []
        slot0 = P + bucket       # the first decode write slot
        for i in range(max_steps):
            lg = process_logits(logits, history, lens0_d + i, pen, ngram)
            toks = sample_token(lg, generator, gen.sampling, greedy)
            done = done | torch.isin(toks, stop)
            out.append(torch.where(done, -1, toks))
            # lens0 + i < max_context: bucket and max_steps leave room
            history[rows, lens0_d + i] = toks
            if i == max_steps - 1 or bool(done.all()):
                break
            slot = slot0 + i
            kb = self._kv_bucket(slot, slots)
            wk, wv, pm = ck, cv, pad_mask
            if kb is not None:
                wk, wv = slice_working(ck, kb, axis=3), slice_working(cv, kb, axis=3)
                pm = pad_mask[:, :kb]
            logits, _, _ = self.family.forward(
                self.params, self.config, toks[:, None], wk, wv, slot,
                positions=(lens0_d + i)[:, None], pad_mask=pm, **self.fwd_kw)
            self.last_batch_steps += 1
        toks_all = torch.stack(out, dim=1).cpu().tolist()
        return [self.tokenizer.decode([t for t in row if t >= 0],
                                      skip_special_tokens=True) for row in toks_all]

    def default_generation_config(self) -> GenerationConfig:
        """Defaults from the model's generation_config.json: temperature /
        top_p / top_k / repetition_penalty seed the sampling params."""
        g = self.hf_generation_config
        base = GenerationConfig()
        if not g:
            return base
        sp = SamplingParams(
            temperature=g.get("temperature", base.sampling.temperature),
            top_k=g.get("top_k", base.sampling.top_k),
            top_p=g.get("top_p", base.sampling.top_p),
            min_p=g.get("min_p", base.sampling.min_p),
        )
        return dataclasses.replace(
            base,
            sampling=sp,
            repetition_penalty=g.get("repetition_penalty",
                                     base.repetition_penalty),
            strategy="sample" if g.get("do_sample", True) else "greedy",
        )
