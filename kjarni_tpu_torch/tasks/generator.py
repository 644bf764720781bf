"""Generator task API: raw LLM text generation (port of
kjarni_tpu/tasks/generator.py; cf. kjarni/src/generator/model.rs:28)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

from ..core.cancellation import CancellationToken
from ..generate.sampling import GenerationConfig, SamplingParams
from ..generate.stream import StreamedToken
from ..generate.speculative import SpeculativeGenerator
from ..models.decoder_lm import DecoderLM
from ..registry import ModelTask
from .common import Device, DownloadPolicy, resolve_model_dir

_GENERATOR_TASKS = (ModelTask.CHAT, ModelTask.REASONING, ModelTask.GENERATION)

# Generation presets (cf. kjarni/src/generation/overrides.rs:48-67)
PRESETS: dict[str, GenerationConfig] = {
    "greedy": GenerationConfig(strategy="greedy"),
    "creative": GenerationConfig(strategy="sample", sampling=SamplingParams(
        temperature=1.0, top_k=None, top_p=0.95, min_p=None)),
    "precise": GenerationConfig(strategy="sample", sampling=SamplingParams(
        temperature=0.3, top_k=20, top_p=0.9, min_p=None)),
    "balanced": GenerationConfig(),
}


def resolve_generation_config(preset: Optional[str] = None,
                              config: Optional[GenerationConfig] = None,
                              model_defaults: Optional[GenerationConfig] = None,
                              **overrides) -> GenerationConfig:
    """model defaults -> preset -> config -> explicit overrides, later wins
    (generation/resolution.rs:10 precedence chain)."""
    if config is not None:
        base = config
    elif preset is not None:
        base = PRESETS[preset]
    else:
        base = model_defaults or GenerationConfig()
    if overrides:
        base = dataclasses.replace(base, **overrides)
    return base


class Generator:
    """Raw text generation task (cf. generator/model.rs:28).

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU.
    """

    def __init__(self, model: str = "qwen2.5-0.5b-instruct", *,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 max_context: Optional[int] = None,
                 dtype: str = "auto",
                 quantize: Optional[str] = None,
                 execution_plan=None,
                 tp: Optional[int] = None,
                 kv_cache: Optional[str] = None,
                 draft_model: Optional[str] = None,
                 draft_num_tokens: int = 4,
                 offline: bool = False,
                 quiet: bool = False):
        self.device = Device.resolve(device)
        policy = DownloadPolicy.OFFLINE if offline else DownloadPolicy.ALLOW
        model_dir, info = resolve_model_dir(
            model, cache_dir, policy, quiet, _GENERATOR_TASKS, "generation")
        self.model_info = info
        self.model_id = info.cli_name if info else str(model)
        self._lm = DecoderLM(model_dir, dtype=dtype, max_context=max_context,
                             quantize=quantize, execution_plan=execution_plan,
                             tp=tp, kv_cache=kv_cache, device=self.device.torch_name)
        # speculative decoding: the generator owns the draft model, so every
        # caller (Chat, serve) gets it (cf. decoder/generator.rs:56)
        self._spec = None
        if draft_model is not None:
            draft_dir, _ = resolve_model_dir(
                draft_model, cache_dir, policy, quiet, _GENERATOR_TASKS, "generation")
            self._spec = SpeculativeGenerator(
                self._lm, DecoderLM(draft_dir, dtype=dtype, max_context=max_context,
                                    device=self.device.torch_name),
                num_tokens=draft_num_tokens)

    @property
    def lm(self) -> DecoderLM:
        return self._lm

    @property
    def speculative(self) -> Optional[SpeculativeGenerator]:
        """The SpeculativeGenerator when a draft model is loaded, else None
        (acceptance telemetry: last_acceptance_rate)."""
        return self._spec

    def _use_spec(self, cfg: GenerationConfig) -> bool:
        # greedy rounds verify exactly; sampled requests keep the plain path
        return self._spec is not None and cfg.strategy == "greedy"

    def generate(self, prompt: str, *, preset: Optional[str] = None,
                 config: Optional[GenerationConfig] = None,
                 cancellation: Optional[CancellationToken] = None,
                 **overrides) -> str:
        cfg = resolve_generation_config(
            preset, config, self._lm.default_generation_config(), **overrides)
        if self._use_spec(cfg):
            return self._spec.generate(prompt, config=cfg, cancellation=cancellation)
        return self._lm.generate(prompt, config=cfg, cancellation=cancellation)

    def generate_batch(self, prompts: list[str], *,
                       preset: Optional[str] = None,
                       config: Optional[GenerationConfig] = None,
                       **overrides) -> list[str]:
        """Batched generation over ragged prompts for aggregate throughput
        (DecoderLM.generate_batch); greedy rows equal generate()'s."""
        cfg = resolve_generation_config(
            preset, config, self._lm.default_generation_config(), **overrides)
        return self._lm.generate_batch(prompts, config=cfg)

    def generate_stream(self, prompt: str, *, preset: Optional[str] = None,
                        config: Optional[GenerationConfig] = None,
                        cancellation: Optional[CancellationToken] = None,
                        **overrides) -> Iterator[StreamedToken]:
        cfg = resolve_generation_config(
            preset, config, self._lm.default_generation_config(), **overrides)
        if self._use_spec(cfg):
            return self._spec.generate_stream(prompt, config=cfg,
                                              cancellation=cancellation)
        return self._lm.generate_stream(prompt, config=cfg, cancellation=cancellation)
