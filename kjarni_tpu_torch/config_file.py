"""kjarni.toml configuration system.

Rebuild of kjarni/src/{kjarni_config,kjarni_config_loader,kjarni_config_resolve}.rs:
a three-layer resolution chain — kjarni.toml defaults → builder/task options →
explicit per-call overrides, later wins (SURVEY §5.6). Loaded from ./kjarni.toml,
then ~/.config/kjarni/kjarni.toml; stdlib tomllib does the parsing.

A copy of kjarni_tpu/config_file.py (the port imports nothing of the JAX
package); only the CLI reads it. `hardware.device` is parsed and kept, and,
as in the JAX package, the CLI does not read it: the port's CLI takes
`--device`.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from pathlib import Path
from typing import Any, Optional


@dataclasses.dataclass
class DefaultModels:
    """Per-task default model slugs (kjarni_config.rs DefaultModels)."""

    chat: str = "qwen2.5-0.5b-instruct"
    generate: str = "qwen2.5-0.5b-instruct"
    embed: str = "minilm-l6-v2"
    classify: str = "distilbert-sentiment"
    rerank: str = "minilm-l6-v2-cross-encoder"
    summarize: str = "distilbart-cnn"
    translate: str = "flan-t5-base"
    transcribe: str = "whisper-small"


@dataclasses.dataclass
class TaskConfig:
    """Generic per-task section: model + generation knobs."""

    model: Optional[str] = None
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    num_beams: Optional[int] = None
    max_length: Optional[int] = None
    min_length: Optional[int] = None
    system_prompt: Optional[str] = None
    pooling: Optional[str] = None
    normalize: Optional[bool] = None
    chunk_size: Optional[int] = None
    chunk_overlap: Optional[int] = None
    top_k_results: Optional[int] = None
    mode: Optional[str] = None
    language: Optional[str] = None
    timestamps: Optional[bool] = None

    def merged_with(self, overrides: dict[str, Any]) -> "TaskConfig":
        data = dataclasses.asdict(self)
        for k, v in overrides.items():
            if v is not None:
                data[k] = v
        return TaskConfig(**{k: v for k, v in data.items()
                             if k in {f.name for f in dataclasses.fields(TaskConfig)}})


@dataclasses.dataclass
class CacheConfig:
    dir: Optional[str] = None


@dataclasses.dataclass
class HardwareConfig:
    device: str = "auto"       # auto | cpu | tpu
    max_context: Optional[int] = None


@dataclasses.dataclass
class OutputConfig:
    format: str = "text"       # text | json
    quiet: bool = False


@dataclasses.dataclass
class KjarniConfig:
    defaults: DefaultModels = dataclasses.field(default_factory=DefaultModels)
    tasks: dict[str, TaskConfig] = dataclasses.field(default_factory=dict)
    models: dict[str, dict] = dataclasses.field(default_factory=dict)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    hardware: HardwareConfig = dataclasses.field(default_factory=HardwareConfig)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)

    def model_for(self, task: str) -> str:
        tc = self.tasks.get(task)
        if tc and tc.model:
            return tc.model
        return getattr(self.defaults, task, None) or DefaultModels().__dict__[task]

    def task_config(self, task: str) -> TaskConfig:
        return self.tasks.get(task, TaskConfig())

    def model_override(self, model: str) -> dict:
        return self.models.get(model, {})

    def cache_dir(self) -> Path:
        if self.cache.dir:
            return Path(os.path.expanduser(self.cache.dir))
        from .registry import get_default_cache_dir
        return get_default_cache_dir()


_TASK_SECTIONS = ("chat", "generate", "summarize", "translate", "classify",
                  "embed", "rerank", "index", "search", "transcribe")


def _task_config_from(section: dict) -> TaskConfig:
    fields = {f.name for f in dataclasses.fields(TaskConfig)}
    return TaskConfig(**{k: v for k, v in section.items() if k in fields})


def parse_config(data: dict) -> KjarniConfig:
    cfg = KjarniConfig()
    if "defaults" in data:
        d = data["defaults"]
        cfg.defaults = DefaultModels(**{
            k: v for k, v in d.items()
            if k in {f.name for f in dataclasses.fields(DefaultModels)}})
    for task in _TASK_SECTIONS:
        if task in data and isinstance(data[task], dict):
            cfg.tasks[task] = _task_config_from(data[task])
    if "models" in data and isinstance(data["models"], dict):
        cfg.models = {k: dict(v) for k, v in data["models"].items()}
    if "cache" in data:
        cfg.cache = CacheConfig(dir=data["cache"].get("dir"))
    if "hardware" in data:
        h = data["hardware"]
        cfg.hardware = HardwareConfig(device=h.get("device", "auto"),
                                      max_context=h.get("max_context"))
    if "output" in data:
        o = data["output"]
        cfg.output = OutputConfig(format=o.get("format", "text"),
                                  quiet=o.get("quiet", False))
    return cfg


def load_config_from_path(path: Path) -> KjarniConfig:
    with open(path, "rb") as f:
        return parse_config(tomllib.load(f))


def load_config(cwd: Optional[Path] = None) -> KjarniConfig:
    """Search ./kjarni.toml then ~/.config/kjarni/kjarni.toml (loader.rs:8)."""
    candidates = [
        (Path(cwd) if cwd else Path.cwd()) / "kjarni.toml",
        Path.home() / ".config" / "kjarni" / "kjarni.toml",
    ]
    env = os.environ.get("KJARNI_CONFIG")
    if env:
        candidates.insert(0, Path(env))
    for c in candidates:
        if c.exists():
            return load_config_from_path(c)
    return KjarniConfig()
