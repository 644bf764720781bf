"""Shared task-API infrastructure.

Rebuild of kjarni/src/common/{device,download,load_config}.rs: device resolution,
download policy, and the model-resolution path every task constructor shares.
"""

from __future__ import annotations

import enum
from pathlib import Path
from typing import Optional

from ..core.errors import TaskValidationError
from ..core.metadata import Device
from ..registry import (ModelInfo, ModelTask, ensure_model_files, resolve)


class DownloadPolicy(str, enum.Enum):
    """Cf. common/device.rs:57 DownloadPolicy."""

    ALLOW = "allow"
    OFFLINE = "offline"


def resolve_model_dir(model: str, cache_dir: Optional[Path] = None,
                      download_policy: DownloadPolicy = DownloadPolicy.ALLOW,
                      quiet: bool = False,
                      allowed_tasks: Optional[tuple[ModelTask, ...]] = None,
                      task_name: str = "task") -> tuple[Path, Optional[ModelInfo]]:
    """Resolve a model name or local path to a model directory.

    Local paths containing config.json are loaded directly (cf.
    from_pretrained paths in the reference); registry names go through
    validation + cache/download.
    """
    p = Path(model)
    if p.exists() and (p / "config.json").exists():
        return p, None

    info = resolve(model)
    if allowed_tasks is not None and info.task not in allowed_tasks:
        raise TaskValidationError(
            f"Model '{info.cli_name}' (task: {info.task.value}) is not compatible with "
            f"{task_name}. Compatible tasks: {[t.value for t in allowed_tasks]}")
    d = ensure_model_files(info, cache_dir,
                           allow_download=download_policy == DownloadPolicy.ALLOW,
                           quiet=quiet)
    return d, info


__all__ = ["Device", "DownloadPolicy", "resolve_model_dir"]
