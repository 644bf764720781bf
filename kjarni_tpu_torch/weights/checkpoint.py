"""Native checkpoint: save and restore prepared param trees (port of
kjarni_tpu/weights/checkpoint.py in a torch-native format).

After the HF/GGUF weights are mapped into the stacked param dict (transposed,
split, dequantized, and quantized to int4 or int8 when asked), the prepared
tree is saved under <model_dir>/kjarni_ckpt/params.pt with `torch.save`, so
the next load skips all host-side preprocessing and reads straight onto the
target device. Storage sharing survives the round trip: a tied lm_head stays
a view of the embedding table.

The JAX package writes the same directory name with Orbax, which cannot be
read without JAX: such a directory raises an InvalidConfigError that names
this module's `convert_model`.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Optional

import torch

from ..core.errors import InvalidConfigError

CHECKPOINT_DIR = "kjarni_ckpt"
PARAMS_FILE = "params.pt"


def save_checkpoint(params: Any, model_dir: Path) -> Path:
    """Persist a prepared param tree under <model_dir>/kjarni_ckpt."""
    target = Path(model_dir) / CHECKPOINT_DIR
    if target.exists():
        shutil.rmtree(target)
    target.mkdir(parents=True)
    tmp = target / (PARAMS_FILE + ".tmp")
    torch.save(params, tmp)
    tmp.replace(target / PARAMS_FILE)
    return target


def load_checkpoint(model_dir: Path, device: torch.device | str = "cpu") -> Optional[Any]:
    """Restore a prepared param tree onto `device`, or None if absent."""
    target = Path(model_dir) / CHECKPOINT_DIR
    if not target.exists():
        return None
    path = target / PARAMS_FILE
    if not path.exists():
        raise InvalidConfigError(
            f"the native checkpoint {target} was not written by kjarni_tpu_torch "
            f"(the JAX package writes Orbax, which needs JAX to read); make one "
            f"from the HF or GGUF model dir with "
            f"kjarni_tpu_torch.weights.checkpoint.convert_model(model_dir, out_dir)")
    return torch.load(path, map_location=device, weights_only=True, mmap=True)


def has_checkpoint(model_dir: Path) -> bool:
    return (Path(model_dir) / CHECKPOINT_DIR).exists()


def convert_model(model_dir: Path, out_dir: Path, *, dtype="auto",
                  max_context: Optional[int] = None,
                  quantize: Optional[str] = None, device=None) -> Path:
    """Convert an HF/GGUF model dir into a fast-loading native checkpoint dir.

    Copies config/tokenizer, maps the weights once on `device` (None: the
    card), saves the prepared tree. The result loads through DecoderLM
    without re-mapping.
    """
    from ..models.decoder_lm import DecoderLM

    model_dir = Path(model_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lm = DecoderLM(model_dir, dtype=dtype, max_context=max_context,
                   quantize=quantize, device=device)
    for name in ("config.json", "tokenizer.json", "generation_config.json"):
        src = model_dir / name
        if src.exists():
            shutil.copy(src, out_dir / name)
    if not (out_dir / "config.json").exists():
        (out_dir / "config.json").write_text(json.dumps(lm.hf_config))
    save_checkpoint(lm.params, out_dir)
    return out_dir
