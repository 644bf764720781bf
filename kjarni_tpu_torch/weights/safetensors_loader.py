"""Zero-copy mmap-backed safetensors loading into torch tensors.

Copy of kjarni_tpu/weights/safetensors_loader.py. The format is parsed by hand
(8-byte little-endian header length, JSON header, raw buffer) and each tensor
is a torch view into one shared copy-on-write np.memmap, so loading costs no
host copies until a tensor is moved to its device. bf16 is read as
`torch.bfloat16` directly: no `ml_dtypes`, and no f32 round trip.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from ..core.errors import WeightLoadError

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
    "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}


def _open_file(path: Path) -> tuple[dict, np.memmap]:
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(header_len))
    # "c" (copy-on-write) keeps the file read-only while torch, which wants
    # writable buffers, can wrap the pages
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + header_len)
    return header, data


class SafeTensorsFile:
    """One mmap'd .safetensors file; tensors are lazy zero-copy views."""

    def __init__(self, path: Path):
        self.path = Path(path)
        if not self.path.exists():
            raise WeightLoadError(f"weights file not found: {self.path}")
        self._header, self._data = _open_file(self.path)

    def keys(self) -> list[str]:
        return [k for k in self._header if k != "__metadata__"]

    def get(self, name: str) -> torch.Tensor:
        info = self._header.get(name)
        if info is None:
            raise WeightLoadError(f"tensor '{name}' not found in {self.path.name}")
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise WeightLoadError(f"unsupported safetensors dtype {info['dtype']}")
        start, end = info["data_offsets"]
        buf = torch.from_numpy(self._data[start:end])
        if start % dtype.itemsize:
            buf = buf.clone()  # a misaligned view cannot be reinterpreted
        return buf.view(dtype).reshape(info["shape"])


class ModelWeights:
    """Facade over single-file or sharded safetensors (cf. model_weights.rs:31)."""

    def __init__(self, model_dir: Path):
        model_dir = Path(model_dir)
        self.model_dir = model_dir
        self._files: dict[str, SafeTensorsFile] = {}
        self._tensor_to_file: dict[str, str] = {}

        index = model_dir / "model.safetensors.index.json"
        single = model_dir / "model.safetensors"
        if index.exists():
            idx = json.loads(index.read_text())
            for tensor, shard in idx["weight_map"].items():
                self._tensor_to_file[tensor] = shard
            for shard in set(idx["weight_map"].values()):
                self._files[shard] = SafeTensorsFile(model_dir / shard)
        elif single.exists():
            f = SafeTensorsFile(single)
            self._files["model.safetensors"] = f
            for k in f.keys():
                self._tensor_to_file[k] = "model.safetensors"
        else:
            shards = sorted(model_dir.glob("*.safetensors"))
            if not shards:
                raise WeightLoadError(f"no safetensors weights found in {model_dir}")
            for p in shards:
                f = SafeTensorsFile(p)
                self._files[p.name] = f
                for k in f.keys():
                    self._tensor_to_file[k] = p.name

    def __contains__(self, name: str) -> bool:
        return name in self._tensor_to_file

    def get(self, name: str) -> torch.Tensor:
        shard = self._tensor_to_file.get(name)
        if shard is None:
            raise WeightLoadError(
                f"tensor '{name}' not found in {self.model_dir} "
                f"(have {len(self._tensor_to_file)} tensors)")
        return self._files[shard].get(name)

    def get_f32(self, name: str) -> np.ndarray:
        """The tensor as a host numpy f32 array, as the JAX package's get_f32."""
        return self.get(name).float().numpy()

    def has_any(self, *names: str) -> bool:
        return any(n in self for n in names)


def save_file(tensors: dict[str, torch.Tensor], path: Path) -> None:
    """Write CPU tensors as one .safetensors file (the inverse of the parser
    above; needs no `safetensors` package)."""
    names = {v: k for k, v in _DTYPES.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy().data)
