"""GGUF weights: mmap parser, K-quant dequantization, GGUF->HF name mapping.

Copy of kjarni_tpu/weights/gguf.py (host numpy; cf. the reference's
weights/gguf_loader.rs and the block formats of cpu/kernels/q_common.rs).
Blocks are dequantized once at load into f32 numpy arrays; `llama.load_params`
takes a `GgufWeights` where it takes a `ModelWeights`. BF16 tensors are
widened by a bit shift, so no `ml_dtypes` is needed.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Optional

import numpy as np

from ..core.errors import WeightLoadError

GGUF_MAGIC = 0x46554747  # "GGUF"
QK_K = 256

# ggml tensor types (subset)
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q8_0 = 8
GGML_Q4_K = 12
GGML_Q5_K = 13
GGML_Q6_K = 14
GGML_BF16 = 30

_TYPE_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_Q4_0: "Q4_0",
               GGML_Q8_0: "Q8_0", GGML_Q4_K: "Q4_K", GGML_Q5_K: "Q5_K",
               GGML_Q6_K: "Q6_K", GGML_BF16: "BF16"}

_BLOCK_SIZES = {  # (elements per block, bytes per block)
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_Q4_0: (32, 18), GGML_Q8_0: (32, 34),
    GGML_Q4_K: (QK_K, 144), GGML_Q5_K: (QK_K, 176), GGML_Q6_K: (QK_K, 210),
}

# GGUF metadata value types
_GGUF_TYPES = {
    0: ("<B", 1), 1: ("<b", 1), 2: ("<H", 2), 3: ("<h", 2), 4: ("<I", 4),
    5: ("<i", 4), 6: ("<f", 4), 7: ("<?", 1), 10: ("<Q", 8), 11: ("<q", 8),
    12: ("<d", 8),
}


class _Reader:
    def __init__(self, data: np.memmap):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def string(self) -> str:
        n = self.u64()
        return self.read(n).decode("utf-8", errors="replace")

    def value(self, vtype: int) -> Any:
        if vtype in _GGUF_TYPES:
            fmt, size = _GGUF_TYPES[vtype]
            return struct.unpack(fmt, self.read(size))[0]
        if vtype == 8:  # string
            return self.string()
        if vtype == 9:  # array
            elem_type = self.u32()
            n = self.u64()
            return [self.value(elem_type) for _ in range(n)]
        raise WeightLoadError(f"unknown GGUF metadata type {vtype}")


class GgufFile:
    """Parsed GGUF container: metadata dict + lazy dequantized tensors."""

    def __init__(self, path: Path):
        self.path = Path(path)
        if not self.path.exists():
            raise WeightLoadError(f"GGUF file not found: {self.path}")
        data = np.memmap(self.path, dtype=np.uint8, mode="r")
        r = _Reader(data)
        if r.u32() != GGUF_MAGIC:
            raise WeightLoadError(f"{self.path} is not a GGUF file")
        self.version = r.u32()
        n_tensors = r.u64()
        n_kv = r.u64()
        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.string()
            vtype = r.u32()
            self.metadata[key] = r.value(vtype)
        self.tensors: dict[str, dict] = {}
        for _ in range(n_tensors):
            name = r.string()
            n_dims = r.u32()
            dims = [r.u64() for _ in range(n_dims)]
            ttype = r.u32()
            offset = r.u64()
            self.tensors[name] = {"dims": dims, "type": ttype, "offset": offset}
        alignment = self.metadata.get("general.alignment", 32)
        self._data_start = (r.pos + alignment - 1) // alignment * alignment
        self._data = data

    def tensor_names(self) -> list[str]:
        return list(self.tensors)

    def tensor_type_name(self, name: str) -> str:
        return _TYPE_NAMES.get(self.tensors[name]["type"], "?")

    def get(self, name: str, dtype=np.float32) -> np.ndarray:
        """Dequantize a tensor to `dtype`.

        GGUF dims are [ne0 (fastest), ne1, ...]; returned numpy shape is
        reversed (row-major), matching torch's [out, in] linear layout.
        """
        info = self.tensors.get(name)
        if info is None:
            raise WeightLoadError(f"tensor '{name}' not in {self.path.name}")
        ttype = info["type"]
        if ttype not in _BLOCK_SIZES:
            raise WeightLoadError(
                f"unsupported ggml type {ttype} for tensor '{name}'")
        n_elems = int(np.prod(info["dims"]))
        elems_per_block, bytes_per_block = _BLOCK_SIZES[ttype]
        n_blocks = n_elems // elems_per_block
        start = self._data_start + info["offset"]
        raw = self._data[start:start + n_blocks * bytes_per_block]
        if ttype == GGML_F32:
            out = raw.view(np.float32).copy()
        elif ttype == GGML_F16:
            out = raw.view(np.float16).astype(np.float32)
        elif ttype == GGML_BF16:
            out = (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        elif ttype == GGML_Q8_0:
            out = dequant_q8_0(raw)
        elif ttype == GGML_Q4_0:
            out = dequant_q4_0(raw)
        elif ttype == GGML_Q4_K:
            out = dequant_q4_k(raw)
        elif ttype == GGML_Q5_K:
            out = dequant_q5_k(raw)
        elif ttype == GGML_Q6_K:
            out = dequant_q6_k(raw)
        else:
            raise WeightLoadError(f"no dequantizer for ggml type {ttype}")
        shape = tuple(reversed(info["dims"]))
        return out[:n_elems].reshape(shape).astype(dtype, copy=False)


# ---------------------------------------------------------------------------
# Vectorized dequantizers (q_common.rs formats, ggml reference semantics)
# ---------------------------------------------------------------------------

def dequant_q8_0(raw: np.ndarray) -> np.ndarray:
    """Q8_0: 34-byte blocks = f16 scale + 32 int8 (q_common.rs:13)."""
    blocks = raw.reshape(-1, 34)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # [n, 1]
    qs = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (d * qs).reshape(-1)


def dequant_q4_0(raw: np.ndarray) -> np.ndarray:
    """Q4_0: 18-byte blocks = f16 scale + 16 bytes of nibbles (x = (q-8)*d)."""
    blocks = raw.reshape(-1, 18)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).astype(np.float32) - 8.0
    hi = (qs >> 4).astype(np.float32) - 8.0
    out = np.concatenate([lo, hi], axis=1)  # [n, 32]: low nibbles then high
    return (d * out).reshape(-1)


def _unpack_q4k_scales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12-byte 6-bit packed scales/mins -> (sc[8], m[8]) per block."""
    s = scales.astype(np.uint16)
    sc = np.empty((scales.shape[0], 8), dtype=np.float32)
    m = np.empty((scales.shape[0], 8), dtype=np.float32)
    for j in range(4):
        sc[:, j] = (s[:, j] & 63).astype(np.float32)
        m[:, j] = (s[:, j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[:, j] = ((s[:, j + 4] & 0x0F) | ((s[:, j - 4] >> 6) << 4)).astype(np.float32)
        m[:, j] = ((s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)).astype(np.float32)
    return sc, m


def dequant_q4_k(raw: np.ndarray) -> np.ndarray:
    """Q4_K: 144-byte super-blocks of 256 (q_common.rs:35).

    Layout: d (f16), dmin (f16), scales[12], qs[128]. Each 64-element chunk
    uses two 6-bit (scale, min) pairs: 32 low nibbles then 32 high nibbles.
    """
    blocks = raw.reshape(-1, 144)
    n = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)      # [n,1]
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)   # [n,1]
    sc, mi = _unpack_q4k_scales(blocks[:, 4:16])
    qs = blocks[:, 16:144].reshape(n, 4, 32)  # 4 chunks of 32 bytes
    lo = (qs & 0x0F).astype(np.float32)   # sub-block 2j
    hi = (qs >> 4).astype(np.float32)     # sub-block 2j+1
    out = np.empty((n, 8, 32), dtype=np.float32)
    for c in range(4):
        out[:, 2 * c] = d * sc[:, 2 * c:2 * c + 1] * lo[:, c] \
            - dmin * mi[:, 2 * c:2 * c + 1]
        out[:, 2 * c + 1] = d * sc[:, 2 * c + 1:2 * c + 2] * hi[:, c] \
            - dmin * mi[:, 2 * c + 1:2 * c + 2]
    return out.reshape(-1)


def dequant_q5_k(raw: np.ndarray) -> np.ndarray:
    """Q5_K: 176-byte super-blocks (DType::Q5_K, tensor/dtype.rs:6).

    Layout: d (f16), dmin (f16), scales[12], qh[32] (5th bits), qs[128]
    (low nibbles). q = nibble + (qh bit ? 16 : 0), y = d*sc*q - dmin*m; the
    qh bit pair advances by 2 per 64-element chunk.
    """
    blocks = raw.reshape(-1, 176)
    n = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mi = _unpack_q4k_scales(blocks[:, 4:16])
    qh = blocks[:, 16:48]            # [n, 32]
    qs = blocks[:, 48:176].reshape(n, 4, 32)  # 4 chunks of 32 bytes
    out = np.empty((n, 8, 32), dtype=np.float32)
    for c in range(4):
        u1 = np.uint8(1 << (2 * c))
        u2 = np.uint8(2 << (2 * c))
        lo = (qs[:, c] & 0x0F).astype(np.float32) +             np.where((qh & u1) != 0, 16.0, 0.0)
        hi = (qs[:, c] >> 4).astype(np.float32) +             np.where((qh & u2) != 0, 16.0, 0.0)
        out[:, 2 * c] = d * sc[:, 2 * c:2 * c + 1] * lo             - dmin * mi[:, 2 * c:2 * c + 1]
        out[:, 2 * c + 1] = d * sc[:, 2 * c + 1:2 * c + 2] * hi             - dmin * mi[:, 2 * c + 1:2 * c + 2]
    return out.reshape(-1)


def dequant_q6_k(raw: np.ndarray) -> np.ndarray:
    """Q6_K: 210-byte super-blocks (q_common.rs:48).

    Layout: ql[128] (low 4 bits), qh[64] (high 2 bits), scales[16] (int8),
    d (f16). q = (ql | qh<<4) - 32, y = d * scale[sub16] * q.
    """
    blocks = raw.reshape(-1, 210)
    n = blocks.shape[0]
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    scales = blocks[:, 192:208].view(np.int8).astype(np.float32)  # [n, 16]
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)  # [n,1]

    out = np.empty((n, 256), dtype=np.float32)
    for half in range(2):  # each half: ql[64*half:64*half+64], qh[32*half:...]
        ql_h = ql[:, 64 * half:64 * half + 64]
        qh_h = qh[:, 32 * half:32 * half + 32]
        sbase = 8 * half
        l = np.arange(32)
        q1 = ((ql_h[:, :32] & 0x0F) | ((qh_h & 0x03) << 4)).astype(np.int8) - 32
        q2 = ((ql_h[:, 32:] & 0x0F) | (((qh_h >> 2) & 0x03) << 4)).astype(np.int8) - 32
        q3 = ((ql_h[:, :32] >> 4) | (((qh_h >> 4) & 0x03) << 4)).astype(np.int8) - 32
        q4 = ((ql_h[:, 32:] >> 4) | (((qh_h >> 6) & 0x03) << 4)).astype(np.int8) - 32
        idx = l // 16  # 0 or 1 within each 32
        base = 128 * half
        for part, q in enumerate((q1, q2, q3, q4)):
            s = scales[:, sbase + 2 * part + idx]  # [n, 32]
            out[:, base + 32 * part: base + 32 * part + 32] = \
                d * s * q.astype(np.float32)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# GGUF -> HF mapping (gguf_conversion.rs)
# ---------------------------------------------------------------------------

_NAME_MAP = {
    "token_embd.weight": "model.embed_tokens.weight",
    "output_norm.weight": "model.norm.weight",
    "output.weight": "lm_head.weight",
}

_LAYER_MAP = {
    "attn_q.weight": "self_attn.q_proj.weight",
    "attn_q.bias": "self_attn.q_proj.bias",
    "attn_k.weight": "self_attn.k_proj.weight",
    "attn_k.bias": "self_attn.k_proj.bias",
    "attn_v.weight": "self_attn.v_proj.weight",
    "attn_v.bias": "self_attn.v_proj.bias",
    "attn_output.weight": "self_attn.o_proj.weight",
    "attn_norm.weight": "input_layernorm.weight",
    "ffn_gate.weight": "mlp.gate_proj.weight",
    "ffn_up.weight": "mlp.up_proj.weight",
    "ffn_down.weight": "mlp.down_proj.weight",
    "ffn_norm.weight": "post_attention_layernorm.weight",
    "attn_qkv.weight": "self_attn.qkv_proj.weight",
}


def gguf_to_hf_name(name: str) -> Optional[str]:
    """blk.{i}.attn_q.weight -> model.layers.{i}.self_attn.q_proj.weight ..."""
    if name in _NAME_MAP:
        return _NAME_MAP[name]
    if name.startswith("blk."):
        _, idx, rest = name.split(".", 2)
        mapped = _LAYER_MAP.get(rest)
        if mapped:
            return f"model.layers.{idx}.{mapped}"
    return None


class GgufWeights:
    """ModelWeights-compatible adapter: HF-named access over a GGUF file."""

    def __init__(self, path: Path):
        self.gguf = GgufFile(path)
        self._hf_to_gguf: dict[str, str] = {}
        for gname in self.gguf.tensor_names():
            hf = gguf_to_hf_name(gname)
            if hf:
                self._hf_to_gguf[hf] = gname

    @property
    def metadata(self) -> dict:
        return self.gguf.metadata

    def __contains__(self, name: str) -> bool:
        return name in self._hf_to_gguf

    def keys(self):
        return iter(self._hf_to_gguf)

    def get(self, name: str) -> np.ndarray:
        gname = self._hf_to_gguf.get(name)
        if gname is None:
            raise WeightLoadError(f"tensor '{name}' not mapped from GGUF")
        return self.gguf.get(gname)

    def get_f32(self, name: str) -> np.ndarray:
        return self.get(name).astype(np.float32)

    def has_any(self, *names: str) -> bool:
        return any(n in self for n in names)

    def hf_config(self) -> dict:
        """Synthesize an HF-style config dict from GGUF metadata
        (gguf_loader.rs GgufHfMapper)."""
        md = self.gguf.metadata
        arch = md.get("general.architecture", "llama")

        def g(key, default=None):
            return md.get(f"{arch}.{key}", default)

        n_heads = g("attention.head_count", 32)
        eos = md.get("tokenizer.ggml.eos_token_id")
        bos = md.get("tokenizer.ggml.bos_token_id")
        vocab = g("vocab_size")
        if vocab is None:
            toks = md.get("tokenizer.ggml.tokens")
            vocab = len(toks) if toks else None
        if vocab is None and "model.embed_tokens.weight" in self:
            vocab = self.gguf.tensors[self._hf_to_gguf[
                "model.embed_tokens.weight"]]["dims"][1]
        cfg = {
            "model_type": {"llama": "llama", "qwen2": "qwen2",
                           "mistral": "mistral", "phi3": "phi3"}.get(arch, arch),
            "vocab_size": vocab,
            "hidden_size": g("embedding_length"),
            "num_hidden_layers": g("block_count"),
            "num_attention_heads": n_heads,
            "num_key_value_heads": g("attention.head_count_kv", n_heads),
            "intermediate_size": g("feed_forward_length"),
            "max_position_embeddings": g("context_length", 4096),
            "rms_norm_eps": g("attention.layer_norm_rms_epsilon", 1e-6),
            "rope_theta": g("rope.freq_base", 10000.0),
            "tie_word_embeddings": "lm_head.weight" not in self,
        }
        if eos is not None:
            cfg["eos_token_id"] = eos
        if bos is not None:
            cfg["bos_token_id"] = bos
        return cfg
