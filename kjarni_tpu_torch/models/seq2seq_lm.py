"""Seq2SeqLM: a loaded encoder-decoder model (BART or T5) with beam-search
generation (port of kjarni_tpu/models/seq2seq_lm.py).

The model_type dispatch, the task parameters from the HF config's
task_specific_params, and two loops over one decode step: the device loop
(generate/beam_fused.py) when no stream callback is given, and the host loop
(generate/beam.py) with one. Each decode step first reorders the self-cache
by the beam parents (`reorder_cache`, an index_select on the beam axis: a
copy of the whole cache).

`dtype="auto"` is bf16 on the card and f32 on the CPU. No hand-written kernel
lies on this path, so f32 is also taken on the card.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..core.bucketing import seq_bucket
from ..core.errors import InvalidConfigError
from ..generate.beam import BeamSearchConfig, beam_search
from ..generate.beam_fused import build_fused_beam
from ..tokenizer import KjarniTokenizer
from ..weights.safetensors_loader import ModelWeights
from . import bart as kbart
from . import t5 as kt5
from .decoder_lm import auto_dtype, resolve_device

DEFAULT_MAX_DECODE = 512


@dataclasses.dataclass
class Seq2SeqTaskParams:
    """Parsed task_specific_params (cf. config.rs:5 SummarizationParams)."""

    early_stopping: bool = True
    length_penalty: float = 2.0
    max_length: int = 142
    min_length: int = 0
    no_repeat_ngram_size: int = 3
    num_beams: int = 4
    prefix: Optional[str] = None


def reorder_cache(cache: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """The [L, k, H, T, D] self-cache with beam b taking parent[b]'s rows."""
    return cache.index_select(1, parents)


class Seq2SeqLM:
    """An encoder-decoder LM ready for generation."""

    def __init__(self, model_dir: Path, dtype="auto",
                 max_decode_len: int = DEFAULT_MAX_DECODE, device=None):
        self.device = resolve_device(device)
        dtype = auto_dtype(dtype, self.device)
        model_dir = Path(model_dir)
        self.model_dir = model_dir
        hf_cfg = json.loads((model_dir / "config.json").read_text())
        self.hf_config = hf_cfg
        mt = hf_cfg.get("model_type")
        if mt == "t5":
            self.family = kt5
            self.config = kt5.T5Config.from_hf(hf_cfg)
        elif mt == "bart":
            self.family = kbart
            self.config = kbart.BartConfig.from_hf(hf_cfg)
        else:
            raise InvalidConfigError(f"unsupported seq2seq model_type '{mt}'")
        cfg = self.config
        self.max_decode_len = max_decode_len
        if mt == "bart":
            self.max_decode_len = min(max_decode_len,
                                      cfg.max_position_embeddings - kbart.POSITION_OFFSET)
        self.params = self.family.load_params(ModelWeights(model_dir), cfg, dtype,
                                              self.device)
        self.tokenizer = KjarniTokenizer.from_file(model_dir / "tokenizer.json",
                                                   pad_token_id=cfg.pad_token_id)
        self.task_params = self._parse_task_params(hf_cfg)

    @property
    def dtype(self) -> torch.dtype:
        return self.params["shared"].dtype

    @staticmethod
    def _parse_task_params(hf_cfg: dict) -> dict[str, Seq2SeqTaskParams]:
        out: dict[str, Seq2SeqTaskParams] = {}
        for name, raw in (hf_cfg.get("task_specific_params") or {}).items():
            if not isinstance(raw, dict):
                continue
            out[name] = Seq2SeqTaskParams(
                early_stopping=raw.get("early_stopping", True),
                length_penalty=raw.get("length_penalty", 2.0),
                max_length=raw.get("max_length", 142),
                min_length=raw.get("min_length", 0),
                no_repeat_ngram_size=raw.get("no_repeat_ngram_size", 3),
                num_beams=raw.get("num_beams", 4),
                prefix=raw.get("prefix"),
            )
        return out

    # ------------------------------------------------------------------

    def _encode_input(self, text: str, max_input_len: Optional[int] = None):
        limit = max_input_len
        if self.family is kbart:
            hard = self.config.max_position_embeddings - kbart.POSITION_OFFSET
            limit = min(limit or hard, hard)
        ids, mask = self.tokenizer.encode_batch([text], max_len=limit)
        return (torch.from_numpy(np.asarray(ids, np.int64)).to(self.device),
                torch.from_numpy(np.asarray(mask, np.int64)).to(self.device))

    def _encode_and_cross(self, ids: torch.Tensor, mask: torch.Tensor):
        enc = self.family.encode(self.params, self.config, ids, mask)
        ck, cv = self.family.precompute_cross_kv(self.params, self.config, enc)
        return enc, ck, cv

    def _step(self, ids, sk, sv, ck, cv, enc_mask, pos: int, parents):
        """Reorder the self-cache by beam parent (identity when parents ==
        arange), then decode -> (last logits [k, V], sk, sv)."""
        sk = reorder_cache(sk, parents)
        sv = reorder_cache(sv, parents)
        logits, sk, sv = self.family.decode_step(self.params, self.config, ids, sk, sv,
                                                 ck, cv, enc_mask, pos)
        return logits[:, -1, :], sk, sv

    def beam_config(self, *, num_beams: Optional[int] = None,
                    max_length: Optional[int] = None,
                    min_length: Optional[int] = None,
                    length_penalty: Optional[float] = None,
                    no_repeat_ngram_size: Optional[int] = None,
                    early_stopping: Optional[bool] = None,
                    task: Optional[str] = None) -> tuple[BeamSearchConfig, Optional[str]]:
        """The beam config of one call and the task's text prefix: overrides,
        else the task's parameters when `task` names one, else defaults."""
        tp = self.task_params.get(task) if task else None
        tp = tp or Seq2SeqTaskParams()
        cfg = self.config
        return BeamSearchConfig(
            num_beams=num_beams if num_beams is not None else tp.num_beams,
            max_length=min(max_length if max_length is not None else tp.max_length,
                           self.max_decode_len - 1),
            min_length=min_length if min_length is not None else tp.min_length,
            length_penalty=length_penalty if length_penalty is not None
            else tp.length_penalty,
            early_stopping=early_stopping if early_stopping is not None
            else tp.early_stopping,
            no_repeat_ngram_size=no_repeat_ngram_size if no_repeat_ngram_size
            is not None else tp.no_repeat_ngram_size,
            eos_token_id=cfg.eos_token_id,
            decoder_start_token_id=cfg.decoder_start_token_id,
            forced_bos_token_id=getattr(cfg, "forced_bos_token_id", None),
            forced_eos_token_id=getattr(cfg, "forced_eos_token_id", None),
        ), tp.prefix

    def generate(self, text: str, *,
                 num_beams: Optional[int] = None,
                 max_length: Optional[int] = None,
                 min_length: Optional[int] = None,
                 length_penalty: Optional[float] = None,
                 no_repeat_ngram_size: Optional[int] = None,
                 early_stopping: Optional[bool] = None,
                 task: Optional[str] = None,
                 max_input_len: Optional[int] = None,
                 stream_callback: Optional[Callable[[int], None]] = None) -> str:
        """Beam-search generation (cf. generator.rs:143 generate->run_beam_search).

        Defaults resolve from the model's task_specific_params when `task`
        matches (e.g. "summarization"), else library defaults.
        """
        bs_cfg, prefix = self.beam_config(
            num_beams=num_beams, max_length=max_length, min_length=min_length,
            length_penalty=length_penalty, no_repeat_ngram_size=no_repeat_ngram_size,
            early_stopping=early_stopping, task=task)
        if prefix:
            text = prefix + text
        enc_ids, enc_mask = self._encode_input(text, max_input_len)
        if stream_callback is None:
            toks = self._generate_fused(bs_cfg, enc_ids, enc_mask)
        else:
            toks = self._generate_host(bs_cfg, enc_ids, enc_mask, stream_callback)
        return self.tokenizer.decode(toks, skip_special_tokens=True).strip()

    def _beam_state(self, bs_cfg: BeamSearchConfig, enc_ids, enc_mask):
        """Cross-K/V and mask tiled across the k beams, and a fresh self-cache
        of seq_bucket(max_length + 1) slots."""
        k = bs_cfg.num_beams
        _, ck, cv = self._encode_and_cross(enc_ids, enc_mask)
        ck = ck.repeat_interleave(k, dim=1)
        cv = cv.repeat_interleave(k, dim=1)
        mask = enc_mask.repeat_interleave(k, dim=0)
        cache_len = seq_bucket(bs_cfg.max_length + 1, self.max_decode_len)
        sk, sv = self.family.init_self_cache(self.config, k, cache_len, self.dtype,
                                             self.device)
        return ck, cv, mask, sk, sv

    @torch.inference_mode()
    def _generate_host(self, bs_cfg: BeamSearchConfig, enc_ids, enc_mask,
                       stream_callback: Optional[Callable[[int], None]] = None
                       ) -> list[int]:
        """The host loop (generate/beam.py) over the same decode step."""
        ck, cv, mask, sk, sv = self._beam_state(bs_cfg, enc_ids, enc_mask)
        state = {"sk": sk, "sv": sv}

        def step_fn(tokens: np.ndarray, pos: int, parents: np.ndarray):
            ids = torch.from_numpy(np.asarray(tokens, np.int64)[:, None]).to(self.device)
            logits, state["sk"], state["sv"] = self._step(
                ids, state["sk"], state["sv"], ck, cv, mask, pos,
                torch.from_numpy(np.asarray(parents, np.int64)).to(self.device))
            return logits.float().cpu().numpy()

        return beam_search(step_fn, bs_cfg, stream_callback).tokens

    @torch.inference_mode()
    def _generate_fused(self, bs_cfg: BeamSearchConfig, enc_ids, enc_mask
                        ) -> list[int]:
        """Whole beam generation (encode + cross-K/V + the device beam loop);
        the host reads one stop flag per step and the tokens at the end."""
        cache_len = seq_bucket(bs_cfg.max_length + 1, self.max_decode_len)
        ck, cv, mask, sk, sv = self._beam_state(bs_cfg, enc_ids, enc_mask)

        def decode_fn(cur, sk, sv, pos, parents):
            return self._step(cur, sk, sv, ck, cv, mask, pos, parents)

        run = build_fused_beam(decode_fn, bs_cfg, self.config.vocab_size, cache_len - 1)
        out, n = run(sk, sv)
        return [int(t) for t in out[:n].cpu()]
