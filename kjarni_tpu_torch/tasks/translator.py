"""Translator task API (port of kjarni_tpu/tasks/translator.py; cf.
kjarni/src/translator/{model,languages}.rs)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..core.errors import TaskValidationError
from .common import Device
from .seq2seq import Seq2SeqGenerator, Seq2SeqOverrides

# Languages known to work well with FLAN-T5 (languages.rs:35 SUPPORTED_LANGUAGES)
SUPPORTED_LANGUAGES = (
    "English", "German", "French", "Spanish", "Italian", "Portuguese",
    "Dutch", "Russian", "Chinese", "Japanese", "Korean", "Arabic",
    "Hindi", "Turkish", "Polish", "Romanian",
)

_CODES = {
    "English": "en", "German": "de", "French": "fr", "Spanish": "es",
    "Italian": "it", "Portuguese": "pt", "Dutch": "nl", "Russian": "ru",
    "Chinese": "zh", "Japanese": "ja", "Korean": "ko", "Arabic": "ar",
    "Hindi": "hi", "Turkish": "tr", "Polish": "pl", "Romanian": "ro",
}

_LANGUAGE_MAP: dict[str, str] = {}
for _name, _code in _CODES.items():
    _LANGUAGE_MAP[_name.lower()] = _name
    _LANGUAGE_MAP[_code] = _name
_LANGUAGE_MAP.update({"eng": "English", "ger": "German", "deu": "German",
                      "fra": "French", "fre": "French", "spa": "Spanish",
                      "ita": "Italian", "por": "Portuguese", "nld": "Dutch",
                      "rus": "Russian", "zho": "Chinese", "jpn": "Japanese",
                      "kor": "Korean", "ara": "Arabic", "hin": "Hindi",
                      "tur": "Turkish", "pol": "Polish", "ron": "Romanian"})


def normalize_language(lang: str) -> Optional[str]:
    """ISO code or name -> canonical name (languages.rs:14)."""
    return _LANGUAGE_MAP.get(lang.lower())


def language_code(canonical: str) -> Optional[str]:
    return _CODES.get(canonical)


def is_supported_language(lang: str) -> bool:
    return normalize_language(lang) is not None


class Translator:
    """`device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU."""

    def __init__(self, model: str = "flan-t5-base", *,
                 default_from: str = "English",
                 default_to: str = "German",
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 offline: bool = False,
                 quiet: bool = False):
        self._gen = Seq2SeqGenerator(model, device=device, cache_dir=cache_dir,
                                     offline=offline, quiet=quiet,
                                     task_name="translation")
        self.default_from = normalize_language(default_from) or "English"
        self.default_to = normalize_language(default_to) or "German"

    @property
    def model_id(self) -> str:
        return self._gen.model_id

    @staticmethod
    def _format_prompt(text: str, src: str, dst: str) -> str:
        # model.rs:296: "translate {from} to {to}: {text}"
        return f"translate {src} to {dst}: {text}"

    def translate(self, text: str, from_lang: str, to_lang: str,
                  overrides: Optional[Seq2SeqOverrides] = None) -> str:
        src = normalize_language(from_lang)
        if src is None:
            raise TaskValidationError(f"Unknown language '{from_lang}'")
        dst = normalize_language(to_lang)
        if dst is None:
            raise TaskValidationError(f"Unknown language '{to_lang}'")
        return self._gen.generate(self._format_prompt(text, src, dst),
                                  overrides=overrides)

    def translate_default(self, text: str) -> str:
        return self.translate(text, self.default_from, self.default_to)

    def translate_to(self, text: str, to_lang: str) -> str:
        return self.translate(text, self.default_from, to_lang)

    def translate_from(self, text: str, from_lang: str) -> str:
        return self.translate(text, from_lang, self.default_to)
