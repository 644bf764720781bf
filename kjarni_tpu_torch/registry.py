"""Curated pretrained-model registry.

TPU-native rebuild of kjarni-transformers/src/models/registry.rs: the same curated
model list, CLI slugs, HuggingFace aliases, name resolution with substring +
Levenshtein suggestions, cache-dir layout, and download helpers.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import urllib.request
from pathlib import Path
from typing import Iterable, Optional

from .core.errors import ModelNotDownloadedError, ModelNotFoundError
from .utils.levenshtein import find_similar, similarity


class WeightsFormat(str, enum.Enum):
    SAFETENSORS = "safetensors"
    GGUF = "gguf"


class ModelArchitecture(str, enum.Enum):
    """Cf. registry.rs:19 ModelArchitecture."""

    LLAMA = "llama"
    QWEN2 = "qwen2"
    MISTRAL = "mistral"
    PHI3 = "phi3"
    BERT = "bert"
    MPNET = "mpnet"
    NOMIC_BERT = "nomic-bert"
    T5 = "t5"
    BART = "bart"
    GPT = "gpt"
    WHISPER = "whisper"

    def display_name(self) -> str:
        return {
            ModelArchitecture.LLAMA: "Llama (Standard)",
            ModelArchitecture.QWEN2: "Qwen2 (Biased)",
            ModelArchitecture.MISTRAL: "Mistral (SWA)",
            ModelArchitecture.PHI3: "Phi-3 (LongRoPE)",
            ModelArchitecture.BERT: "BERT",
            ModelArchitecture.MPNET: "Mpnet",
            ModelArchitecture.NOMIC_BERT: "Nomic-BERT",
            ModelArchitecture.T5: "T5",
            ModelArchitecture.BART: "BART",
            ModelArchitecture.GPT: "GPT",
            ModelArchitecture.WHISPER: "Whisper (ASR)",
        }[self]

    def category(self) -> str:
        if self in (ModelArchitecture.LLAMA, ModelArchitecture.QWEN2,
                    ModelArchitecture.MISTRAL, ModelArchitecture.PHI3,
                    ModelArchitecture.GPT):
            return "decoder"
        if self in (ModelArchitecture.BERT, ModelArchitecture.NOMIC_BERT,
                    ModelArchitecture.MPNET):
            return "encoder"
        return "encoder-decoder"


class ModelTask(str, enum.Enum):
    """Cf. registry.rs:89 ModelTask."""

    EMBEDDING = "embedding"
    RERANKING = "reranking"
    CLASSIFICATION = "classification"
    CHAT = "chat"
    REASONING = "reasoning"
    SENTIMENT_ANALYSIS = "sentiment-analysis"
    ZERO_SHOT_CLASSIFICATION = "zero-shot-classification"
    SEQ2SEQ = "seq2seq"
    GENERATION = "generation"
    SUMMARIZATION = "summarization"
    TRANSLATION = "translation"
    SPEECH_TO_TEXT = "speech-to-text"
    TEXT_TO_TEXT = "text-to-text"


@dataclasses.dataclass(frozen=True)
class ModelPaths:
    """Download URLs (cf. registry.rs:168 ModelPaths)."""

    weights_url: str
    tokenizer_url: str
    config_url: str
    gguf_url: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ModelInfo:
    """Cf. registry.rs:190 ModelInfo."""

    cli_name: str
    architecture: ModelArchitecture
    task: ModelTask
    paths: ModelPaths
    description: str
    size_mb: int
    params_millions: int
    aliases: tuple[str, ...] = ()

    @property
    def repo_id(self) -> str:
        parts = self.paths.weights_url.split("/")
        if len(parts) >= 5:
            return f"{parts[3]}/{parts[4]}"
        return "unknown/unknown"

    def display_group(self) -> str:
        t = self.task
        if t in (ModelTask.CHAT, ModelTask.REASONING):
            return "LLM (Decoder)"
        if t in (ModelTask.SEQ2SEQ, ModelTask.SUMMARIZATION, ModelTask.TRANSLATION,
                 ModelTask.TEXT_TO_TEXT, ModelTask.SPEECH_TO_TEXT):
            return "Seq2Seq"
        if t == ModelTask.EMBEDDING:
            return "Embedding"
        if t == ModelTask.RERANKING:
            return "Re-Ranker"
        if t == ModelTask.GENERATION:
            return "Generation (Decoder)"
        return "Classifier"

    @property
    def is_instruct(self) -> bool:
        return self.task in (ModelTask.CHAT, ModelTask.REASONING, ModelTask.SEQ2SEQ)


def _hf(repo: str, weights: str = "model.safetensors", tok: str = "tokenizer.json",
        gguf: Optional[str] = None) -> ModelPaths:
    base = f"https://huggingface.co/{repo}/resolve/main"
    return ModelPaths(
        weights_url=f"{base}/{weights}",
        tokenizer_url=f"{base}/{tok}",
        config_url=f"{base}/config.json",
        gguf_url=gguf,
    )


# The curated list, same entries and slugs as registry.rs:133 ModelType / :312 info().
MODELS: tuple[ModelInfo, ...] = (
    # Embeddings
    ModelInfo("minilm-l6-v2", ModelArchitecture.BERT, ModelTask.EMBEDDING,
              _hf("sentence-transformers/all-MiniLM-L6-v2"),
              "Fastest sentence embedding model. Ideal for basic RAG.", 90, 22,
              aliases=("all-minilm-l6-v2", "sentence-transformers/all-minilm-l6-v2")),
    ModelInfo("nomic-embed-text", ModelArchitecture.NOMIC_BERT, ModelTask.EMBEDDING,
              _hf("nomic-ai/nomic-embed-text-v1.5"),
              "Modern standard for RAG. 8192 context length, matryoshka embeddings.", 550, 137,
              aliases=("nomic-embed-text-v1.5", "nomic-ai/nomic-embed-text-v1.5")),
    ModelInfo("bge-m3", ModelArchitecture.BERT, ModelTask.EMBEDDING,
              _hf("BAAI/bge-m3"),
              "Massive multilingual embedding model. State of the art for diverse languages.",
              2200, 567, aliases=("baai/bge-m3",)),
    ModelInfo("mpnet-base-v2", ModelArchitecture.MPNET, ModelTask.EMBEDDING,
              _hf("sentence-transformers/all-mpnet-base-v2"),
              "High-quality sentence embedding model.", 420, 110,
              aliases=("all-mpnet-base-v2", "sentence-transformers/all-mpnet-base-v2")),
    ModelInfo("distilbert-base", ModelArchitecture.BERT, ModelTask.EMBEDDING,
              _hf("distilbert-base-cased-distilled-squad"),
              "Lightweight DistilBERT for question answering.", 260, 66),
    # Reranker
    ModelInfo("minilm-l6-v2-cross-encoder", ModelArchitecture.BERT, ModelTask.RERANKING,
              _hf("cross-encoder/ms-marco-MiniLM-L-6-v2"),
              "Compact cross-encoder for passage reranking.", 90, 22,
              aliases=("ms-marco-minilm-l-6-v2", "cross-encoder/ms-marco-minilm-l-6-v2")),
    # Classifiers
    ModelInfo("distilbert-sentiment", ModelArchitecture.BERT, ModelTask.SENTIMENT_ANALYSIS,
              _hf("distilbert/distilbert-base-uncased-finetuned-sst-2-english",
                  tok="onnx/tokenizer.json"),
              "Fast binary sentiment (positive/negative). Best for simple yes/no sentiment.",
              268, 66, aliases=("distilbert-base-uncased-finetuned-sst-2-english",)),
    ModelInfo("roberta-sentiment", ModelArchitecture.BERT, ModelTask.SENTIMENT_ANALYSIS,
              _hf("olafuraron/twitter-roberta-base-sentiment-latest-safetensors"),
              "3-class sentiment (negative/neutral/positive). Optimized for social media text.",
              499, 125, aliases=("twitter-roberta-base-sentiment-latest",)),
    ModelInfo("bert-sentiment-multilingual", ModelArchitecture.BERT, ModelTask.SENTIMENT_ANALYSIS,
              _hf("olafuraron/bert-base-multilingual-uncased-sentiment-safetensors"),
              "5-star sentiment (1-5). Multilingual: EN, DE, FR, ES, IT, NL.", 681, 168,
              aliases=("bert-base-multilingual-uncased-sentiment",
                       "bert-base-multilingual-uncased-sentiment-safetensors")),
    ModelInfo("roberta-emotions", ModelArchitecture.BERT, ModelTask.CLASSIFICATION,
              _hf("SamLowe/roberta-base-go_emotions"),
              "28 emotion labels (multi-label). Detects nuanced emotions like admiration, "
              "amusement, anger, etc.", 499, 125,
              aliases=("roberta-base-go_emotions", "samlowe/roberta-base-go_emotions")),
    ModelInfo("distilroberta-emotion", ModelArchitecture.BERT, ModelTask.CLASSIFICATION,
              _hf("olafuraron/emotion-english-distilroberta-base-safetensors"),
              "7 emotions: anger, disgust, fear, joy, neutral, sadness, surprise.", 329, 82,
              aliases=("emotion-english-distilroberta-base",)),
    ModelInfo("toxic-bert", ModelArchitecture.BERT, ModelTask.CLASSIFICATION,
              _hf("olafuraron/toxic-bert-safetensors"),
              "Toxic comment classifier. Detects: toxic, severe_toxic, obscene, threat, "
              "insult, identity_hate.", 438, 110,
              aliases=("toxic-bert-safetensors", "unitary/toxic-bert")),
    # Edge LLMs
    ModelInfo("qwen2.5-0.5b-instruct", ModelArchitecture.QWEN2, ModelTask.CHAT,
              _hf("Qwen/Qwen2.5-0.5B-Instruct",
                  gguf="https://huggingface.co/Qwen/Qwen2.5-0.5B-Instruct-GGUF/resolve/main/"
                       "qwen2.5-0.5b-instruct-q4_k_m.gguf"),
              "Tiny logic engine. Perfect for structured output and sanity checks.", 990, 490),
    ModelInfo("qwen2.5-1.5b", ModelArchitecture.QWEN2, ModelTask.CHAT,
              _hf("Qwen/Qwen2.5-1.5B-Instruct",
                  gguf="https://huggingface.co/Qwen/Qwen2.5-1.5B-Instruct-GGUF/resolve/main/"
                       "qwen2.5-1.5b-instruct-q4_k_m.gguf"),
              "Balanced edge model. Good reasoning in a small package.", 3100, 1540),
    ModelInfo("llama3.2-1b-instruct", ModelArchitecture.LLAMA, ModelTask.CHAT,
              _hf("meta-llama/Llama-3.2-1B-Instruct",
                  gguf="https://huggingface.co/bartowski/Llama-3.2-1B-Instruct-GGUF/resolve/"
                       "main/Llama-3.2-1B-Instruct-Q4_K_M.gguf"),
              "Official Meta edge model. Very fast, good general chat.", 2500, 1230),
    ModelInfo("llama3.2-3b-instruct", ModelArchitecture.LLAMA, ModelTask.CHAT,
              _hf("meta-llama/Llama-3.2-3B-Instruct", weights="model.safetensors.index.json",
                  gguf="https://huggingface.co/bartowski/Llama-3.2-3B-Instruct-GGUF/resolve/"
                       "main/Llama-3.2-3B-Instruct-Q4_K_M.gguf"),
              "The 3B standard. Excellent balance of speed and coherence.", 6500, 3210),
    ModelInfo("phi3.5-mini", ModelArchitecture.PHI3, ModelTask.REASONING,
              _hf("microsoft/Phi-3.5-mini-instruct", weights="model.safetensors.index.json",
                  gguf="https://huggingface.co/bartowski/Phi-3.5-mini-instruct-GGUF/resolve/"
                       "main/Phi-3.5-mini-instruct-Q4_K_M.gguf"),
              "Microsoft's 3.8B reasoning champion. Punches way above its weight.", 7500, 3800),
    # Workhorse LLMs
    ModelInfo("mistral-7b", ModelArchitecture.MISTRAL, ModelTask.CHAT,
              _hf("mistralai/Mistral-7B-Instruct-v0.3", weights="model.safetensors.index.json",
                  gguf="https://huggingface.co/bartowski/Mistral-7B-Instruct-v0.3-GGUF/resolve/"
                       "main/Mistral-7B-Instruct-v0.3-Q4_K_M.gguf"),
              "Mistral v0.3. Extremely reliable 7B model for all tasks.", 14500, 7240),
    ModelInfo("llama3.1-8b-instruct", ModelArchitecture.LLAMA, ModelTask.CHAT,
              _hf("meta-llama/Llama-3.1-8B-Instruct", weights="model.safetensors.index.json",
                  gguf="https://huggingface.co/bartowski/Meta-Llama-3.1-8B-Instruct-GGUF/"
                       "resolve/main/Meta-Llama-3.1-8B-Instruct-Q4_K_M.gguf"),
              "The open source standard. Robust, smart, and safe.", 16000, 8030),
    ModelInfo("deepseek-r1-8b", ModelArchitecture.LLAMA, ModelTask.REASONING,
              _hf("deepseek-ai/DeepSeek-R1-Distill-Llama-8B",
                  weights="model.safetensors.index.json",
                  gguf="https://huggingface.co/unsloth/DeepSeek-R1-Distill-Llama-8B-GGUF/"
                       "resolve/main/DeepSeek-R1-Distill-Llama-8B-Q4_K_M.gguf"),
              "State-of-the-Art reasoning distilled from DeepSeek R1.", 16000, 8030),
    # Seq2Seq
    ModelInfo("flan-t5-base", ModelArchitecture.T5, ModelTask.SEQ2SEQ,
              _hf("google/flan-t5-base"),
              "General purpose instruction follower (Text-to-Text).", 990, 250),
    ModelInfo("flan-t5-large", ModelArchitecture.T5, ModelTask.SEQ2SEQ,
              _hf("google/flan-t5-large"),
              "Powerful instruction follower. Great for translation and summarization.",
              3000, 780),
    ModelInfo("distilbart-cnn", ModelArchitecture.BART, ModelTask.SEQ2SEQ,
              _hf("olafuraron/distilbart-cnn-12-6"),
              "Distilled BART for fast summarization.", 1000, 306,
              aliases=("olafuraron/distilbart-cnn-12-6", "distilbart-cnn-12-6")),
    ModelInfo("bart-large-cnn", ModelArchitecture.BART, ModelTask.SEQ2SEQ,
              _hf("facebook/bart-large-cnn"),
              "BART large fine-tuned for summarization.", 1600, 406,
              aliases=("facebook/bart-large-cnn",)),
    ModelInfo("whisper-small", ModelArchitecture.WHISPER, ModelTask.SPEECH_TO_TEXT,
              _hf("openai/whisper-small"),
              "OpenAI Whisper small for speech-to-text transcription.", 1500, 244,
              aliases=("openai/whisper-small",)),
    ModelInfo("whisper-large-v3", ModelArchitecture.WHISPER, ModelTask.SPEECH_TO_TEXT,
              _hf("openai/whisper-large-v3"),
              "OpenAI Whisper large v3 for high-accuracy speech-to-text transcription.",
              7700, 1550, aliases=("openai/whisper-large-v3",)),
    # Legacy
    ModelInfo("distilgpt2", ModelArchitecture.GPT, ModelTask.GENERATION,
              _hf("distilgpt2"),
              "Distilled GPT-2 for lightweight text generation.", 319, 82),
    ModelInfo("gpt2", ModelArchitecture.GPT, ModelTask.GENERATION,
              _hf("gpt2"),
              "GPT-2 small: general-purpose text generator.", 548, 117),
)

_BY_NAME: dict[str, ModelInfo] = {}
for _m in MODELS:
    _BY_NAME[_m.cli_name] = _m
    for _a in _m.aliases:
        _BY_NAME[_a.lower()] = _m


def all_models() -> Iterable[ModelInfo]:
    return MODELS


def from_cli_name(name: str) -> Optional[ModelInfo]:
    """Cf. registry.rs:753 from_cli_name — exact slug or HF alias lookup."""
    return _BY_NAME.get(name.lower())


def resolve(name: str) -> ModelInfo:
    """Resolve a user-supplied model name, or raise with suggestions.

    Matches the reference's resolve() order (registry.rs:720): exact/alias →
    substring suggestions → Levenshtein suggestions.
    """
    m = from_cli_name(name)
    if m is not None:
        return m
    lowered = name.lower()
    names = [mi.cli_name for mi in MODELS]
    substr = [n for n in names if lowered in n]
    if substr:
        raise ModelNotFoundError(name, substr)
    sims = find_similar(name, names, limit=3, min_similarity=0.4)
    raise ModelNotFoundError(name, [n for n, _ in sims])


def search(query: str) -> list[tuple[ModelInfo, float]]:
    """Fuzzy registry search (cf. registry.rs:828)."""
    q = query.lower()
    out: list[tuple[ModelInfo, float]] = []
    for m in MODELS:
        name = m.cli_name.lower()
        name_sim = similarity(q, name)
        if q in name:
            bonus = 0.5
        elif q in m.description.lower():
            bonus = 0.3
        else:
            bonus = 0.0
        score = name_sim + bonus
        if score > 0.3:
            out.append((m, score))
    out.sort(key=lambda t: -t[1])
    return out


# ---------------------------------------------------------------------------
# Cache directory + downloads (cf. registry.rs:809-991)
# ---------------------------------------------------------------------------

def get_default_cache_dir() -> Path:
    env = os.environ.get("KJARNI_CACHE_DIR")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "kjarni"


def model_cache_dir(model: ModelInfo, base_dir: Optional[Path] = None) -> Path:
    base = Path(base_dir) if base_dir else get_default_cache_dir()
    return base / model.repo_id.replace("/", "_")


def is_downloaded(model: ModelInfo, base_dir: Optional[Path] = None) -> bool:
    d = model_cache_dir(model, base_dir)
    weights_ok = (d / "model.safetensors").exists() or \
        (d / "model.safetensors.index.json").exists() or (d / "model.gguf").exists()
    return (d / "config.json").exists() and (d / "tokenizer.json").exists() and weights_ok


def _download_file(dest: Path, url: str, quiet: bool) -> None:
    if dest.exists():
        return
    req = urllib.request.Request(url)
    token = os.environ.get("HF_TOKEN")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    if not quiet:
        print(f"  Downloading {dest.name} ...")
    tmp = dest.with_suffix(dest.suffix + ".part")
    with urllib.request.urlopen(req) as resp, open(tmp, "wb") as f:
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    tmp.rename(dest)


def download_model_files(model: ModelInfo, base_dir: Optional[Path] = None,
                         fmt: WeightsFormat = WeightsFormat.SAFETENSORS,
                         quiet: bool = False) -> Path:
    """Download config/tokenizer/weights into the cache (cf. registry.rs:866)."""
    d = model_cache_dir(model, base_dir)
    d.mkdir(parents=True, exist_ok=True)
    p = model.paths
    _download_file(d / "tokenizer.json", p.tokenizer_url, quiet)
    _download_file(d / "config.json", p.config_url, quiet)
    if fmt == WeightsFormat.GGUF and p.gguf_url:
        _download_file(d / "model.gguf", p.gguf_url, quiet)
        return d / "model.gguf"
    if fmt == WeightsFormat.GGUF:
        print("  GGUF not available, falling back to SafeTensors.")
    if p.weights_url.endswith(".index.json"):
        _download_file(d / "model.safetensors.index.json", p.weights_url, quiet)
        index = json.loads((d / "model.safetensors.index.json").read_text())
        shards = sorted(set(index["weight_map"].values()))
        base_url = p.weights_url.rsplit("/", 1)[0]
        for i, shard in enumerate(shards):
            if not quiet:
                print(f"  Processing shard {i + 1}/{len(shards)}...")
            _download_file(d / shard, f"{base_url}/{shard}", quiet)
        return d / "model.safetensors.index.json"
    _download_file(d / "model.safetensors", p.weights_url, quiet)
    return d / "model.safetensors"


def ensure_model_files(model: ModelInfo, base_dir: Optional[Path] = None,
                       allow_download: bool = True, quiet: bool = False) -> Path:
    """Return the model's cache dir, downloading files if permitted and missing."""
    d = model_cache_dir(model, base_dir)
    if is_downloaded(model, base_dir):
        return d
    if not allow_download:
        raise ModelNotDownloadedError(
            f"Model '{model.cli_name}' is not downloaded (looked in {d}) and downloads "
            f"are disabled. Fetch it with `kjarni model download {model.cli_name}`.")
    download_model_files(model, base_dir, quiet=quiet)
    return d


def format_params(millions: int) -> str:
    return f"{millions / 1000:.1f}B" if millions >= 1000 else f"{millions}M"


def format_size(mb: int) -> str:
    return f"{mb / 1000:.1f} GB" if mb >= 1000 else f"{mb} MB"
