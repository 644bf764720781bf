"""kjarni CLI — UNIX-style front door to every task, over kjarni_tpu_torch.

The port of kjarni_tpu/cli/main.py: the same subcommands, options,
defaults, exit codes and text and JSON output (model, generate, embed,
summarize, translate, transcribe, classify, rerank, chat, index, search,
similarity, serve, export-browser), reading args or stdin, with -v/-vv/-vvv
verbosity and the kjarni.toml chain (config_file.py). One addition: a global
`--device {cuda,cpu}` (before or after the subcommand), the port's
counterpart of JAX_PLATFORMS=cpu. It reaches every task constructor and the
server; left out, the tasks run on the card and raise without one.

Under torchrun (WORLD_SIZE > 1), `generate` and `chat` take `--tp N` and
`embed`, `similarity`, `classify` and `rerank` take `--dp N`: the CLI
initializes the default process group from torchrun's environment (gloo
with `--device cpu`, NCCL with one card per rank, `cuda:LOCAL_RANK`), every
rank runs the command, rank 0 alone reads stdin (a piped text, chat's lines)
and every rank gets what it read, and only rank 0 writes to stdout. `serve`
takes both: rank 0 serves HTTP and the other ranks follow its model calls
(serve.py, serve_spmd.py).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys

from .. import registry
from ..core.errors import KjarniError
from .display import (format_table, print_scores, print_search_results,
                      print_similarity)


def _read_text(arg: str | None) -> str:
    """Positional text or stdin pipe (cf. kjarni-cli stdin piping); under
    torchrun rank 0 alone reads stdin and every rank gets its text."""
    if arg is not None and arg != "-":
        return arg
    from ..parallel.comm import from_rank0
    data = from_rank0(sys.stdin.read).strip()
    if not data:
        raise KjarniError("no input text (pass as argument or pipe via stdin)")
    return data


def _resolve_model(args) -> None:
    if getattr(args, "model", None) is None:
        args.model = getattr(args, "model_fallback", None)


def _setup_logging(verbosity: int) -> None:
    level = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}.get(
        min(verbosity, 2), logging.DEBUG)
    logging.basicConfig(level=level, format="%(levelname)s %(name)s: %(message)s")
    if verbosity >= 1:
        # -v also prints prefill/decode token throughput (stats.rs toggle)
        from ..core.stats import enable_stats
        enable_stats(True)


_CONFIG_TASK_BY_COMMAND = {
    "classify": "classify", "embed": "embed", "similarity": "embed",
    "rerank": "rerank", "generate": "generate", "chat": "chat",
    "summarize": "summarize", "translate": "translate",
    "transcribe": "transcribe", "index": "index", "search": "search",
}


def _apply_config_defaults(args) -> None:
    """kjarni.toml chain: config defaults lose to explicit CLI flags
    (kjarni_config_resolve.rs semantics — CLI always wins)."""
    from ..config_file import load_config
    cfg = load_config()
    task = _CONFIG_TASK_BY_COMMAND.get(getattr(args, "command", ""))
    if task and getattr(args, "model", None) is None:
        args.model = cfg.model_for(task)
    if cfg.output.quiet and not getattr(args, "quiet", False):
        args.quiet = True
    if getattr(args, "format", None) == "text" and cfg.output.format == "json":
        # only a default; an explicit --format text should win, but argparse
        # cannot distinguish — the reference resolves identically
        pass


# ---------------------------------------------------------------------------
# command handlers
# ---------------------------------------------------------------------------

def cmd_model(args) -> int:
    if args.model_cmd == "list":
        rows = []
        for m in registry.all_models():
            rows.append([m.cli_name, m.display_group(),
                         registry.format_params(m.params_millions),
                         registry.format_size(m.size_mb),
                         "✓" if registry.is_downloaded(m) else " "])
        print(format_table(rows, ["NAME", "KIND", "PARAMS", "SIZE", "CACHED"]))
        return 0
    if args.model_cmd == "download":
        m = registry.resolve(args.name)
        fmt = (registry.WeightsFormat.GGUF if getattr(args, "gguf", False)
               else registry.WeightsFormat.SAFETENSORS)
        registry.download_model_files(m, fmt=fmt, quiet=args.quiet)
        print(f"✓ Downloaded {m.cli_name} to {registry.model_cache_dir(m)}")
        return 0
    if args.model_cmd == "info":
        m = registry.resolve(args.name)
        info = {
            "name": m.cli_name, "architecture": m.architecture.display_name(),
            "task": m.task.value, "params": registry.format_params(m.params_millions),
            "size": registry.format_size(m.size_mb), "repo": m.repo_id,
            "description": m.description,
            "downloaded": registry.is_downloaded(m),
            "path": str(registry.model_cache_dir(m)),
        }
        if args.format == "json":
            print(json.dumps(info, indent=2))
        else:
            for k, v in info.items():
                print(f"  {k:>12}: {v}")
        return 0
    if args.model_cmd == "path":
        m = registry.resolve(args.name)
        print(registry.model_cache_dir(m))
        return 0
    if args.model_cmd == "convert":
        from ..tasks.common import resolve_model_dir
        from ..weights.checkpoint import convert_model
        src, _ = resolve_model_dir(args.name)
        out = convert_model(src, args.output, dtype=args.dtype, device=args.device)
        print(f"✓ Converted to native checkpoint at {out}")
        return 0
    if args.model_cmd == "search":
        results = registry.search(args.query)
        rows = [[m.cli_name, f"{score:.2f}", m.description[:60]]
                for m, score in results]
        print(format_table(rows, ["NAME", "SCORE", "DESCRIPTION"]))
        return 0
    raise KjarniError(f"unknown model subcommand {args.model_cmd}")


def cmd_classify(args) -> int:
    from ..tasks.classifier import Classifier
    text = _read_text(args.text)
    clf = Classifier(args.model, quiet=args.quiet, device=args.device,
                     dp=getattr(args, "dp", None))
    result = clf.classify(text)
    if args.format == "json":
        print(json.dumps({"label": result.label, "score": result.score,
                          "all_scores": dict(result.all_scores)}))
    else:
        print_scores(result.all_scores)
    return 0


def cmd_embed(args) -> int:
    from ..tasks.embedder import Embedder
    text = _read_text(args.text)
    emb = Embedder(args.model, quiet=args.quiet, device=args.device,
                   dp=getattr(args, "dp", None))
    vec = emb.embed(text)
    if args.format == "json":
        print(json.dumps({"dim": len(vec), "embedding": [float(x) for x in vec]},
                         indent=2))
    else:
        head = ", ".join(f"{x:.6f}" for x in vec[:8])
        print(f"  dim: {len(vec)}")
        print(f"  [{head}, ...]")
    return 0


def cmd_similarity(args) -> int:
    from ..tasks.embedder import Embedder
    emb = Embedder(args.model, quiet=args.quiet, device=args.device,
                   dp=getattr(args, "dp", None))
    score = emb.similarity(args.text_a, args.text_b)
    if args.format == "json":
        print(json.dumps({"similarity": score}))
    else:
        print_similarity(args.text_a, args.text_b, score)
    return 0


def cmd_rerank(args) -> int:
    from ..tasks.reranker import Reranker
    rr = Reranker(args.model, quiet=args.quiet, device=args.device,
                  dp=getattr(args, "dp", None))
    results = rr.rerank(args.query, args.documents)
    if args.format == "json":
        print(json.dumps([{"index": r.index, "score": r.score, "text": r.text}
                          for r in results]))
    else:
        for r in results:
            print(f"  {r.score:8.4f}  {r.text}")
    return 0


def _model_overrides(model: str) -> dict:
    """Per-model sections from kjarni.toml ([models."name"])."""
    from ..config_file import load_config
    ov = load_config().model_override(model)
    out = {}
    if "max_context" in ov:
        out["max_context"] = ov["max_context"]
    if "dtype" in ov:
        out["dtype"] = ov["dtype"]
    if "quantize" in ov:
        out["quantize"] = ov["quantize"]
    if "execution_plan" in ov:
        out["execution_plan"] = ov["execution_plan"]
    if "tp" in ov:
        out["tp"] = int(ov["tp"])
    return out


def cmd_generate(args) -> int:
    from ..tasks.generator import Generator, resolve_generation_config
    text = _read_text(args.prompt)
    overrides = _model_overrides(args.model)
    if getattr(args, "offload", None):
        overrides["execution_plan"] = f"offload_{args.offload}"
    if getattr(args, "draft_model", None):
        overrides["draft_model"] = args.draft_model
        overrides["draft_num_tokens"] = args.draft_tokens
    if getattr(args, "tp", None):
        overrides["tp"] = args.tp
    if getattr(args, "kv_cache", None):
        overrides["kv_cache"] = args.kv_cache
    gen = Generator(args.model, quiet=args.quiet, device=args.device, **overrides)
    cfg = resolve_generation_config(
        args.preset, None,
        **({"max_new_tokens": args.max_tokens} if args.max_tokens else {}))
    if args.format == "json":
        out = gen.generate(text, config=cfg)
        print(json.dumps({"text": out}))
    else:
        for st in gen.generate_stream(text, config=cfg):
            print(st.text, end="", flush=True)
        print()
    return 0


def cmd_chat(args) -> int:
    from ..tasks.chat import Chat
    chat_overrides = _model_overrides(args.model)
    if getattr(args, "draft_model", None):
        chat_overrides["draft_model"] = args.draft_model
        chat_overrides["draft_num_tokens"] = args.draft_tokens
    if getattr(args, "tp", None):
        chat_overrides["tp"] = args.tp
    if getattr(args, "kv_cache", None):
        chat_overrides["kv_cache"] = args.kv_cache
    if getattr(args, "chat_template", None):
        chat_overrides["chat_template"] = args.chat_template
    chat = Chat(args.model, system_prompt=args.system, quiet=args.quiet,
                device=args.device, **chat_overrides)
    if args.message:
        reply = chat.send(args.message)
        print(reply)
        return 0
    print(f"Chatting with {chat.model_id} (Ctrl-D or 'exit' to quit)")
    from ..parallel.comm import from_rank0
    while True:
        try:
            # under torchrun rank 0 reads each line and every rank gets it
            line = from_rank0(lambda: input("> ")).strip()
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if line in ("exit", "quit"):
            break
        if not line:
            continue
        for st in chat.stream(line):
            print(st.text, end="", flush=True)
        print()
    return 0


def cmd_summarize(args) -> int:
    from ..tasks.summarizer import Summarizer
    text = _read_text(args.text)
    s = Summarizer(args.model, quiet=args.quiet, device=args.device)
    out = s.summarize(text)
    if args.format == "json":
        print(json.dumps({"summary": out}))
    else:
        print(out)
    return 0


def cmd_translate(args) -> int:
    from ..tasks.translator import Translator
    text = _read_text(args.text)
    t = Translator(args.model, quiet=args.quiet, device=args.device)
    out = t.translate(text, args.from_lang, args.to_lang)
    if args.format == "json":
        print(json.dumps({"translation": out}))
    else:
        print(out)
    return 0


def cmd_transcribe(args) -> int:
    from ..tasks.transcriber import Transcriber
    t = Transcriber(args.model, language=args.language,
                    timestamps=args.timestamps, quiet=args.quiet, device=args.device)
    result = t.transcribe_file(args.file)
    if args.format == "json":
        print(json.dumps({
            "text": result.text,
            "duration": result.duration,
            "segments": [{"start": s.start, "end": s.end, "text": s.text}
                         for s in result.segments]}))
    else:
        if args.timestamps:
            for s in result.segments:
                print(f"  [{s.start:7.2f} → {s.end:7.2f}] {s.text}")
        else:
            print(result.text)
    return 0


def cmd_index(args) -> int:
    from ..tasks.indexer import Indexer
    indexer = Indexer(args.model, chunk_size=args.chunk_size, quiet=args.quiet,
                      device=args.device)
    if args.index_cmd == "create":
        stats = indexer.create(args.name, args.paths)
    else:
        stats = indexer.add(args.name, args.paths)
    if args.format == "json":
        print(json.dumps({"documents": stats.documents, "chunks": stats.chunks,
                          "bytes": stats.bytes}))
    return 0


def cmd_serve(args) -> int:
    from ..serve import parse_model_overrides, run
    return run(args.host, args.port,
               default_models=parse_model_overrides(args.models),
               max_batch=args.max_batch,
               batch_window_ms=args.batch_window_ms,
               scheduler=args.scheduler,
               draft_model=args.draft_model,
               request_timeout_s=args.device_timeout,
               tp=getattr(args, "tp", None),
               dp=getattr(args, "dp", None),
               kv_cache=getattr(args, "kv_cache", None),
               device=args.device)


def cmd_export_browser(args) -> int:
    # reads weights to host numpy and computes nothing on a device
    from ..export.browser import export_browser_model
    from ..tasks.common import DownloadPolicy, resolve_model_dir
    model_dir, _ = resolve_model_dir(args.model, None, DownloadPolicy.ALLOW,
                                     args.quiet)
    manifest = export_browser_model(model_dir, args.out,
                                    quantize=getattr(args, "quantize", None))
    info = {"out": args.out, "tensors": len(manifest["tensors"]),
            "weights_bytes": manifest["weights_bytes"],
            "quantize": manifest.get("quantize")}
    if getattr(args, "index", None):
        import shutil
        from pathlib import Path

        from ..export.browser import export_search_index
        out = Path(args.out)
        info["search_index"] = export_search_index(
            args.index, out / "kjarni-search.json")
        # make dist/ a self-contained drop-in: engine + widget ride along
        web = Path(__file__).resolve().parents[2] / "web"
        for name in ("kjarni.js", "kjarni-search.js"):
            shutil.copy(web / name, out / name)
    if getattr(args, "selftest", False):
        from ..export.browser import selftest_bundle
        info["selftest"] = selftest_bundle(args.out)
    if args.format == "json":
        print(json.dumps(info))
    else:
        print(f"exported {info['tensors']} tensors "
              f"({info['weights_bytes'] / 1e6:.1f} MB) to {args.out}\n"
              f"serve web/ + {args.out} statically and use web/kjarni.js")
        if "selftest" in info:
            print(f"selftest ok (web/kjarni.js executed in jsvm): "
                  f"{info['selftest']}")
    return 0


def cmd_search(args) -> int:
    from ..tasks.searcher import Searcher
    searcher = Searcher(args.model, reranker_model=args.rerank_model,
                        quiet=args.quiet, device=args.device)
    results = searcher.search(args.name, args.query, mode=args.mode,
                              top_k=args.top_k)
    if args.format == "json":
        print(json.dumps([{"score": r.score, "document_id": r.document_id,
                           "text": r.text, "metadata": r.metadata}
                          for r in results]))
    else:
        print_search_results(results)
    return 0


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

DEVICES = ("cuda", "cpu")
DEVICE_HELP = "where the models run (default: the CUDA card; 'cpu' asks for the CPU)"

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kjarni",
        description="kjarni-tpu: run ML models from the command line")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", choices=DEVICES, default=None, help=DEVICE_HELP)
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(sp, model_default):
        # default=None lets kjarni.toml fill it; the literal default applies last
        sp.add_argument("--model", default=None)
        sp.set_defaults(model_fallback=model_default)
        sp.add_argument("--format", choices=["text", "json"], default="text")

    sp = sub.add_parser("model", help="manage models")
    msub = sp.add_subparsers(dest="model_cmd", required=True)
    msub.add_parser("list")
    d = msub.add_parser("download")
    d.add_argument("name")
    d.add_argument("--gguf", action="store_true",
                   help="prefer the quantized GGUF weights when available")
    i = msub.add_parser("info")
    i.add_argument("name")
    i.add_argument("--format", choices=["text", "json"], default="text")
    pa = msub.add_parser("path")
    pa.add_argument("name")
    se = msub.add_parser("search")
    se.add_argument("query")
    cv = msub.add_parser("convert",
                         help="convert to a fast-loading native checkpoint")
    cv.add_argument("name")
    cv.add_argument("output")
    cv.add_argument("--dtype", default="auto", choices=["auto", "f32", "bf16"])
    sp.set_defaults(fn=cmd_model)

    def add_dp(sp):
        sp.add_argument("--dp", type=int, default=None, metavar="N",
                        help="data-parallel over N chips (batch rows "
                             "sharded over the device mesh)")

    sp = sub.add_parser("classify", help="classify text")
    sp.add_argument("text", nargs="?")
    add_common(sp, "distilbert-sentiment")
    add_dp(sp)
    sp.set_defaults(fn=cmd_classify)

    sp = sub.add_parser("embed", help="generate embeddings")
    sp.add_argument("text", nargs="?")
    add_common(sp, "minilm-l6-v2")
    add_dp(sp)
    sp.set_defaults(fn=cmd_embed)

    sp = sub.add_parser("similarity", help="semantic similarity of two texts")
    sp.add_argument("text_a")
    sp.add_argument("text_b")
    add_common(sp, "minilm-l6-v2")
    add_dp(sp)
    sp.set_defaults(fn=cmd_similarity)

    sp = sub.add_parser("rerank", help="rerank documents against a query")
    sp.add_argument("query")
    sp.add_argument("documents", nargs="+")
    add_common(sp, "minilm-l6-v2-cross-encoder")
    add_dp(sp)
    sp.set_defaults(fn=cmd_rerank)

    sp = sub.add_parser("generate", help="generate text with an LLM")
    sp.add_argument("prompt", nargs="?")
    sp.add_argument("--max-tokens", type=int)
    sp.add_argument("--preset", choices=["greedy", "creative", "precise",
                                         "balanced"])
    sp.add_argument("--offload", choices=["embeddings", "head", "ends"],
                    help="keep the embedding table and/or lm head in host "
                         "memory (pinned_host) to save HBM")
    sp.add_argument("--draft-model",
                    help="smaller same-vocab model for speculative decoding")
    sp.add_argument("--draft-tokens", type=int, default=4,
                    help="draft tokens proposed per speculation round")
    sp.add_argument("--tp", type=int, default=None, metavar="N",
                    help="tensor-parallel over N chips (Megatron-sharded "
                         "weights + kv cache over the device mesh)")
    sp.add_argument("--kv-cache", choices=["int8"], default=None,
                    help="int8-quantized KV cache: halves KV HBM traffic "
                         "(wins on batched long-context decode; bf16 is "
                         "the single-stream pick)")
    add_common(sp, "qwen2.5-0.5b-instruct")
    sp.set_defaults(fn=cmd_generate)

    sp = sub.add_parser("chat", help="chat with an instruct model")
    sp.add_argument("--message", "-m", help="single message (non-interactive)")
    sp.add_argument("--system")
    sp.add_argument("--draft-model",
                    help="smaller same-vocab model for speculative decoding")
    sp.add_argument("--draft-tokens", type=int, default=4)
    sp.add_argument("--tp", type=int, default=None, metavar="N",
                    help="tensor-parallel over N chips")
    sp.add_argument("--kv-cache", choices=["int8"], default=None,
                    help="int8-quantized KV cache (see generate --kv-cache)")
    sp.add_argument("--chat-template",
                    choices=["llama2", "llama3", "chatml", "mistral", "phi3",
                             "raw"],
                    default=None,
                    help="override the prompt format (default: the model "
                         "architecture's template; 'llama2' = legacy "
                         "[INST]/<<SYS>> fine-tunes)")
    add_common(sp, "qwen2.5-0.5b-instruct")
    sp.set_defaults(fn=cmd_chat)

    sp = sub.add_parser("summarize", help="summarize text")
    sp.add_argument("text", nargs="?")
    add_common(sp, "distilbart-cnn")
    sp.set_defaults(fn=cmd_summarize)

    sp = sub.add_parser("translate", help="translate text")
    sp.add_argument("text", nargs="?")
    sp.add_argument("--from", dest="from_lang", default="English")
    sp.add_argument("--to", dest="to_lang", default="German")
    add_common(sp, "flan-t5-base")
    sp.set_defaults(fn=cmd_translate)

    sp = sub.add_parser("transcribe", help="transcribe audio")
    sp.add_argument("file")
    sp.add_argument("--language")
    sp.add_argument("--timestamps", action="store_true")
    add_common(sp, "whisper-small")
    sp.set_defaults(fn=cmd_transcribe)

    sp = sub.add_parser("index", help="create or extend a search index")
    isub = sp.add_subparsers(dest="index_cmd", required=True)
    for name in ("create", "add"):
        c = isub.add_parser(name)
        c.add_argument("name")
        c.add_argument("paths", nargs="+")
        c.add_argument("--model", default="minilm-l6-v2")
        c.add_argument("--chunk-size", type=int, default=1000)
        c.add_argument("--format", choices=["text", "json"], default="text")
    sp.set_defaults(fn=cmd_index)

    sp = sub.add_parser("serve", help="run the HTTP server")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--max-batch", type=int, default=1,
                    help="group up to N concurrent generate requests into "
                         "one batched decode (1 = off)")
    sp.add_argument("--batch-window-ms", type=float, default=10.0)
    sp.add_argument("--models", action="append", default=[],
                    metavar="KIND=NAME_OR_PATH",
                    help="override the model for a task kind, e.g. "
                         "--models generate=/path/to/model (repeatable)")
    sp.add_argument("--scheduler", choices=["batch", "continuous"],
                    default="batch",
                    help="'continuous' joins generate requests into a "
                         "running slot-based decode (token-level batching)")
    sp.add_argument("--draft-model",
                    help="speculative-decoding draft model for /v1/generate")
    sp.add_argument("--device-timeout", type=float, default=None,
                    help="per-request deadline in seconds; a wedged device "
                         "returns 503 instead of hanging")
    sp.add_argument("--tp", type=int, default=None, metavar="N",
                    help="tensor-parallel decoder models over N ranks "
                         "(under torchrun --nproc-per-node N)")
    sp.add_argument("--dp", type=int, default=None, metavar="N",
                    help="data-parallel encoder models over N ranks "
                         "(under torchrun --nproc-per-node N)")
    sp.add_argument("--kv-cache", choices=["int8"], default=None,
                    help="int8-quantized KV cache for decoder models: "
                         "halves KV HBM traffic, wins under batched "
                         "long-context serving (1.44x at B=8/fill 3.5k)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("export-browser",
                        help="export an encoder to a browser bundle "
                             "(manifest.json + weights.bin for web/kjarni.js)")
    sp.add_argument("model", help="registry name or local model dir")
    sp.add_argument("-o", "--out", required=True, help="output directory")
    sp.add_argument("--selftest", action="store_true",
                    help="after exporting, execute web/kjarni.js against "
                         "the bundle via the in-tree jsvm interpreter")
    sp.add_argument("--quantize", choices=["int8"], default=None,
                    help="int8 per-channel weights (~4x smaller bundle; "
                         "the JS engine dequantizes in the matmul loop, "
                         "mirroring the reference's q8 browser models)")
    sp.add_argument("--index", default=None, metavar="INDEX_DIR",
                    help="also export an on-disk RAG index (from `kjarni "
                         "index create`) as kjarni-search.json and copy the "
                         "kjarni-search.js site-search widget into -o, "
                         "making it a self-contained drop-in")
    sp.add_argument("--format", choices=["text", "json"], default="text")
    sp.add_argument("--quiet", "-q", action="store_true")
    sp.add_argument("--verbose", "-v", action="count", default=0)
    sp.set_defaults(fn=cmd_export_browser)

    sp = sub.add_parser("search", help="search an index")
    sp.add_argument("name")
    sp.add_argument("query")
    sp.add_argument("--top-k", type=int, default=10)
    sp.add_argument("--mode", choices=["semantic", "keyword", "hybrid"],
                    default="hybrid")
    sp.add_argument("--rerank-model")
    add_common(sp, "minilm-l6-v2")
    sp.set_defaults(fn=cmd_search)

    _device_everywhere(p)
    return p


def _device_everywhere(parser: argparse.ArgumentParser) -> None:
    """--device after any subcommand too; SUPPRESS keeps the global value
    where it is not given there."""
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for sp in action.choices.values():
                sp.add_argument("--device", choices=DEVICES, default=argparse.SUPPRESS,
                                help=DEVICE_HELP)
                _device_everywhere(sp)


@contextlib.contextmanager
def _ranks(args):
    """Under torchrun (WORLD_SIZE > 1 in the environment), initialize the
    default process group from it for the command, unless the caller has
    already: gloo with --device cpu, else NCCL on cuda:LOCAL_RANK, which
    must exist. Ranks other than 0 write nothing to stdout."""
    import torch.distributed as dist
    from ..parallel.comm import spmd_group
    with spmd_group(getattr(args, "device", None)):
        if dist.is_initialized() and dist.get_rank() != 0:
            with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
                yield
        else:
            yield


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    _setup_logging(args.verbose)
    _apply_config_defaults(args)
    _resolve_model(args)
    try:
        with _ranks(args):
            return args.fn(args)
    except KjarniError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
