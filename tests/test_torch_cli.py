"""The port's CLI (kjarni_tpu_torch.cli) against the JAX package's, on the CPU:
the model and encoder subcommands (the generation family is in
test_torch_cli_generation.py, which shares this file's helpers).

Every subcommand runs through both `main`s on the same tiny dirs
(tests/helpers.py), the port's with `--device cpu`: stdout in `--format
json` and in text, stderr's `error:` line and the exit codes. JSON answers
compare key by key, texts, labels and orders exactly, floats within 1e-5 (the
JAX tests' bound for the encoder tasks); a text line compares its words
exactly and each printed number within one unit of its last printed digit.
Also: stdin piping, kjarni.toml defaults (via monkeypatch.chdir), `index`
then `search` in every mode, `export-browser`, `serve` built on port 0 and
shut down, the global --device on either side of the subcommand and its
absence (no card here: the port refuses, where the JAX package falls back to
its CPU), one real `python -m kjarni_tpu_torch` subprocess, and the port's
copies of the config_file and display tests.
"""

import io
import json
import re
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest
import torch

from helpers import tiny_bert_dir

from kjarni_tpu import registry as jregistry
from kjarni_tpu.cli import main as jcli
from kjarni_tpu_torch import registry as tregistry
from kjarni_tpu_torch.cli import main as tcli
from kjarni_tpu_torch.cli.display import bar, format_table
from kjarni_tpu_torch.config_file import (KjarniConfig, TaskConfig, load_config,
                                          load_config_from_path, parse_config)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?|-?\d+")


def _close(a, b, path="", tol=TOL) -> None:
    """JSON values equal: floats within tol, everything else exactly."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), path
        assert abs(a - b) <= tol * max(1.0, abs(b)), (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}", tol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]", tol)
    else:
        assert a == b, (path, a, b)


def _same_text(a: str, b: str) -> None:
    """Text output equal, each printed number within one unit of its last
    printed digit (or TOL)."""
    assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
    for x, y in zip(_NUM.findall(a), _NUM.findall(b)):
        places = len(y.split(".")[1].split("e")[0]) if "." in y else 0
        assert abs(float(x) - float(y)) <= max(TOL, 10.0 ** -places) + 1e-12, (x, y)


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def both(argv, capsys, json_out=None):
    """Run argv through the JAX CLI and the port's (with --device cpu);
    assert equal exit codes and output; return the port's (rc, out, err)."""
    jrc, jout, jerr = _run(jcli.main, list(argv), capsys)
    trc, tout, terr = _run(tcli.main, list(argv) + ["--device", "cpu"], capsys)
    assert trc == jrc, (jerr, terr)
    if json_out is None:
        json_out = "--format" in argv and argv[argv.index("--format") + 1] == "json"
    if json_out:
        _close(json.loads(tout), json.loads(jout))
    else:
        _same_text(tout, jout)
    assert ("error" in terr) == ("error" in jerr)
    return trc, tout, terr


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_cli")
    out = {}
    out["clf"] = base / "clf"
    tiny_bert_dir(out["clf"], num_labels=2, seed=1)
    out["emb"] = base / "emb"
    tiny_bert_dir(out["emb"], seed=2)
    out["rr"] = base / "rr"
    tiny_bert_dir(out["rr"], num_labels=1, seed=5)
    docs = out["docs"] = base / "docs"
    docs.mkdir()
    (docs / "a.txt").write_text("keeping data safe with quality service")
    (docs / "b.txt").write_text("i love this product\nthe doctor and the nurse")
    (docs / "c.md").write_text("the worst purchase ever made was terrible quality")
    more = out["more"] = base / "more"
    more.mkdir()
    (more / "d.txt").write_text("hello world the physician is good")
    return out


# ---------------------------------------------------------------------------
# copies of the config_file and display tests (tests/test_config_file.py,
# tests/test_cli.py::TestDisplay) over the port's modules
# ---------------------------------------------------------------------------

SAMPLE = """
[defaults]
chat = "llama3.2-1b-instruct"
embed = "mpnet-base-v2"

[chat]
temperature = 0.5
system_prompt = "be brief"

[embed]
pooling = "cls"
normalize = false

[models."llama3.2-1b-instruct"]
max_context = 2048

[cache]
dir = "~/my-models"

[hardware]
device = "tpu"

[output]
format = "json"
quiet = true
"""


class TestConfigFile:
    def test_parse_full(self, tmp_path):
        p = tmp_path / "kjarni.toml"
        p.write_text(SAMPLE)
        cfg = load_config_from_path(p)
        assert cfg.model_for("chat") == "llama3.2-1b-instruct"
        assert cfg.model_for("embed") == "mpnet-base-v2"
        assert cfg.model_for("classify") == "distilbert-sentiment"
        assert cfg.task_config("chat").temperature == 0.5
        assert cfg.task_config("chat").system_prompt == "be brief"
        assert cfg.task_config("embed").pooling == "cls"
        assert cfg.model_override("llama3.2-1b-instruct") == {"max_context": 2048}
        assert cfg.hardware.device == "tpu"
        assert cfg.output.format == "json" and cfg.output.quiet
        assert str(cfg.cache_dir()).endswith("my-models")

    def test_parse_equals_jax(self, tmp_path):
        import dataclasses
        import tomllib
        from kjarni_tpu.config_file import parse_config as jparse
        data = tomllib.loads(SAMPLE)
        assert dataclasses.asdict(parse_config(data)) == dataclasses.asdict(jparse(data))

    def test_empty_config_defaults(self):
        cfg = parse_config({})
        assert cfg.model_for("chat") == "qwen2.5-0.5b-instruct"
        assert cfg.output.format == "text"

    def test_task_model_beats_defaults(self):
        cfg = parse_config({"defaults": {"chat": "a"}, "chat": {"model": "b"}})
        assert cfg.model_for("chat") == "b"

    def test_merged_with_overrides(self):
        tc = TaskConfig(temperature=0.5, max_tokens=10)
        merged = tc.merged_with({"temperature": 0.9, "max_tokens": None})
        assert merged.temperature == 0.9
        assert merged.max_tokens == 10

    def test_load_config_env_path(self, tmp_path, monkeypatch):
        p = tmp_path / "custom.toml"
        p.write_text('[defaults]\nembed = "bge-m3"\n')
        monkeypatch.setenv("KJARNI_CONFIG", str(p))
        assert load_config().model_for("embed") == "bge-m3"

    def test_load_config_missing_returns_defaults(self, tmp_path, monkeypatch):
        monkeypatch.delenv("KJARNI_CONFIG", raising=False)
        assert isinstance(load_config(cwd=tmp_path), KjarniConfig)


class TestDisplay:
    def test_bar(self):
        assert bar(1.0) == "█" * 20
        assert bar(0.0) == "░" * 20
        assert len(bar(0.5)) == 20

    def test_table(self):
        out = format_table([["a", "1"], ["bb", "22"]], ["N", "V"])
        assert "N" in out and "bb" in out

    def test_equal_to_jax(self, capsys):
        from kjarni_tpu.cli import display as jdisplay
        from kjarni_tpu_torch.cli import display as tdisplay
        rows, heads = [["a", "1"], ["bb", "22"]], ["N", "V"]
        assert format_table(rows, heads) == jdisplay.format_table(rows, heads)
        outs = []
        for mod in (jdisplay, tdisplay):
            mod.print_scores([("POSITIVE", 0.73), ("NEGATIVE", 0.27)])
            mod.print_similarity("a", "b", 0.61)
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and "73.0%" in outs[1] and "similar" in outs[1]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["model", "list"], ["model", "search", "sentiment"],
                                  ["model", "path", "gpt2"],
                                  ["model", "info", "gpt2"],
                                  ["model", "info", "gpt2", "--format", "json"],
                                  ["model", "info", "nonexistent-model-xyz"]],
                         ids=["list", "search", "path", "info", "info_json", "unknown"])
def test_model_commands(argv, capsys):
    rc, out, err = both(argv, capsys)
    if "nonexistent-model-xyz" in argv:
        assert rc == 1 and err.startswith("error: ")
    else:
        assert rc == 0 and out


def test_model_download_wiring(monkeypatch, capsys, tmp_path):
    """`model download` with the download itself replaced in both registries
    (no network here): the same model, format and message."""
    calls = []
    for reg in (jregistry, tregistry):
        monkeypatch.setattr(reg, "download_model_files",
                            lambda m, fmt=None, quiet=False, _r=reg: calls.append(
                                (m.cli_name, fmt.value, quiet)))
        monkeypatch.setattr(reg, "get_default_cache_dir", lambda: tmp_path)
    rc, out, _ = both(["model", "download", "gpt2", "--gguf"], capsys)
    assert rc == 0 and out.startswith("✓ Downloaded gpt2")
    assert calls[0] == calls[1] == ("gpt2", "gguf", False)


# ---------------------------------------------------------------------------
# encoder tasks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["text", "json"])
def test_classify(dirs, capsys, fmt):
    rc, out, _ = both(["classify", "i love this product", "--model", str(dirs["clf"]),
                       "--format", fmt], capsys)
    assert rc == 0 and ("█" in out if fmt == "text" else "label" in out)


def test_classify_stdin(dirs, capsys, monkeypatch):
    outs = []
    for main, dev in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO("i hate mondays"))
        rc, out, _ = _run(main, ["classify", "--model", str(dirs["clf"]), "--format",
                                 "json", *dev], capsys)
        assert rc == 0
        outs.append(json.loads(out))
    _close(outs[1], outs[0])


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_embed(dirs, capsys, fmt):
    rc, out, _ = both(["embed", "hello world", "--model", str(dirs["emb"]), "--format", fmt],
                      capsys)
    assert rc == 0 and "dim" in out


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_similarity(dirs, capsys, fmt):
    rc, out, _ = both(["similarity", "doctor", "physician", "--model", str(dirs["emb"]),
                       "--format", fmt], capsys)
    assert rc == 0


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_rerank(dirs, capsys, fmt):
    rc, out, _ = both(["rerank", "data safe", "doc one here", "data safe doc",
                       "keeping data", "--model", str(dirs["rr"]), "--format", fmt], capsys)
    assert rc == 0 and "doc" in out


def test_unknown_model_is_exit_1(capsys):
    rc, _, err = both(["classify", "hi", "--model", "nonexistent-model-xyz"], capsys)
    assert rc == 1 and err.startswith("error: ") and "nonexistent-model-xyz" in err


# ---------------------------------------------------------------------------
# kjarni.toml
# ---------------------------------------------------------------------------

def test_toml_default_models(dirs, capsys, monkeypatch, tmp_path):
    """[defaults] fills --model when it is not given; an explicit --model wins."""
    monkeypatch.delenv("KJARNI_CONFIG", raising=False)
    (tmp_path / "kjarni.toml").write_text(
        f'[defaults]\nembed = "{dirs["emb"]}"\nclassify = "{dirs["clf"]}"\n'
        f'[output]\nquiet = true\n')
    monkeypatch.chdir(tmp_path)
    rc, out, _ = both(["embed", "hello world", "--format", "json"], capsys)
    assert rc == 0
    rc, label, _ = both(["classify", "i love this", "--format", "json"], capsys)
    assert rc == 0 and json.loads(label)["label"] in ("NEGATIVE", "POSITIVE")
    rc, explicit, _ = both(["embed", "hello world", "--format", "json", "--model",
                            str(dirs["clf"])], capsys)
    assert rc == 0 and json.loads(explicit) != json.loads(out)


# ---------------------------------------------------------------------------
# index and search
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def indexes(dirs, tmp_path_factory):
    """One index per package: create over docs/, then add more/."""
    base = tmp_path_factory.mktemp("torch_cli_idx")
    stats = {}
    for main, dev, name in ((jcli.main, [], "jax"), (tcli.main, ["--device", "cpu"], "port")):
        idx = base / name
        outs = []
        for cmd, src in (("create", dirs["docs"]), ("add", dirs["more"])):
            buf = io.StringIO()
            real = sys.stdout
            sys.stdout = buf
            try:
                rc = main(["--quiet", "index", cmd, str(idx), str(src), "--model",
                           str(dirs["emb"]), "--chunk-size", "400", "--format", "json", *dev])
            finally:
                sys.stdout = real
            assert rc == 0
            outs.append(json.loads(buf.getvalue()))
        stats[name] = outs
    return base, stats


def test_index_create_and_add(indexes):
    _, stats = indexes
    assert stats["port"] == stats["jax"]
    assert stats["port"][0]["documents"] == 3 and stats["port"][1]["documents"] == 1


@pytest.mark.parametrize("mode", ["semantic", "keyword", "hybrid"])
@pytest.mark.parametrize("fmt", ["json", "text"])
def test_search(dirs, indexes, capsys, mode, fmt):
    base, _ = indexes
    args = ["search", None, "keeping data safe", "--model", str(dirs["emb"]), "--top-k",
            "3", "--mode", mode, "--format", fmt]
    _, jout, _ = _run(jcli.main, [a or str(base / "jax") for a in args], capsys)
    rc, tout, _ = _run(tcli.main, [a or str(base / "port") for a in args] + ["--device",
                                                                                "cpu"], capsys)
    assert rc == 0
    if fmt == "json":
        _close(json.loads(tout), json.loads(jout))
        assert json.loads(tout)
    else:
        _same_text(tout, jout)


# ---------------------------------------------------------------------------
# export-browser and serve
# ---------------------------------------------------------------------------

def test_export_browser(dirs, indexes, capsys, monkeypatch, tmp_path):
    """Both CLIs export the encoder (int8, with the index): equal bundle bytes,
    equal search JSON, equal summary apart from the output path."""
    from kjarni_tpu.export import browser as jbrowser
    from kjarni_tpu_torch.export import browser as tbrowser
    monkeypatch.setattr(jbrowser, "Q8_MIN_SIZE", 256)
    monkeypatch.setattr(tbrowser, "Q8_MIN_SIZE", 256)
    base, _ = indexes
    outs = {}
    for main, dev, name in ((jcli.main, [], "jax"), (tcli.main, ["--device", "cpu"], "port")):
        rc, out, err = _run(main, ["export-browser", str(dirs["emb"]), "-o",
                                   str(tmp_path / name), "--quantize", "int8", "--index",
                                   str(base / name), "--format", "json", *dev], capsys)
        assert rc == 0, err
        outs[name] = json.loads(out)
        outs[name]["out"] = None
    assert outs["port"] == outs["jax"] and outs["port"]["quantize"] == "int8"
    for f in ("manifest.json", "weights.bin", "tokenizer.json", "kjarni.js",
              "kjarni-search.js"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    # two indexes, one per package: the vectors, rounded to 5 places by the
    # export, may part by one unit of the last place (the same index exports
    # equal bytes: tests/test_torch_export.py)
    _close(json.loads((tmp_path / "port" / "kjarni-search.json").read_text()),
           json.loads((tmp_path / "jax" / "kjarni-search.json").read_text()),
           tol=1e-5 + 1e-9)
    rc, out, _ = both(["export-browser", str(dirs["clf"]), "-o", str(tmp_path / "text")],
                      capsys)
    assert rc == 0 and "exported" in out


def test_serve_on_port_0(dirs, capsys, monkeypatch):
    """`serve` builds the server over the port's tasks on port 0; /health
    and /v1/classify answer as the JAX server's, and the server shuts down."""
    from kjarni_tpu import serve as jserve
    from kjarni_tpu_torch import serve as tserve
    answers = {}

    def wrap(mod, name):
        real = mod.serve

        def serve(*a, **kw):
            server = real(*a, **kw)
            base = f"http://127.0.0.1:{server.server_address[1]}"

            def probe():
                with urllib.request.urlopen(base + "/health", timeout=60) as r:
                    health = json.loads(r.read())
                req = urllib.request.Request(
                    base + "/v1/classify", data=json.dumps({"text": "i love this"}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    answers[name] = (health, json.loads(r.read()))
                server.shutdown()
            threading.Thread(target=probe, daemon=True).start()
            return server
        monkeypatch.setattr(mod, "serve", serve)

    wrap(jserve, "jax")
    wrap(tserve, "port")
    argv = ["serve", "--port", "0", "--models", f"classify={dirs['clf']}"]
    rc, out, _ = both(argv, capsys)
    assert rc == 0 and out == "kjarni serving on http://127.0.0.1:0\n"
    assert answers["port"][0] == answers["jax"][0]
    _close(answers["port"][1], answers["jax"][1])


# ---------------------------------------------------------------------------
# verbosity, the device, the module entry points
# ---------------------------------------------------------------------------

def test_device_before_or_after_the_subcommand(dirs, capsys):
    argv = ["embed", "hello world", "--model", str(dirs["emb"]), "--format", "json"]
    rc, after, _ = _run(tcli.main, argv + ["--device", "cpu"], capsys)
    rc2, before, _ = _run(tcli.main, ["--device", "cpu"] + argv, capsys)
    assert rc == rc2 == 0 and after == before


@pytest.mark.parametrize("argv", [["embed", "hi"], ["generate", "hi", "--max-tokens", "2"],
                                  ["index", "create", "x", "y"]],
                         ids=["embed", "generate", "index"])
def test_no_device_means_the_card(dirs, capsys, argv):
    """Without --device the port's tasks take the card: here there is none,
    so the command fails with exit 1 and an error; it never drops to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run on it")
    # the card is asked for before the model dir is read: any dir will do
    rc, out, err = _run(tcli.main, argv + ["--model", str(dirs["emb"])], capsys)
    assert rc == 1 and "no CUDA device" in err and not out


def test_python_m_subprocess(dirs, capsys):
    """`python -m kjarni_tpu_torch` runs main: its embed JSON equals the
    in-process call's."""
    argv = ["embed", "hello world", "--model", str(dirs["emb"]), "--format", "json",
            "--device", "cpu"]
    r = subprocess.run([sys.executable, "-m", "kjarni_tpu_torch", *argv], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rc, out, _ = _run(tcli.main, argv, capsys)
    assert json.loads(r.stdout) == json.loads(out)
