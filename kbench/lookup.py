"""What the harness finds by name in files under its root.

The root (`kroot`) is the `kbench/` folder of a checkout, or a scratch copy of
its data folders in the CPU tests. Three kinds of file live there, and a new
one is a new file, with no edit to any other:

- `metrics/<name>.py`: a metric's reader, `read(run)` (`run.reader`).
- `arch/<family>.py`: an architecture module. It declares the `model_type`s it
  takes, `MODEL_TYPES = ("llama", "mistral", "phi3")`, and gives
    `kinds(cfg)`: the checkpoint's layout, {name pattern: kind}, where a kind
      is a `weights.Kind` or a (shape, is_norm) pair (`kbench/weights.py` says
      what a pattern and a kind may express);
    `logits_at(cfg, seed, seqs, rows, device, *, quant, precision)`: the plain
      f32 reference, its weights drawn again from the seed; `precision="fp8"`
      is the control (`reference/decoder.py` calls it, with TF32 off);
    `useful_flops(cfg, prompt, new_tokens)`: the model operations of one
      request with no padding (`roofline/costs.py` calls it).
- `roofline/kernels/<family>.py`: a kernel family. It gives
    `KERNELS`: substrings of its device kernels' names in a trace;
    `ENTRY`: "module:function", the program's function whose calls are its
      launches;
    `record(args, kwargs)`: a launch's shape record (a tuple), from the
      entry's arguments, or None for a call that launches none of KERNELS;
    `bound_s(record)`: the least time of that launch on the card.
  `trace.py` wraps every binding of the entry while it traces.

A file is loaded from its path, not imported as a module of the package, so
it imports what it needs by absolute name (`from kbench.weights import Kind`).
It is loaded once while it is unchanged. Files whose names begin with `_` are
not looked at.
"""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path
from types import ModuleType

KROOT = Path(__file__).resolve().parent
ARCH_DIR = "arch"
KERNELS_DIR = "roofline/kernels"


@functools.lru_cache(maxsize=256)
def _exec(path: str, stamp: tuple) -> ModuleType:
    p = Path(path)
    name = re.sub(r"\W", "_", f"kbench_{p.parent.name}_{p.stem}")
    spec = importlib.util.spec_from_file_location(name, p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(path) -> ModuleType:
    """The module of the file at `path`, loaded anew only when it changed."""
    st = Path(path).stat()
    return _exec(str(Path(path).resolve()), (st.st_mtime_ns, st.st_size))


def _files(directory: Path) -> list:
    return sorted(f for f in Path(directory).glob("*.py") if not f.name.startswith("_"))


def architecture(cfg: dict, kroot: Path = KROOT) -> ModuleType:
    """The one module of `<kroot>/arch/` whose MODEL_TYPES holds
    cfg["model_type"]. Raises ValueError where none or several claim it."""
    model_type = cfg["model_type"]
    where = Path(kroot) / ARCH_DIR
    claims = [f for f in _files(where) if model_type in load(f).MODEL_TYPES]
    if not claims:
        raise ValueError(f"no architecture module in {where} claims model_type "
                         f"{model_type!r}")
    if len(claims) > 1:
        raise ValueError(f"model_type {model_type!r} is claimed by several modules: "
                         f"{', '.join(str(f) for f in claims)}")
    return load(claims[0])


def kernel_families(kroot: Path = KROOT) -> dict:
    """{family: module} of `<kroot>/roofline/kernels/`, named by file. Raises
    ValueError where one family's name substrings would take another's
    kernels."""
    fams = {f.stem: load(f) for f in _files(Path(kroot) / KERNELS_DIR)}
    for a, ma in fams.items():
        for b, mb in fams.items():
            if a != b and any(p in q for p in ma.KERNELS for q in mb.KERNELS):
                raise ValueError(f"kernel families {a} and {b} share kernel names")
    return fams
