"""Build the port's C ABI: libkjarni.so (and its C test host) with g++.

`native/kjarni_ffi.cpp` embeds CPython and imports `kjarni_tpu_torch.ffi.bridge`;
`native/kjarni.h` is its public header, byte-identical to the JAX package's,
so the C#, Go and Python bindings load either library (the Python binding
finds it through KJARNI_LIBRARY). The library is compiled at first use into
`build/ffi/` beside the package (the checkout's root), against the Python
that `python3-config` describes for the running interpreter's version
(`--includes`, `--ldflags --embed`). The file name carries a digest of the
sources, the flags and that configuration, so an edited source is rebuilt and
a built one is reused. A failed build raises.

    python -m kjarni_tpu_torch.ffi.build      # prints the library's path
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
NATIVE = PKG_DIR / "native"
BUILD_DIR = PKG_DIR.parent / "build" / "ffi"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-fvisibility=hidden", "-shared")
CFLAGS = ("-O2", "-std=c11", "-Wall")


def python_config() -> str:
    """The python3-config of the running interpreter's version."""
    v = f"{sys.version_info.major}.{sys.version_info.minor}"
    for name in (f"python{v}-config", "python3-config"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError(f"python{v}-config not found: the C ABI embeds CPython and "
                       f"needs its headers and library")


def _config(flag: str, *more: str) -> list[str]:
    out = subprocess.run([python_config(), flag, *more], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.split()


def embed_flags() -> tuple[list[str], list[str]]:
    """(include flags, link flags) for a library that embeds CPython."""
    return _config("--includes"), _config("--ldflags", "--embed")


def _digest(*parts) -> str:
    h = hashlib.sha1()
    for part in parts:
        h.update(part if isinstance(part, bytes) else " ".join(part).encode())
    return h.hexdigest()[:12]


def library_path() -> Path:
    inc, ld = embed_flags()
    d = _digest(CXXFLAGS, inc, ld, (NATIVE / "kjarni_ffi.cpp").read_bytes(),
                (NATIVE / "kjarni.h").read_bytes())
    return BUILD_DIR / f"libkjarni-{d}.so"


def _run(cmd: list[str], what: str) -> None:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{what} failed ({' '.join(cmd)}):\n{r.stdout}{r.stderr}")


def build_library() -> Path:
    """libkjarni-<digest>.so in build/ffi/, built if it is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    inc, ld = embed_flags()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX") or "g++"
    _run([cxx, *CXXFLAGS, *inc, f"-Wl,-soname,{out.name}", "-o", str(tmp),
          str(NATIVE / "kjarni_ffi.cpp"), *ld], "g++ build of libkjarni.so")
    os.replace(tmp, out)
    return out


def build_test_host() -> Path:
    """The C test host (native/test_host.c) linked against build_library()'s
    library, found through its rpath."""
    lib = build_library()
    out = BUILD_DIR / f"test_host-{_digest(CFLAGS, lib.name.encode(), (NATIVE / 'test_host.c').read_bytes())}"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cc = os.environ.get("CC") or "gcc"
    _run([cc, *CFLAGS, f"-I{NATIVE}", "-o", str(tmp), str(NATIVE / "test_host.c"),
          str(lib), "-lm", f"-Wl,-rpath,{lib.parent}"], "gcc build of test_host")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build_library())
