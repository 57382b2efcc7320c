"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exports plain C functions. It is compiled at first
use into a shared library under ``build/kernels/`` at the root of the
checkout, named by a hash of its source, of every ``csrc`` header it
includes (``#include "..."``, followed into the headers' own includes) and
of the flags, and loaded with ``ctypes``. Nothing is compiled when a module
is imported.

The flags keep IEEE float semantics: no fast math, and ``-fmad=false`` so
that ``a * b + c`` rounds twice as the op-by-op PyTorch version does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_command", "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")
    return nvcc


def build_command(src: Path, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The ``nvcc`` command line that compiles ``src`` into ``out``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: Path) -> list[Path]:
    """``src`` and every ``csrc`` file it includes, directly or not, in the
    order first met."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def _library_path(name: str) -> Path:
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(CSRC / f"{name}.cu"):
        key.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc``
    process per source, all started together. Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    paths = {name: _library_path(name) for name in names}
    for name, out in paths.items():
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = build_command(CSRC / f"{name}.cu", Path(tmp), _nvcc())
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            print(log, file=sys.stderr)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each exported function to ``(restype, argtypes)``;
    pointers and streams are ``c_void_p``.
    """
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib
