"""Builds and loads the port's host libraries (the tokenizers' C++ loops,
the FLAVA transform's resampler).

Each ``multimodal_tpu_torch/native/*.cpp`` is compiled on first use by the
host C++ compiler (``$CXX``, else ``g++``) with ``-O2 -shared -fPIC`` into
``build/multimodal_tpu_torch/host/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries a hash of the source, compiler
and flags, and loaded with ``ctypes``. The compiler writes into a temporary
file that is then renamed into place, so processes that build at once (the
test workers) each see all of the library or none of it. A failed build
raises with the compiler's output: nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "multimodal_tpu_torch" / "host"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path(source: str) -> Path:
    src = SRC_DIR / source
    h = hashlib.sha256(" ".join([compiler(), *CXX_FLAGS]).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``source`` unless its library is already built. Raises
    ``RuntimeError`` when the compiler is missing or fails."""
    target = library_path(source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / target.name
        cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp_lib), str(SRC_DIR / source)]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the host compiler {cmd[0]!r} for {source}: {e}") \
                from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}")
        os.replace(tmp_lib, target)
    return target


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The library of ``source``, built first if needed (once a process)."""
    return ctypes.CDLL(str(build(source)))
