"""Build and load the port's hand-written CUDA kernels.

``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface that ``ctypes`` loads. The library goes to
``protein_clip_tpu_torch/_build/<hash>/``, keyed by a hash of every source
under ``csrc/`` and the compiler flags, so an edited source rebuilds and an
unchanged one loads the library already built. Builds run at first use,
never at import. A build or load failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def compile_library(cmd: list[str], src: Path, lib: Path) -> str:
    """Compile ``src`` with ``cmd`` (a compiler and its flags) into the
    shared library ``lib`` unless it exists already. Returns the compiler's
    output, empty when there was nothing to build; a failed build raises."""
    if lib.exists():
        return ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build failed: {src.name} ({Path(cmd[0]).name} exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: concurrent builds agree
    return proc.stdout


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills),
    empty when there was nothing to build."""
    return compile_library([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR)],
                           CSRC_DIR / f"{name}.cu", library_path(name))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
