"""Build the native data helpers (``<name>.cc`` beside this file) with g++
into a shared library with a plain C interface, loaded with ctypes.

The library goes to ``protein_clip_tpu_torch/_build/native/``, named by a
hash of the source, so an edited source rebuilds. Builds run at first use,
never at import, through ``kernels/build.compile_library``; a failed build
raises.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

from ...kernels.build import BUILD_ROOT, compile_library

NATIVE_DIR = Path(__file__).resolve().parent
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def build_library(name: str) -> Path:
    """Compile ``<name>.cc`` to ``lib<name>-<digest>.so`` unless it is built
    already; returns the library's path."""
    src = NATIVE_DIR / f"{name}.cc"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_ROOT / "native" / f"lib{name}-{digest}.so"
    compile_library(["g++", *GXX_FLAGS], src, lib)
    return lib
