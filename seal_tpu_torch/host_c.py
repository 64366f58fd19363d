"""Build and load the host C libraries (``seal_tpu_torch/csrc/*.c``).

``load(name)`` compiles ``csrc/<name>.c`` with ``cc`` at first use into
the package's gitignored ``build/`` directory, under a name that carries a
hash of the source, and loads it with ``ctypes``; nothing builds when a
module is imported.  ``blake2.c`` is the PRNG's XOF (``random/prng.py``),
``ntt_mod.c`` the BatchEncoder's mod-t transform (``encoders.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.c``, compiled at first use."""
    source = CSRC / f"{name}.c"
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(source)],
                       check=True, capture_output=True)
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
