"""Build the fastbits library with g++ (no dependencies).

The library goes to ``build/native/`` beside the CUDA kernels'
``build/kernels/`` (git-ignored), never into the package. Its name
carries a hash of ``fastbits.cpp``, so a changed source builds a new
file and a stale one is never loaded. Run ``python -m
pilosa_tpu_torch.native.build`` to build it ahead of time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "fastbits.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
FLAGS = ["-O3", "-fPIC", "-shared"]


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libfastbits-{digest.hexdigest()[:16]}.so"


def build(force: bool = False) -> str | None:
    """Compile the library if needed; the .so path, or None without a
    compiler or when the build fails (callers fall back to numpy)."""
    lib = lib_path()
    if not force and lib.exists():
        return str(lib)
    gxx = shutil.which("g++") or shutil.which("clang++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one temporary name a process: concurrent first uses do not clash
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return None
    return str(lib)


if __name__ == "__main__":
    path = build(force=True)
    print(path or "build failed / no compiler")
