"""Build and load the port's CUDA kernels.

``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Builds
happen at first use (never on import), from the sources in this package
only, into ``lurk_tpu_torch/_build/``, cached by a hash of every file in
``csrc/`` and the flags. A build writes a file unique to the process and
``os.replace``s it into place, so concurrent builds are safe. There is
no fallback: without ``nvcc``, or when it fails, loading raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (put the CUDA toolkit's bin on PATH)")
    return path


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_tag()}.so"


def build_log(name: str) -> str:
    """What nvcc and ptxas reported for the last build of ``name``
    (registers, spills), or "" if it was built by another process."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already; raises if
    nvcc fails."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{uuid.uuid4().hex}.tmp")
    try:
        out = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                               f"{out.returncode}\n{out.stdout}")
        so.with_suffix(".log").write_text(out.stdout)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return so


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build(name)))
