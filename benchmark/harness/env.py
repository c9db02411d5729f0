"""Fixed cache directories inside the checkout, set before the program
is imported: the port's public parameters (``LURK_TPU_CACHE``) and any
kernel cache a library keeps. The port's own nvcc and g++ builds stay in
``lurk_tpu_torch/_build/``, where it puts them."""

from __future__ import annotations

import os
from pathlib import Path


def cache_root(bench_dir: Path) -> Path:
    return Path(bench_dir) / ".cache"


def prepare(bench_dir: Path) -> Path:
    root = cache_root(bench_dir)
    root.mkdir(parents=True, exist_ok=True)
    os.environ["LURK_TPU_CACHE"] = str(root / "lurk")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("LURK_TPU_TRACE", None)
    return root
