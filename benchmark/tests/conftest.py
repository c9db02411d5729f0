"""Fixtures of the benchmark's own tests: a checkout-like root whose
``BENCHMARK.json`` names tiny copies of the configurations (a 20-frame
fib at rc = 10, and the sha256 program as it is), with the benchmark's
own traffic mixes and metric readers, and a fresh parameter cache."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

TINY_FIB = {"frame_limit": 20, "warmup_frames": 20, "rc": 10,
            "expect": {"frames": 20, "steps": 2,
                       "result": {"kind": "fib_pair", "indices": [1, 2, 3],
                                  "from": "output"},
                       "shapes": {"primary": [[132051, 110505, 3]],
                                  "secondary": [18324, 17034, 3]}}}


def write_root(root: Path) -> Path:
    """``root`` with a BENCHMARK.json of two tiny cells, ``fib-tiny.prove``
    and ``sha256-tiny.compressed``."""
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    fib = json.loads((REPO / "benchmark/configs/fib-rc100.json").read_text())
    fib.update(TINY_FIB)
    (root / "fib-tiny.json").write_text(json.dumps(fib))
    sha = (REPO / "benchmark/configs/sha256-nivc-rc10.json").read_text()
    (root / "sha256-tiny.json").write_text(sha)
    man["configs"] = [
        dict(man["configs"][0], name="fib-tiny", file="fib-tiny.json"),
        dict(man["configs"][1], name="sha256-tiny", file="sha256-tiny.json")]
    man["workloads"] = [
        dict(man["workloads"][0], name="fib-tiny.prove", config="fib-tiny"),
        dict(man["workloads"][1], name="sha256-tiny.compressed",
             config="sha256-tiny")]
    rename = {"fib-rc100.prove": "fib-tiny.prove",
              "sha256-nivc-rc10.compressed": "sha256-tiny.compressed"}
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = write_root(tmp_path_factory.mktemp("tiny"))
    os.environ["LURK_TPU_CACHE"] = str(tmp_path_factory.mktemp("cache"))
    return root


@pytest.fixture(scope="session")
def tiny_manifest(tiny_root):
    from benchmark.harness.manifest import Manifest
    return Manifest(tiny_root)


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
