"""The command without a card, and what it imports."""

from __future__ import annotations

import subprocess
import sys

import pytest

from benchmark.tests.conftest import REPO


def test_exits_nonzero_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fib-rc100.prove",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _top_levels(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    mods = _top_levels(
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.run, benchmark.control\n"
        "from benchmark.harness import cell, driver, spans, faults, trace\n"
        "import lurk_tpu_torch.proof.prover_supernova_cycle\n"
        "import lurk_tpu_torch.coproc.sha256")
    assert not mods & {"jax", "jaxlib", "flax", "lurk_tpu"}, mods


def test_reference_loads_nothing_of_the_program():
    mods = _top_levels(
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference.check, benchmark.reference.poseidon")
    assert not mods & {"jax", "jaxlib", "flax", "lurk_tpu",
                       "lurk_tpu_torch", "torch"}, mods
