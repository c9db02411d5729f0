"""The port's kernel build (lurk_tpu_torch.native) without a card: nvcc
is looked up, never assumed; builds are keyed by the sources; a build
lands by rename and a failed one leaves nothing behind. And the host
C++'s Montgomery product (csrc/host/field256.h) at its edges, in each
field the port uses, against Python ints."""

import os
import random
import stat
import subprocess
import sys

import pytest

from lurk_tpu_torch import native
from lurk_tpu_torch.fields import (BN256_SCALAR, GRUMPKIN_SCALAR,
                                   PALLAS_SCALAR, VESTA_SCALAR)
from lurk_tpu_torch.hostlib import r1cs as host_r1cs
from lurk_tpu_torch.hostlib import spartan as host_spartan
from test_torch_field import one_torch_thread  # noqa: F401


def _fake_nvcc(tmp_path, body: str) -> str:
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    d = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", d)
    return d


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.nvcc()


def test_build_renames_into_place(tmp_path, build_dir, monkeypatch):
    # the fake compiler writes its -o argument (the unique tmp file)
    fake = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                'echo built > "$2"\necho "Used 1 registers"\n')
    monkeypatch.setattr(native, "nvcc", lambda: fake)
    so = native.build("poseidon")
    assert so.exists() and so.parent == build_dir
    assert so.name.startswith("poseidon-") and so.suffix == ".so"
    assert "Used 1 registers" in native.build_log("poseidon")
    assert [p.name for p in build_dir.iterdir() if ".tmp" in p.name] == []
    # cached: a second build does not run the compiler again
    monkeypatch.setattr(native, "nvcc", lambda: "/nonexistent/nvcc")
    assert native.build("poseidon") == so


def test_failed_build_raises_and_leaves_nothing(tmp_path, build_dir,
                                                monkeypatch):
    fake = _fake_nvcc(tmp_path, 'echo "error: bad kernel"\nexit 3\n')
    monkeypatch.setattr(native, "nvcc", lambda: fake)
    with pytest.raises(RuntimeError, match="bad kernel"):
        native.build("poseidon")
    assert os.listdir(build_dir) == []


def test_library_tag_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("int x;\n")
    monkeypatch.setattr(native, "CSRC", csrc)
    first = native.library_path("k")
    (csrc / "k.cuh").write_text("// header\n")
    assert native.library_path("k") != first


def test_build_many_builds_together_and_reports_every_failure(
        tmp_path, build_dir, monkeypatch):
    """One compiler per source, all started before any is waited for; a
    failure raises after the others have landed."""
    fake = _fake_nvcc(tmp_path, 'for a in "$@"; do case "$a" in *.cu) '
                                'src="$a";; esac; done\n'
                                'while [ "$1" != "-o" ]; do shift; done\n'
                                'case "$src" in *msm.cu) echo "error: bad '
                                'msm"; exit 2;; esac\n'
                                'echo built > "$2"\n')
    monkeypatch.setattr(native, "nvcc", lambda: fake)
    with pytest.raises(RuntimeError, match="bad msm"):
        native.build_many(["poseidon", "msm", "poseidon_dense"])
    assert native.library_path("poseidon").exists()
    assert native.library_path("poseidon_dense").exists()
    assert not native.library_path("msm").exists()
    assert [p.name for p in build_dir.iterdir() if ".tmp" in p.name] == []
    assert native.build_many(["poseidon"]) == {"poseidon": 0.0}


def test_host_build_needs_gxx(build_dir, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build_host()


def test_host_build_compiles_every_host_source(build_dir):
    times = native.build_host()
    assert sorted(times) == ["fastpack", "kernel_bodies", "msm", "pedersen",
                            "poseidon", "r1cs", "spartan", "srs"]
    assert all(native.host_library_path(n).exists() for n in times)
    assert native.build_host() == {}


def _edges(p: int) -> list:
    """Operands below p at the product's edges (0, 1, p - 1, a limb
    full or empty, half of p) and a few drawn from a seed."""
    rng = random.Random(p)
    vals = [0, 1, 2, 3, p - 3, p - 2, p - 1, p // 2, p // 2 + 1,
            (1 << 64) - 1, 1 << 64, (1 << 128) - 1, 1 << 192,
            (1 << 192) - 1, p - (1 << 64), p - (1 << 192),
            (1 << 256) % p, (1 << 512) % p]
    return vals + [rng.randrange(p) for _ in range(14)]


@pytest.mark.parametrize("field", [BN256_SCALAR, GRUMPKIN_SCALAR,
                                   PALLAS_SCALAR, VESTA_SCALAR],
                         ids=lambda f: f.name)
def test_host_field_product_at_its_edges(field):
    """a + r*b (the fold's RLC: r into Montgomery form, then r*b) for
    every pair of edge operands, and into and out of Montgomery form."""
    p = field.modulus
    vals = _edges(p)
    for r in vals:
        assert host_r1cs.vec_rlc(p, vals, vals, r) == [
            (a + r * a) % p for a in vals]
        assert host_r1cs.vec_rlc(p, [0] * len(vals), vals, r) == [
            r * b % p for b in vals]
    mont = host_spartan.to_mont(vals, p)
    assert host_r1cs.unpack_ints(mont, len(vals)) == [
        (v << 256) % p for v in vals]
    assert host_spartan.from_mont(mont, len(vals), p) == vals


def test_host_field_refuses_a_wide_modulus():
    """A modulus whose top limb is 2^63 - 2 or more would overflow the
    product: the library ends the process rather than answer."""
    code = ("from lurk_tpu_torch.hostlib import r1cs\n"
            "print(r1cs.vec_rlc((1 << 255) - 19, [1], [1], 1))\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode != 0 and not run.stdout
    assert "not supported" in run.stderr
