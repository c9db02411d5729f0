"""The port's kernel build (lurk_tpu_torch.native) without a card: nvcc
is looked up, never assumed; builds are keyed by the sources; a build
lands by rename and a failed one leaves nothing behind."""

import os
import stat

import pytest

from lurk_tpu_torch import native


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
    assert sorted(times) == ["pedersen", "poseidon", "srs"]
    assert all(native.host_library_path(n).exists() for n in times)
    assert native.build_host() == {}
