"""The port's command line (``python -m lurk_tpu_torch.cli``) against the
JAX package's (``python -m lurk_tpu.cli``) on the CPU, proving with the
default backend (supernova-cycle, compressed, self-checked). Bytes are
compared exactly.

- ``load t.lurk --rc 1 --device cpu`` with ``!(prove (+ 1 2))`` through
  the port's CLI in a child process, while the JAX CLI proves the same
  file in another child (``JAX_PLATFORMS=cpu``), each with a fresh
  ``$LURK_TPU_CACHE`` of its own: both print the same lines, and the
  proof, meta and commitment files are equal byte for byte. The program
  takes 3 frames, so 3 chunks at rc = 1: the port's fork pool of step
  witnesses runs under the CLI (the child counts the pools it starts).
  The JAX package's C++ libraries are built first, all at once in
  threads of this process, into the suite's cache, which its other tests
  share.
- The port's ``verify`` accepts its own file and the JAX CLI's, and
  rejects a copy with one sumcheck value changed (exit 1). ``inspect``
  prints the iterations and the claim's expressions.
- The same frames proved without compression by the port's ``Repl``
  (the supernova-cycle's recursive proof file) and its compressed file
  are read by the JAX package's readers and written back to the same
  bytes.
"""

import contextlib
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

import lurk_tpu.cli.lurk_proof as jax_lurk_proof
import lurk_tpu.native as jax_native
import lurk_tpu.native.fastpack as jax_fastpack
from lurk_tpu_torch.cli import lurk_proof
from lurk_tpu_torch.cli.__main__ import main
from lurk_tpu_torch.cli.repl import Repl
from lurk_tpu_torch.fields import BN256_SCALAR
from test_torch_field import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROGRAM = "!(prove (+ 1 2))\n"
JAX_LIBS = ("msm", "pedersen", "poseidon", "r1cs", "spartan", "srs")

# The port's CLI in a child process, counting the fork pools it starts.
PORT_CHILD = r'''
import sys
import torch
torch.set_num_threads(1)
from lurk_tpu_torch.cli.__main__ import main
from lurk_tpu_torch.proof import witness_pool
pools = []


class CountingPool(witness_pool.ProcessPoolExecutor):
    def __init__(self, *args, **kwargs):
        pools.append(1)
        super().__init__(*args, **kwargs)


witness_pool.ProcessPoolExecutor = CountingPool
rc = main(sys.argv[1:])
print(f"fork pools: {len(pools)}")
sys.exit(rc)
'''


def build_jax_native(names) -> None:
    """Build the JAX package's host libraries and its fastpack extension
    into ``$LURK_TPU_CACHE/native`` at once, in threads of this process.
    Its loader compiles one library at a time under a lock, which the
    threads do without: each g++ writes a file of its own and renames it
    into place."""
    calls = [lambda n=n: jax_native.load(n) is not None for n in names]
    calls.append(jax_fastpack.available)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LOAD_LOCK", contextlib.nullcontext())
        with ThreadPoolExecutor(len(calls)) as ex:
            assert all(ex.map(lambda call: call(), calls))


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    """Both CLIs' ``load t.lurk --rc 1``: {package: (stdout, cache)}."""
    base = tmp_path_factory.mktemp("cli")
    src = base / "t.lurk"
    src.write_text(PROGRAM)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    caches = {"port": base / "port", "jax": base / "jax"}
    caches["jax"].mkdir()
    suite_native = pathlib.Path(os.environ["LURK_TPU_CACHE"]) / "native"
    suite_native.mkdir(parents=True, exist_ok=True)
    (caches["jax"] / "native").symlink_to(suite_native)
    port = subprocess.Popen(
        [sys.executable, "-c", PORT_CHILD, "load", str(src), "--rc", "1",
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=base,
        env={**env, "LURK_TPU_CACHE": str(caches["port"])})
    jax_env = {**env, "LURK_TPU_CACHE": str(caches["jax"]),
               "JAX_PLATFORMS": "cpu"}
    build_jax_native(JAX_LIBS)
    jax = subprocess.run(
        [sys.executable, "-m", "lurk_tpu.cli", "load", str(src), "--rc",
         "1"], capture_output=True, text=True, cwd=base, env=jax_env,
        timeout=600)
    out, err = port.communicate(timeout=600)
    assert port.returncode == 0, err
    assert jax.returncode == 0, jax.stderr
    return {"port": (out, caches["port"]), "jax": (jax.stdout, caches["jax"])}


def proof_key(stdout: str) -> str:
    m = re.search(r'Proof key: "([^"]+)"', stdout)
    assert m, stdout
    return m.group(1)


def test_cli_prints_and_writes_what_the_jax_cli_does(proved):
    (out, cache), (jout, jcache) = proved["port"], proved["jax"]
    lines = out.splitlines()
    assert lines[-1] == "fork pools: 1"
    assert lines[:-1] == jout.splitlines()
    key = proof_key(out)
    assert key.startswith("supernova-cycle_bn256_1_")
    names = [f"proofs/{key}.proof.json", f"proofs/{key}.meta.json",
             f"commits/{key.rsplit('_', 1)[1]}.json"]
    for name in names:
        assert (cache / name).read_bytes() == (jcache / name).read_bytes(), \
            name
    assert sorted(p.relative_to(cache).as_posix()
                  for p in cache.glob("[pc]*/*.json")) == sorted(names)
    assert json.loads((cache / names[0]).read_text())["kind"] == "compressed"


def cli(*argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def test_verify_accepts_both_files_and_rejects_a_changed_one(
        proved, monkeypatch):
    (out, cache), (_, jcache) = proved["port"], proved["jax"]
    key = proof_key(out)
    monkeypatch.setenv("LURK_TPU_CACHE", str(cache))
    shutil.copy(jcache / "proofs" / f"{key}.proof.json",
                cache / "proofs" / "from-jax.proof.json")
    d = json.loads((cache / "proofs" / f"{key}.proof.json").read_text())
    row = d["proof"]["spartans1"][0]["sc1"][0]
    row[1] = f"{(int(row[1], 16) + 1) % BN256_SCALAR.modulus:x}"
    (cache / "proofs" / "changed.proof.json").write_text(json.dumps(d))
    for k, expected in ((key, 0), ("from-jax", 0), ("changed", 1)):
        rc, text = cli("verify", k, "--rc", "1", "--device", "cpu")
        assert rc == expected, (k, text)
        assert ("✓ Proof verified" in text) == (expected == 0)
    rc, text = cli("inspect", key, "--device", "cpu")
    assert rc == 0
    assert text.splitlines() == [
        "Iterations: 3",
        "Expr: tag 0x0001 digest 0xbca63d27b22de5b9341eb1565bc0070955d9acd"
        "cc27ad3c1568dc40d3dea73d",
        "Expr-out: tag 0x0004 digest 0x3"]
    rc, text = cli("inspect", "no-such-key", "--device", "cpu")
    assert rc == 1 and text == "Error: no proof meta for no-such-key\n"


def test_jax_readers_rewrite_the_default_backends_files(proved,
                                                        monkeypatch):
    """The compressed file of the CLI and, proved again by the port's
    Repl on the same frames, the recursive one: the JAX package reads
    each and writes the same bytes back."""
    out, cache = proved["port"]
    key = proof_key(out)
    monkeypatch.setenv("LURK_TPU_CACHE", str(cache))
    path = cache / "proofs" / f"{key}.proof.json"
    compressed = path.read_bytes()
    path.unlink()
    repl = Repl(BN256_SCALAR, rc=1, compress=False, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        repl.load_string(PROGRAM)
    recursive = path.read_bytes()
    assert json.loads(recursive)["kind"] == "recursive"
    for name, data in (("compressed", compressed), ("recursive", recursive)):
        path.write_bytes(data)
        jax_lurk_proof.LurkProof.load(key).persist(f"rewritten-{name}")
        assert (path.parent / f"rewritten-{name}.proof.json").read_bytes() \
            == data, name
        port_lp = lurk_proof.LurkProof.load(key)
        assert port_lp.kind == name
        assert port_lp.to_json().encode() == data
    rc, text = cli("verify", key, "--rc", "1", "--device", "cpu")
    assert rc == 0, text
