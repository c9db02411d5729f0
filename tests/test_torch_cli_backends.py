"""The port's REPL (``lurk_tpu_torch.cli.repl.Repl``, on the CPU) proving
with the other backends of the command line, and its protocol meta
commands. Bytes are compared exactly.

- ``nova`` (the Nova cycle), ``supernova-fold`` (NIVC) and
  ``nova-fold`` (the Nova IVC) each prove ``!(prove (+ 1 2))`` at rc = 1
  compressed and uncompressed; each proof file is read by the JAX
  package's readers (``lurk_tpu.cli.lurk_proof``) and written back to
  the same bytes, and by the port's; each file is verified by a fresh
  ``Repl`` whose public parameters load from the disk cache (the
  in-memory ones dropped), and a copy with one changed value is
  rejected. The JAX verifiers' acceptance of these backends' proofs is
  held by ``test_torch_nova_cycle.py`` and ``test_torch_nivc.py``.
- An NIVC proof with a step of another circuit index is refused with
  an error that names the missing coprocessors.
- ``tests/test_protocol.py``'s protocol round trip (defprotocol,
  prove-protocol, verify-protocol, at rc = 4 with the default backend)
  and its bad pair, through the port.
"""

import contextlib
import dataclasses
import io
import json

import pytest

import lurk_tpu.cli.lurk_proof as jax_lurk_proof
from lurk_tpu_torch.cli import lurk_proof
from lurk_tpu_torch.cli.repl import Repl, ReplError
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.proof import hyperkzg, prover, prover_cycle
from test_torch_field import one_torch_thread  # noqa: F401

PROGRAM = "!(prove (+ 1 2))"


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A fresh parameter and proof cache for the module."""
    path = tmp_path_factory.mktemp("cli_backends")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LURK_TPU_CACHE", str(path))
        yield path


def quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


def changed(d: dict, p: int) -> dict:
    """The proof file ``d`` with one value changed: the first entry of
    the first step's public input."""
    d = json.loads(json.dumps(d))
    step = d["proof"]["steps"][0] if "steps" in d["proof"] else \
        d["proof"]["u1"]
    step["x"][0] = f"{(int(step['x'][0], 16) + 1) % p:x}"
    return d


@pytest.mark.parametrize("backend", ["nova", "supernova-fold", "nova-fold"])
def test_backend_files_round_trip_and_verify(backend, cache):
    p = BN256_SCALAR.modulus
    proofs = cache / "proofs"
    keys = []
    for kind, compress in (("compressed", True), ("recursive", False)):
        repl = Repl(BN256_SCALAR, rc=1, backend=backend, compress=compress,
                    device="cpu")
        _, out = quiet(repl.load_string, PROGRAM)
        key = out.split('Proof key: "')[1].split('"')[0]
        assert key.startswith(f"{backend}_bn256_1_")
        # the next kind proves the same claim, under the same key
        (proofs / f"{key}.proof.json").rename(
            proofs / f"{key}-{kind}.proof.json")
        key = f"{key}-{kind}"
        data = (proofs / f"{key}.proof.json").read_bytes()
        assert json.loads(data)["kind"] == kind
        jax_lurk_proof.LurkProof.load(key).persist(f"jax-{key}")
        assert (proofs / f"jax-{key}.proof.json").read_bytes() == data
        assert lurk_proof.LurkProof.load(key).to_json().encode() == data
        (proofs / f"bad-{key}.proof.json").write_text(
            json.dumps(changed(json.loads(data), p)))
        keys.append(key)
    # a new REPL's verify loads its public parameters from the disk
    for memo in (prover._PP_CACHE, prover_cycle._PP_CACHE,
                 hyperkzg._SRS_MEM):
        memo.clear()
    fresh = Repl(BN256_SCALAR, rc=1, device="cpu")
    for key in keys:
        ok, text = quiet(fresh.verify_proof_key, key)
        assert ok and text == "✓ Proof verified\n", key
        ok, text = quiet(fresh.verify_proof_key, f"bad-{key}")
        assert not ok and text == "✗ Proof failed on verification\n", key


def test_nivc_proof_with_another_circuit_is_refused(cache):
    repl = Repl(BN256_SCALAR, rc=1, backend="supernova-fold",
                compress=False, device="cpu")
    _, out = quiet(repl.load_string, PROGRAM)
    key = out.split('Proof key: "')[1].split('"')[0]
    lp = lurk_proof.LurkProof.load(key)
    pc0, inst, comm_t = lp.proof.steps[0]
    lp.proof = dataclasses.replace(lp.proof,
                                   steps=[(1, inst, comm_t)]
                                   + lp.proof.steps[1:])
    lp.persist("other-circuit")
    with pytest.raises(ReplError, match="need coprocessors"):
        repl.verify_proof_key("other-circuit")


PROTOCOL_SRC = """
!(defprotocol my-protocol (hash pair)
  (let ((list6 (lambda (a b c d e f)
                 (cons a (cons b (cons c (cons d (cons e (cons f nil))))))))
        (mk-open-expr (lambda (hash) (cons 'open (cons hash nil)))))
    (cons
      (if (= (+ (car pair) (cdr pair)) 30)
        (list6 (mk-open-expr hash) (empty-env) :outermost pair (empty-env) :terminal)
        nil)
      (lambda () (> (car pair) 10))))
  :rc 4
  :description "example protocol")
"""


def committed(repl, payload: str) -> str:
    repl.load_string(PROTOCOL_SRC)
    _, out = quiet(repl.load_string, f"!(commit '{payload})")
    return [line for line in out.splitlines()
            if line.startswith("Hash: ")][0].split()[1]


def test_protocol_roundtrip(cache, tmp_path):
    repl = Repl(BN256_SCALAR, rc=4, limit=100_000, device="cpu")
    comm_hash = committed(repl, "(13 . 17)")
    proof_path = tmp_path / "protocol-proof"
    _, out = quiet(repl.load_string,
                   f'!(prove-protocol my-protocol "{proof_path}" '
                   f"{comm_hash} '(13 . 17))")
    assert "Protocol proof saved" in out
    _, out = quiet(repl.load_string,
                   f'!(verify-protocol my-protocol "{proof_path}")')
    assert "Protocol proof verified" in out


def test_protocol_rejects_bad_pair(cache, tmp_path):
    repl = Repl(BN256_SCALAR, rc=4, limit=100_000, device="cpu")
    comm_hash = committed(repl, "(13 . 18)")      # 13 + 18 != 30
    with pytest.raises(ReplError, match="rejected"):
        quiet(repl.load_string,
              f'!(prove-protocol my-protocol "{tmp_path}/p" '
              f"{comm_hash} '(13 . 18))")
