"""The port's example and bench entry points (``scripts/torch_{itcalc,
fib,benches,sha256_ivc,tp_table}.py``) against their JAX twins in
``examples/`` on the CPU. Integers and text only: tolerance 0.

- itcalc: ``analyze`` and the printed table equal the JAX script's.
- fib: the frame model equals the JAX one for n in 0..200 and rc in {1,
  10, 100, 600}; each backend proves fib(0) at rc = 1 (7 frames) with
  ``--device cpu`` and verifies, printing the JAX script's lines (the
  JAX script run with its provers stubbed: its frame counts come from
  its own evaluation, its seconds are masked).
- benches: ``go_base(10, 16)`` is the JAX program, and both packages
  evaluate it to 443 frames and the same output z_ptrs; the synthesis
  stage's witness at rc = 2 equals the JAX bench's; public-params at rc
  = 1 emits its cold and warm lines, the cold run leaves the shapes, the
  SRS and the generators in the temporary cache, the warm one builds no
  shape, and ``$LURK_TPU_CACHE`` is restored; every line each bench
  emits has the keys of the JAX line of the same bench and stage
  (end2end and trie-nivc with the prover stubbed: their proofs are held
  by ``test_torch_supernova_cycle.py`` and ``test_torch_coproc_provers.py``).
- sha256_ivc and trie-nivc: programs and frame counts only.
- tp_table: ``--rcs 1 --folds 1 --reps 1 --device cpu`` prints both
  tables in the JAX layout.
- Each script but itcalc defaults to ``cuda`` and exits 1 without a
  card.
"""

import ast
import functools
import json
import os
import pathlib
import re
import sys

import pytest
import torch

import lurk_tpu.native.poseidon as jax_native_poseidon
import lurk_tpu.proof.multiframe as jax_multiframe
import lurk_tpu.proof.prover as jax_prover
import lurk_tpu.proof.prover_cycle as jax_prover_cycle
import lurk_tpu.proof.supernova as jax_supernova
import lurk_tpu.store.core as jax_core
from lurk_tpu.coproc.sha256 import sha256_coprocessor as jax_sha256_cproc
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.lem import evaluation as jax_ev
from lurk_tpu.parser import read_with_default_state as jax_read
from lurk_tpu.symbol import user_sym as jax_user_sym
from lurk_tpu_torch import examples
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.lem import evaluation as ev
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.proof import prover_supernova_cycle as psc
from lurk_tpu_torch.proof import supernova_cycle
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "scripts"))
import benches as jax_benches  # noqa: E402
import fib as jax_fib  # noqa: E402
import itcalc as jax_itcalc  # noqa: E402
import sha256_ivc as jax_sha256_ivc  # noqa: E402
import tp_table as jax_tp_table  # noqa: E402
import torch_benches  # noqa: E402
import torch_fib  # noqa: E402
import torch_itcalc  # noqa: E402
import torch_sha256_ivc  # noqa: E402
import torch_tp_table  # noqa: E402

# a JAX store on its host paths: no device hashing, no XLA compile
JaxStore = functools.partial(jax_core.Store, use_device=False)


def masked(text: str) -> str:
    """``text`` with its measured numbers (seconds, rates, mean±sd)
    replaced by ``#``; counts stay."""
    text = re.sub(r" *\d+\.\d+±\d+\.\d+", " #", text)
    return re.sub(r"\d+(\.\d+)?(?=s\b| frames/s)", "#", text)


def run_jax_main(monkeypatch, capsys, module, argv):
    """The JAX script's ``main`` with ``argv``: its stdout."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def run_main(capsys, module, argv):
    """The port script's ``main(argv)``, which must return 0: its
    stdout."""
    capsys.readouterr()
    assert module.main(argv) == 0
    return capsys.readouterr().out


# ---- itcalc ----

@pytest.mark.parametrize("setup, loop", [(7, 7), (0, 1), (13, 5)])
def test_itcalc_equals_the_jax_table(monkeypatch, capsys, setup, loop):
    ns, rcs = torch_itcalc.NS, torch_itcalc.RCS
    assert torch_itcalc.analyze(torch_itcalc.Prog(setup, loop), ns, rcs) \
        == jax_itcalc.analyze(jax_itcalc.Prog(setup, loop), ns, rcs)
    argv = [str(setup), str(loop)]
    assert run_main(capsys, torch_itcalc, argv) == \
        run_jax_main(monkeypatch, capsys, jax_itcalc, argv)


def test_itcalc_defaults_print_the_jax_table(monkeypatch, capsys):
    out = run_main(capsys, torch_itcalc, [])
    assert out == run_jax_main(monkeypatch, capsys, jax_itcalc, [])
    assert out.splitlines()[6].split() == \
        ["100", "800", "800", "900", "800", "1000", "1200", "1400", "-",
         "-"]


# ---- fib ----

def test_fib_frame_model_equals_the_jax_one():
    assert examples.FIB_PROGRAM == jax_fib.FIB_PROGRAM
    for rc in (1, 10, 100, 600):
        for n in range(201):
            assert examples.fib_frame(n) == jax_fib.fib_frame(n)
            assert examples.fib_limit(n, rc) == jax_fib.fib_limit(n, rc)


def stub_jax_provers(monkeypatch):
    """The JAX provers' ``prove_from_frames`` return at once and their
    verifiers accept: the JAX scripts then run their evaluation and
    print their lines."""
    def prove(self, store, frames):
        return None, None
    for cls in (jax_prover.NovaProver, jax_prover_cycle.CycleNovaProver,
                jax_supernova.SuperNovaProver):
        monkeypatch.setattr(cls, "prove_from_frames", prove)
    for cls in (jax_prover.NovaProver, jax_prover_cycle.CycleNovaProver):
        monkeypatch.setattr(cls, "verify",
                            staticmethod(lambda pp, proof: True))
    monkeypatch.setattr(jax_supernova, "verify", lambda pp, proof: True)
    monkeypatch.setattr(jax_core, "Store", JaxStore)


@pytest.mark.parametrize("backend", torch_fib.BACKENDS)
def test_fib_proves_fib0_through_each_backend(monkeypatch, capsys,
                                               backend):
    """fib(0) at rc = 1: 7 frames, proved and verified on the CPU; the
    lines are the JAX script's, the frame count its evaluation's."""
    argv = ["0", "1", "--backend", backend]
    out = run_main(capsys, torch_fib, argv + ["--device", "cpu"])
    assert out.startswith("eval: 7 frames in ")
    stub_jax_provers(monkeypatch)
    assert masked(out) == masked(
        run_jax_main(monkeypatch, capsys, jax_fib, argv))


# ---- benches ----

def zptrs(store, ptrs):
    return [(z.tag, z.digest) for z in map(store.hash_ptr, ptrs)]


def test_synthesis_witness_equals_the_jax_bench(monkeypatch, capsys):
    """The synthesis stage at rc = 2: the port's witness equals the one
    the JAX bench synthesizes (its Python Poseidon trace), and its line
    has the JAX line's keys and counts."""
    monkeypatch.setattr(jax_native_poseidon, "available", lambda: False)
    monkeypatch.setattr(jax_benches, "Store", JaxStore)
    witnesses = []
    orig = jax_multiframe.MultiFrame.instance

    def instance(self, *args, **kw):
        out = orig(self, *args, **kw)
        witnesses.append(out[1])
        return out
    monkeypatch.setattr(jax_multiframe.MultiFrame, "instance", instance)
    capsys.readouterr()
    jax_benches.bench_synthesis(2)
    jrec = json.loads(capsys.readouterr().out)
    rec, w = torch_benches.bench_synthesis(2, "cpu")
    assert len(witnesses) == 1 and w == witnesses[0]
    assert rec.keys() == jrec.keys()
    assert {k: rec[k] for k in ("bench", "stage", "rc", "frames")} == \
        {k: jrec[k] for k in ("bench", "stage", "rc", "frames")}


def jax_emit_keys():
    """{(bench, stage): the keys of its line} from each ``_emit`` call of
    the JAX ``examples/benches.py``."""
    keys = {}
    for node in ast.walk(ast.parse(pathlib.Path(
            jax_benches.__file__).read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "_emit":
            bench, stage = (a.value for a in node.args[:2])
            keys[(bench, stage)] = {"bench", "stage", "seconds"} | {
                k.arg for k in node.keywords}
    return keys


def held_to_the_jax_keys(records, stages):
    """Each record has the keys of the JAX line of its bench and stage,
    and the records are those stages in order."""
    jax_keys = jax_emit_keys()
    assert [(r["bench"], r["stage"]) for r in records] == stages
    for r in records:
        assert set(r) == jax_keys[(r["bench"], r["stage"])], r


def test_public_params_cold_then_warm(monkeypatch, tmp_path):
    """rc = 1: the cold run builds the shapes, the SRS and the Grumpkin
    generators into the temporary cache; the warm run loads them and
    synthesizes no shape; ``$LURK_TPU_CACHE`` is restored."""
    monkeypatch.setenv("LURK_TPU_CACHE", str(tmp_path))
    built = []
    for name in ("synthesize_sn_primary", "synthesize_sn_secondary"):
        orig = getattr(supernova_cycle, name)

        def spy(*args, _orig=orig, _name=name):
            built.append(_name)
            return _orig(*args)
        monkeypatch.setattr(supernova_cycle, name, spy)
    out = torch_benches.bench_public_params(1, "cpu")
    assert os.environ["LURK_TPU_CACHE"] == str(tmp_path)
    assert not any(tmp_path.iterdir())
    held_to_the_jax_keys(out["records"], [("public_params", "cold"),
                                          ("public_params", "warm")])
    assert [r["rc"] for r in out["records"]] == [1, 1]
    assert built == ["synthesize_sn_primary", "synthesize_sn_secondary"]
    names = [pathlib.Path(f).name for f in out["files"]]
    assert "hyperkzg_srs_bn254.bin" in names
    assert any(n.startswith("ck_grumpkin_") and n.endswith(".bin")
               for n in names)
    assert any(n.endswith("_sn0.npz") for n in names)
    assert any(n.endswith("_snsec_1.npz") for n in names)


def stub_cycle_prover(monkeypatch):
    """The SuperNova cycle's prove returns at once, recording what it
    was given (prover, store, frames); its verifiers accept and compress
    is a no-op."""
    proves = []

    def prove(self, store, frames):
        proves.append((self, store, frames))
        return None, None
    monkeypatch.setattr(psc.SuperNovaCycleProver, "prove_from_frames", prove)
    monkeypatch.setattr(psc.SuperNovaCycleProver, "verify",
                        staticmethod(lambda pp, proof: True))
    monkeypatch.setattr(psc, "compress_sn_cycle", lambda pp, proof: None)
    monkeypatch.setattr(psc, "verify_compressed_sn_cycle",
                        lambda pp, cp: True)
    return proves


def test_end2end_runs_the_jax_program(monkeypatch):
    """end2end at rc = 10 (the prove stubbed): ``go_base(10, 16)`` is the
    JAX program; both packages evaluate it to 443 frames with the same
    output z_ptrs; 45 steps; every line has the JAX keys."""
    proves = stub_cycle_prover(monkeypatch)
    recs = torch_benches.bench_end2end(10, "cpu")
    held_to_the_jax_keys(recs, [("end2end", s) for s in (
        "store", "eval", "hydration", "prove", "compress", "verify")])
    assert recs[1]["frames"] == 443 and recs[3]["rc"] == 10
    assert recs[5]["ok"] is True
    src = examples.go_base(10, 16)
    assert src == jax_benches._go_base(10, 16)
    [(prover, store, frames)] = proves
    jstore = JaxStore(JAX_BN256)
    jframes = jax_ev.evaluate(None, jax_read(jstore, src), jstore, 1_000_000)
    assert len(frames) == len(jframes) == 443
    assert zptrs(store, frames[-1].output) == \
        zptrs(jstore, jframes[-1].output)
    assert len(prover.chunks(store, frames)) == 45


def test_trie_nivc_runs_the_jax_program(monkeypatch):
    """trie-nivc at rc = 10 (the prove stubbed): the trie program (the
    JAX ``TRIE_CODE``), 1,590 frames, 5 of them coprocessor frames, its
    result checked, in 167 steps (25 at rc = 100); every line has the
    JAX keys."""
    assert examples.TRIE_PROGRAM == jax_benches.TRIE_CODE
    proves = stub_cycle_prover(monkeypatch)
    recs = torch_benches.bench_trie_nivc(10, "cpu")
    held_to_the_jax_keys(recs, [("trie_nivc", "eval"),
                                ("trie_nivc", "prove")])
    assert recs[0]["frames"] == 1590 and recs[1]["rc"] == 10
    [(prover, store, frames)] = proves
    assert sum(f.pc != 0 for f in frames) == 5
    assert len(prover.chunks(store, frames)) == 167
    assert len(psc.SuperNovaCycleProver(rc=100, lang=prover.lang).chunks(
        store, frames)) == 25


# ---- sha256_ivc ----

def test_sha256_ivc_program_and_frames(monkeypatch, capsys):
    """``(sha256_ivc_1 1)`` under ``LangSetup.ivc``: 2 frames in both
    packages with the same z_ptrs; the script's line is the JAX one."""
    store, lang, expr = torch_sha256_ivc.sha256_ivc_program(1, "cpu")
    frames = ev.evaluate(ev.LangSetup.ivc(lang), expr, store, 10_000)
    jstore = JaxStore(JAX_BN256)
    jlang = jax_ev.Lang()
    sym = jax_user_sym("sha256_ivc_1")
    jlang.add_coprocessor(sym, jax_sha256_cproc(1))
    jexpr = jstore.list([jstore.intern_symbol(sym), jstore.num(1)])
    jframes = jax_ev.evaluate(jax_ev.LangSetup.ivc(jlang), jexpr, jstore,
                              10_000)
    assert len(frames) == len(jframes) == 2
    for f, g in zip(frames, jframes):
        assert zptrs(store, f.input + f.output) == \
            zptrs(jstore, g.input + g.output)

    def evaluate_only(module, evaluation):
        def evaluate_and_prove(self, store, expr, limit=10000):
            setup = evaluation.LangSetup.ivc(self.lang)
            return None, None, evaluation.evaluate(setup, expr, store, limit)
        monkeypatch.setattr(module.NovaProver, "evaluate_and_prove",
                            evaluate_and_prove)
        monkeypatch.setattr(module.NovaProver, "verify",
                            staticmethod(lambda pp, proof: True))
    evaluate_only(torch_sha256_ivc, ev)
    evaluate_only(jax_prover, jax_ev)
    monkeypatch.setattr(jax_core, "Store", JaxStore)
    out = run_main(capsys, torch_sha256_ivc, ["1", "--device", "cpu"])
    assert out.startswith("sha256_ivc_1: 2 frames, proved+verified in ")
    assert masked(out) == masked(
        run_jax_main(monkeypatch, capsys, jax_sha256_ivc, ["1"]))


# ---- tp_table ----

def test_tp_table_prints_the_jax_layout(monkeypatch, capsys):
    argv = ["--rcs", "1", "--folds", "1", "--reps", "1"]
    out = run_main(capsys, torch_tp_table, argv + ["--device", "cpu"])
    stub_jax_provers(monkeypatch)
    assert masked(out) == masked(
        run_jax_main(monkeypatch, capsys, jax_tp_table, argv))
    lines = out.splitlines()
    assert lines[1:3] == ["== raw frames/s ==", f"{'rc\\folds':>12}  {'1':>12}"]
    assert re.fullmatch(r" {11}1 +\d+\.\d\d±0\.00", lines[3])


# ---- devices ----

@pytest.mark.parametrize("module", [torch_fib, torch_benches,
                                    torch_sha256_ivc, torch_tp_table],
                         ids=lambda m: m.__name__)
def test_each_script_defaults_to_cuda(capsys, module):
    """Without a card and without ``--device cpu`` each script exits 1
    before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    capsys.readouterr()
    assert module.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "device 'cuda' requested" in captured.err
