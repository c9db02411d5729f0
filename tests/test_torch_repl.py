"""The port's printer, ZDag and REPL (``lurk_tpu_torch.store.{printer,
zdag}``, ``lurk_tpu_torch.cli.repl``) against the JAX package's, on the
CPU and without proving. Strings and bytes are compared exactly.

- ``fmt_to_string`` on the forms of ``tests/test_parser.py`` and more
  (strings, chars, u64, field elements above 2^64, keywords, opaque and
  openable commitments, closures), and on every frame's input and
  output of fib(10) (environments and continuations), equals the JAX
  package's; so does ``fmt_to_string_simple``.
- ``ZDag.populate_with`` on the same store contents gives the same JSON
  in both packages; either package's JSON, read back into a fresh port
  store, gives the same content addresses and the same printed form.
  ``ZStore`` with a commitment does the same.
- A transcript of every meta command that does not prove, run form by
  form through the port's ``Repl(device="cpu")`` and the JAX
  ``Repl(Store(..., use_device=False))``: the printed lines and the
  ``ReplError`` messages are equal line by line, and the commitment and
  dump files they write are equal byte for byte.
- ``python -m lurk_tpu_torch.cli repl --device cpu`` in a child process
  reads ``(+ 1 2)`` from stdin and prints ``[3 iterations] => 3``;
  without ``--device cpu`` on a machine without a card the command
  exits non-zero with the device error.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from lurk_tpu.cli.repl import Repl as JaxRepl
from lurk_tpu.cli.repl import ReplError as JaxReplError
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.lem.evaluation import evaluate as jax_evaluate
from lurk_tpu.parser import read as jax_read
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu.store.printer import fmt_to_string as jax_fmt
from lurk_tpu.store.printer import fmt_to_string_simple as jax_fmt_simple
from lurk_tpu.store.zdag import ZDag as JaxZDag
from lurk_tpu.store.zdag import ZStore as JaxZStore
from lurk_tpu.symbol import State as JaxState
from lurk_tpu_torch.cli.repl import Repl, ReplError
from lurk_tpu_torch.examples import FIB_PROGRAM, fib_limit
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.lem.evaluation import evaluate
from lurk_tpu_torch.parser import read
from lurk_tpu_torch.store.core import Store
from lurk_tpu_torch.store.printer import fmt_to_string, fmt_to_string_simple
from lurk_tpu_torch.store.zdag import ZDag, ZStore
from lurk_tpu_torch.symbol import State
from test_torch_field import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def repl_children(tmp_path_factory):
    """``repl --device cpu`` with ``(+ 1 2)`` on stdin, and ``repl``
    with no device flag, both started at once while the module's other
    cases run."""
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "LURK_TPU_CACHE": str(tmp_path_factory.mktemp("repl_cache"))}
    children = {}
    for name, flags in (("cpu", ["--device", "cpu"]), ("default", [])):
        children[name] = subprocess.Popen(
            [sys.executable, "-m", "lurk_tpu_torch.cli", "repl"] + flags,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    yield {name: child.communicate("(+ 1 2)\n", timeout=120)
           + (child.returncode,) for name, child in children.items()}


def stores():
    return (Store(BN256_SCALAR, device="cpu"),
            JaxStore(JAX_BN256, use_device=False))


PRINTED = [
    # tests/test_parser.py:115-150
    "(1 2 3)", "(a b . c)", '"hi"', "'x'", "123u64", "(+ 1 (* 2 3))",
    "nil", "t", ":kw", "(+ 1 2)", "15u64", "-1",
    # more of the printer's cases
    '("two words" #\\z :key .lurk.user.sym (quote q))',
    "0x1d501baeefe83acf0e7137180b091834f542a5059dbaf99ec82c5e19d3bb9201",
    "18446744073709551616", "18446744073709551615", "(lambda (x) x)",
]


@pytest.mark.parametrize("src", PRINTED, ids=[s[:20] for s in PRINTED])
def test_printer_matches_jax_on_read_forms(src):
    store, jstore = stores()
    state, jstate = State.init_lurk_state(), JaxState.init_lurk_state()
    ptr, jptr = read(store, state, src), jax_read(jstore, jstate, src)
    assert fmt_to_string(ptr, store, state) == jax_fmt(jptr, jstore, jstate)
    assert fmt_to_string_simple(ptr, store) == jax_fmt_simple(jptr, jstore)


def test_printer_matches_jax_on_comms_and_closures():
    """Opaque and openable commitments, a closure and a recursive
    closure, each evaluated on both sides."""
    store, jstore = stores()
    for s in (store, jstore):
        s.hydrate_z_cache()
    assert fmt_to_string_simple(store.comm(0), store) == \
        jax_fmt_simple(jstore.comm(0), jstore)
    assert fmt_to_string_simple(store.commit(store.num_u64(0)), store) == \
        jax_fmt_simple(jstore.commit(jstore.num_u64(0)), jstore)
    for src in ("(lambda (x y) (+ x y))", "(lambda () 7)",
                "(letrec ((f (lambda (n) (f n)))) f)",
                "(commit (lambda (x) x))",
                "(let ((a 1) (b \"s\")) (current-env))"):
        out = evaluate(None, read(store, State.init_lurk_state(), src),
                       store, 1000)[-1].output
        jout = jax_evaluate(
            None, jax_read(jstore, JaxState.init_lurk_state(), src),
            jstore, 1000)[-1].output
        assert [fmt_to_string_simple(p, store) for p in out] == \
            [jax_fmt_simple(p, jstore) for p in jout], src


def test_printer_matches_jax_on_fib10_frames():
    """Every frame's input and output of fib(10): expressions,
    environments and the continuation stack."""
    store, jstore = stores()
    frames = evaluate(None, read(store, State.init_lurk_state(),
                                 FIB_PROGRAM), store, fib_limit(10, 1))
    jframes = jax_evaluate(
        None, jax_read(jstore, JaxState.init_lurk_state(), FIB_PROGRAM),
        jstore, fib_limit(10, 1))
    assert len(frames) == len(jframes) == 77
    for f, g in zip(frames, jframes):
        assert [fmt_to_string_simple(p, store) for p in f.input + f.output] \
            == [jax_fmt_simple(p, jstore) for p in g.input + g.output]


def test_zdag_json_matches_jax_and_reads_back():
    src = ('(cons "hello" (cons 42u64 (quote (a b . c))))',
           "(letrec ((f (lambda (n) (if (= n 0) 1 (f (- n 1)))))) (f 3))")
    store, jstore = stores()
    for text in src + (FIB_PROGRAM,):
        ptr = read(store, State.init_lurk_state(), text)
        jptr = jax_read(jstore, JaxState.init_lurk_state(), text)
        out = evaluate(None, ptr, store, 200)[-1].output
        jout = jax_evaluate(None, jptr, jstore, 200)[-1].output
        store.hydrate_z_cache()
        jstore.hydrate_z_cache()
        for p, jp in zip([ptr] + out, [jptr] + jout):
            dag, jdag = ZDag(), JaxZDag()
            root, jroot = dag.populate_with(p, store), \
                jdag.populate_with(jp, jstore)
            assert tuple(root) == tuple(jroot)
            data = json.dumps(dag.to_json())
            assert data == json.dumps(jdag.to_json())
            # either package's JSON into a fresh port store
            for text_json in (data, json.dumps(jdag.to_json())):
                fresh = Store(BN256_SCALAR, device="cpu")
                back = ZDag.from_json(json.loads(text_json)).populate_store(
                    root, fresh)
                assert fresh.hash_ptr(back) == root
                assert fmt_to_string_simple(back, fresh) == \
                    fmt_to_string_simple(p, store)


def test_zstore_commitments_match_jax():
    store, jstore = stores()
    payload = read(store, State.init_lurk_state(), "(1 2 3)")
    jpayload = jax_read(jstore, JaxState.init_lurk_state(), "(1 2 3)")
    digest, _ = store.hide_and_return_z_payload(99, payload)
    jdigest, _ = jstore.hide_and_return_z_payload(99, jpayload)
    assert digest == jdigest
    zs, jzs = ZStore(), JaxZStore()
    zs.populate_with_commitment(digest, store)
    jzs.populate_with_commitment(jdigest, jstore)
    data = json.dumps(zs.to_json())
    assert data == json.dumps(jzs.to_json())
    fresh = Store(BN256_SCALAR, device="cpu")
    ZStore.from_json(json.loads(data)).populate_store(fresh)
    secret, back = fresh.open(digest)
    assert secret == 99 and fresh.hash_ptr(back) == store.hash_ptr(payload)


PROTOCOL = """!(defprotocol my-protocol (hash pair)
  (let ((list6 (lambda (a b c d e f)
                 (cons a (cons b (cons c (cons d (cons e (cons f nil))))))))
        (mk-open-expr (lambda (hash) (cons 'open (cons hash nil)))))
    (cons
      (if (= (+ (car pair) (cdr pair)) 30)
        (list6 (mk-open-expr hash) (empty-env) :outermost pair (empty-env) :terminal)
        nil)
      (lambda () (> (car pair) 10))))
  :rc 4
  :description "example protocol")"""

CHAIN = ("!(chain (commit (letrec ((add (lambda (counter x) (let ((counter "
         "(+ counter x))) (cons counter (commit (add counter))))))) "
         "(add 0))) 1)")


def transcript_forms(dump: pathlib.Path, loaded: pathlib.Path) -> list:
    """Each form alone, in order: every meta command that does not
    prove, with the errors each raises."""
    return [
        "(+ 1 2)", "(car 1)", "!(def x 5)",
        "!(defrec fact (lambda (n) (if (= n 0) 1 (* n (fact (- n 1))))))",
        "(fact x)", "!(assert (= (fact 3) 6))", "!(assert-eq (fact 3) 6)",
        "!(assert-error (car 1 2))",
        "!(assert-emitted '(1 2) (begin (emit 1) (emit 2)))",
        "!(assert (= 1 2))", "!(assert-eq 1 2)", "!(assert-error (+ 1 2))",
        "!(assert-emitted '(1) (emit 2))", "!(def bad (car 1))",
        "!(commit '(13 . 17))", "!(hide 42 (lambda (y) (* y 2)))",
        "!(hide 'a 1)", "!(open (commit '(13 . 17)))",
        "!(open (hide 42 (lambda (y) (* y 2))))", "!(commit 7)",
        "!(fetch (commit 7))", "!(fetch (comm 123))", "!(open (comm 5))",
        "!(open 'a)", "!(call (commit (lambda (x) (+ x 1))) 41)",
        "!(call 'a 1)", CHAIN, "!(current-env)",
        "!(set-env (let ((z 9)) (current-env)))", "!(current-env)",
        "!(set-env 1)", "!(clear)", "!(current-env)", "x",
        "!(defpackage my-pkg)", "!(in-package my-pkg)", "'(a b)",
        "!(defpackage \"other\")", "!(import .lurk.user.x)",
        "!(in-package .lurk.user)", "'(a .lurk.user.my-pkg.b)",
        f'!(dump-data (cons 1 "two") "{dump}")',
        f'!(def-load-data loaded "{dump}")', "loaded",
        f'!(load "{loaded}")', "y-from-file",
        PROTOCOL, "my-protocol", "!(inspect \"no-such-key\")",
        "!(verify \"no-such-key\")", "!(frobnicate)", "!(def x)",
        "!(load 1)", "!(help)",
    ]


def run_transcript(repl, error_types, forms) -> list:
    lines = []
    for form in forms:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                repl.load_string(form)
            except error_types as e:
                print(f"{type(e).__name__}: {e}")
        lines.extend(out.getvalue().splitlines())
    return lines


def test_meta_command_transcript_matches_jax(tmp_path, monkeypatch):
    dump = tmp_path / "dump.json"
    loaded = tmp_path / "loaded.lurk"
    loaded.write_text("!(def y-from-file (+ 2 1))\n(* y-from-file 2)\n")
    forms = transcript_forms(dump, loaded)
    runs = {}
    for name in ("jax", "port"):
        cache = tmp_path / name
        monkeypatch.setenv("LURK_TPU_CACHE", str(cache))
        if name == "jax":
            repl = JaxRepl(JaxStore(JAX_BN256, use_device=False), rc=4,
                           limit=100_000)
            errors = (JaxReplError, Exception)
        else:
            repl = Repl(BN256_SCALAR, rc=4, limit=100_000, device="cpu")
            errors = (ReplError, Exception)
        lines = run_transcript(repl, errors, forms)
        files = {p.relative_to(cache).as_posix(): p.read_bytes()
                 for p in sorted(cache.rglob("*.json"))}
        runs[name] = (lines, files, dump.read_bytes())
    (lines, files, dumped), (jlines, jfiles, jdumped) = \
        runs["port"], runs["jax"]
    for k, (a, b) in enumerate(zip(lines, jlines)):
        assert a == b, f"line {k}"
    assert len(lines) == len(jlines)
    assert files == jfiles and dumped == jdumped
    # the transcript reached every kind of line it was written for
    text = "\n".join(lines)
    for expected in ("[3 iterations] => 3", "=> (13 . 17)",
                     "Data for 0x", "Next callable: 0x", "Hash: 0x",
                     "Data dumped to", "Loading ", "ReplError: assertion",
                     "ReplError: assert-error failed",
                     "ReplError: commitment 0x7b not found",
                     "ReplError: unsupported meta command: frobnicate",
                     "Available meta commands:", "my-protocol",
                     "<ENV ((z . 9)", "[3 iterations] => 6"):
        assert expected in text, expected
    assert len(files) == 4


def test_cli_repl_reads_stdin_on_the_cpu(repl_children):
    out, err, rc = repl_children["cpu"]
    assert rc == 0, err
    assert "[3 iterations] => 3" in out


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the error of a machine without a card")
def test_cli_without_device_flag_needs_a_card(repl_children):
    out, err, rc = repl_children["default"]
    assert rc != 0
    assert "torch.cuda.is_available() is False" in err
    assert "[3 iterations]" not in out
