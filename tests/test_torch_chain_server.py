"""The port's chain server (``lurk_tpu_torch.cli.chain_server``) against
the JAX package's on the CPU, without proofs (the proved stream is
``tests/test_torch_chain_stream.py``). JSON and bytes only: tolerance 0.

- ``ChainState`` (``prove=False``) on both counters of
  ``tests/test_chain_server.py`` (the plain ``cons`` and the ``commit``
  form): three responses equal to the JAX ones as JSON, the same
  session and commitment files, and a session dumped by either package
  resumes in a fresh store of the other to the same fourth response.
  ``StreamState`` without proofs likewise on the plain counter, and its
  ``resume`` raises ``ValueError`` on a session that is not a stream's
  or of another field.
- The transports: HTTP ``/config`` and ``/chain`` on port 0 against the
  JAX server's answers; the gRPC round trip (when ``grpc`` is
  installed) against the JAX server, from both clients;
  ``_pb_wrap``/``_pb_unwrap`` byte for byte against the JAX ones at the
  varint's edges; importing the module imports no ``grpc``.
- ``ChainState.resume`` loads the commitment from ``$LURK_TPU_CACHE``
  in a fresh store, also in a child under ``python -O``, and raises
  ``ValueError`` without it; the entry point exits 1 with its default
  device (``cuda``) here, and serves with ``--device cpu``.

The children (``-O``, the entry point twice, the import check) start
together with the module's first test.
"""

import contextlib
import json
import os
import pathlib
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import lurk_tpu.cli.chain_server as jcs
from lurk_tpu.fields import BN256_SCALAR as JAX_BN256
from lurk_tpu.lem import evaluation as jev
from lurk_tpu.parser import read_with_default_state as jax_read
from lurk_tpu.store.core import Store as JaxStore
from lurk_tpu_torch.cli import chain_server as cs
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.lem import evaluation as ev
from lurk_tpu_torch.parser import read_with_default_state
from lurk_tpu_torch.store.core import Store
from test_torch_field import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
COUNTER = """(letrec ((add (lambda (counter x)
                  (let ((counter (+ counter x)))
                    (cons counter (add counter))))))
              (add 0))"""
COMMIT_COUNTER = ("(letrec ((add (lambda (counter x)"
                  " (let ((counter (+ counter x)))"
                  " (cons counter (commit (add counter)))))))"
                  " (add 0))")
PB_LENGTHS = [0, 1, 127, 128, 16383, 16384]

# ChainState.resume of a session in a fresh store, in a process of its
# own (run under python -O): the commitment comes from $LURK_TPU_CACHE
RESUME_CHILD = r'''
import json, pathlib, sys
from lurk_tpu_torch.cli.chain_server import ChainState
from lurk_tpu_torch.fields import BN256_SCALAR
from lurk_tpu_torch.store.core import Store
assert not __debug__, "run with python -O"
store = Store(BN256_SCALAR, device="cpu")
state = ChainState.resume(pathlib.Path(sys.argv[1]), store)
print(json.dumps(state.chain(store.num(int(sys.argv[2])), prove=False)))
'''


def port_store() -> Store:
    return Store(BN256_SCALAR, device="cpu")


def jax_store() -> JaxStore:
    return JaxStore(JAX_BN256, use_device=False)


def port_callable(store, src):
    return ev.evaluate(None, read_with_default_state(store, src), store,
                       1000)[-1].output[0]


def jax_callable(store, src):
    return jev.evaluate(None, jax_read(store, src), store,
                        1000)[-1].output[0]


def js(resp: dict) -> dict:
    """A response as a JSON client reads it."""
    return json.loads(json.dumps(resp))


def result_of(resp: dict) -> int:
    return int(resp["result"]["root"]["digest"], 16)


def child_env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
            **extra}


def http(port: int, path: str, body=None):
    """(status, JSON) of a GET, or of a POST when ``body`` is given."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    os.environ.setdefault("LURK_TPU_CACHE",
                          str(tmp_path_factory.mktemp("pp_cache")))
    return pathlib.Path(os.environ["LURK_TPU_CACHE"])


@pytest.fixture(scope="module", autouse=True)
def children(tmp_path_factory, cache):
    """The light children, started at once: a ChainState session resumed
    under python -O (the parent writes it and its commitments first),
    the entry point with its default device, the entry point serving on
    the CPU, and an import of the module."""
    d = tmp_path_factory.mktemp("chain_children")
    store = port_store()
    state = cs.ChainState(store, port_callable(store, COMMIT_COUNTER), rc=4,
                          limit=1000)
    for n in (3, 4):
        state.chain(store.num(n), prove=False)
    state.dump_session(d / "session.json")
    py = sys.executable
    procs = {
        "resume_O": [py, "-O", "-c", RESUME_CHILD, str(d / "session.json"),
                     "5"],
        "default_device": [py, "-m", "lurk_tpu_torch.cli.chain_server",
                           "--callable", "(lambda (x) x)"],
        "serve_cpu": [py, "-m", "lurk_tpu_torch.cli.chain_server",
                      "--device", "cpu", "--port", "0", "--rc", "2",
                      "--callable", COUNTER],
        "imports": [py, "-c", "import sys, lurk_tpu_torch.cli.chain_server; "
                    "print(sorted(m for m in sys.modules "
                    "if m.split('.')[0] == 'grpc'))"],
    }
    started = {name: subprocess.Popen(cmd, cwd=ROOT, env=child_env(),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
               for name, cmd in procs.items()}
    try:
        yield dict(procs=started, session=d / "session.json")
    finally:
        for proc in started.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


# ---------------------------------------------------------------------------
# the states without proofs, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", [COUNTER, COMMIT_COUNTER],
                         ids=["cons", "commit"])
def test_chain_state_matches_jax(src, tmp_path, monkeypatch):
    """Three responses as JSON, the session and commitment files; each
    package resumes the other's session (with the other's commitment
    files) in a fresh store to the same fourth response."""
    jax_cache, port_cache = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setenv("LURK_TPU_CACHE", str(jax_cache))
    jstore = jax_store()
    jstate = jcs.ChainState(jstore, jax_callable(jstore, src), rc=4,
                            limit=1000)
    jresps = [js(jstate.chain(jstore.num(n), prove=False)) for n in (3, 4, 5)]
    jstate.dump_session(tmp_path / "jax.json")
    monkeypatch.setenv("LURK_TPU_CACHE", str(port_cache))
    store = port_store()
    state = cs.ChainState(store, port_callable(store, src), rc=4, limit=1000)
    resps = [js(state.chain(store.num(n), prove=False)) for n in (3, 4, 5)]
    state.dump_session(tmp_path / "port.json")
    assert resps == jresps
    assert [result_of(r) for r in resps] == [3, 7, 12]
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    commits = sorted(os.listdir(port_cache / "commits"))
    assert commits == sorted(os.listdir(jax_cache / "commits"))
    for name in commits:
        assert (port_cache / "commits" / name).read_bytes() == \
            (jax_cache / "commits" / name).read_bytes()

    monkeypatch.setenv("LURK_TPU_CACHE", str(jax_cache))
    store2 = port_store()
    got = js(cs.ChainState.resume(tmp_path / "jax.json", store2).chain(
        store2.num(10), prove=False))
    monkeypatch.setenv("LURK_TPU_CACHE", str(port_cache))
    jstore2 = jax_store()
    want = js(jcs.ChainState.resume(tmp_path / "port.json", jstore2).chain(
        jstore2.num(10), prove=False))
    assert got == want and result_of(got) == 22


def test_stream_state_without_proofs_matches_jax(tmp_path, monkeypatch):
    """The plain counter as a stream: three responses and the session
    files equal the JAX ones, and each package resumes the other's
    session to the same fourth response."""
    monkeypatch.setenv("LURK_TPU_CACHE", str(tmp_path))
    jstore = jax_store()
    jstate = jcs.StreamState(jstore, jax_callable(jstore, COUNTER), rc=2,
                             limit=1000, session=tmp_path / "jax.json")
    jresps = [js(jstate.chain(jstore.num(n), prove=False)) for n in (3, 4, 5)]
    store = port_store()
    state = cs.StreamState(store, port_callable(store, COUNTER), rc=2,
                           limit=1000, session=tmp_path / "port.json")
    resps = [js(state.chain(store.num(n), prove=False)) for n in (3, 4, 5)]
    assert resps == jresps
    assert [result_of(r) for r in resps] == [3, 7, 12]
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    store2, jstore2 = port_store(), jax_store()
    got = cs.StreamState.resume(tmp_path / "jax.json", store2)
    want = jcs.StreamState.resume(tmp_path / "port.json", jstore2)
    assert got.calls == want.calls == 3 and got.snark is None
    assert js(got.chain(store2.num(10), prove=False)) == \
        js(want.chain(jstore2.num(10), prove=False))


def test_stream_resume_raises(tmp_path, children):
    """Not a stream session, or one of another field: ValueError (the
    JAX package asserts)."""
    with pytest.raises(ValueError, match="not a stream session"):
        cs.StreamState.resume(children["session"], port_store())
    store = port_store()
    state = cs.StreamState(store, port_callable(store, COUNTER), rc=2)
    state.dump_session(tmp_path / "s.json")
    d = json.loads((tmp_path / "s.json").read_text())
    (tmp_path / "s.json").write_text(json.dumps({**d, "field": "pallas"}))
    with pytest.raises(ValueError, match="field"):
        cs.StreamState.resume(tmp_path / "s.json", port_store())


# ---------------------------------------------------------------------------
# resume from disk and the entry point
# ---------------------------------------------------------------------------


def test_chain_state_resume_loads_the_commitment(children, tmp_path,
                                                 monkeypatch):
    """A fresh store resumes the session from the commitment files, here
    and in a child under python -O, to the same response; without the
    files, ValueError."""
    store = port_store()
    state = cs.ChainState.resume(children["session"], store)
    assert state.calls == 2
    want = js(state.chain(store.num(5), prove=False))
    assert result_of(want) == 12
    out, err = children["procs"]["resume_O"].communicate(timeout=120)
    assert children["procs"]["resume_O"].returncode == 0, err
    assert json.loads(out) == want
    monkeypatch.setenv("LURK_TPU_CACHE", str(tmp_path))
    with pytest.raises(ValueError, match="neither in the store"):
        cs.ChainState.resume(children["session"], port_store())


def test_entry_point_default_device_exits_1(children):
    proc = children["procs"]["default_device"]
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 1
    assert "cuda" in err and "--device cpu" in err


def test_entry_point_serves_on_the_cpu(children):
    """``python -m lurk_tpu_torch.cli.chain_server --device cpu --port 0``
    answers /config and /chain, and stops on an interrupt."""
    proc = children["procs"]["serve_cpu"]
    line = proc.stdout.readline()
    assert line.startswith("chain server listening on 127.0.0.1:"), line
    port = int(line.rsplit(":", 1)[1])
    status, cfg = http(port, "/config")
    assert status == 200 and cfg["rc"] == 2 and cfg["calls"] == 0
    status, out = http(port, "/chain", {"arg_num": 3})
    assert status == 200 and result_of(out) == 3 and "proof_steps" not in out
    proc.send_signal(signal.SIGINT)
    proc.communicate(timeout=60)
    assert proc.returncode == 0


def test_importing_the_module_imports_no_grpc(children):
    proc = children["procs"]["imports"]
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert out.strip() == "[]"


# ---------------------------------------------------------------------------
# the transports
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def http_servers(cache):
    """The port's and the JAX package's HTTP servers on the counter, each
    on a free port."""
    store, jstore = port_store(), jax_store()
    servers = [cs.serve(cs.ChainState(store, port_callable(store, COUNTER),
                                      limit=1000), port=0),
               jcs.serve(jcs.ChainState(jstore, jax_callable(jstore, COUNTER),
                                        limit=1000), port=0)]
    try:
        yield [s.server_address[1] for s in servers]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_http_endpoints_match_jax(cache):
    four = port_store()
    z_dag_arg = cs._dump_ptr(four.num(4), four)
    with http_servers(cache) as (port, jport):
        for path, body in (("/config", None), ("/chain", {"arg_num": 10}),
                           ("/chain", {"arg_zdag": z_dag_arg}),
                           ("/config", None), ("/chain", {}),
                           ("/nowhere", None), ("/nowhere", {})):
            got, want = http(port, path, body), http(jport, path, body)
            assert got == want, (path, body)
        assert got[0] == 404
        status, cfg = http(port, "/config")
        assert status == 200 and cfg["field"] == "bn256" and cfg["calls"] == 2
        status, out = http(port, "/chain", {"arg_num": 1})
        assert result_of(out) == 15 and out["next_callable"].startswith("0x")
        assert http(port, "/chain", {})[0] == 400


def test_grpc_round_trip(cache):
    """Config and two chained calls over gRPC, from the port's client
    and the JAX one, against the JAX server's answers."""
    pytest.importorskip("grpc")
    store, jstore = port_store(), jax_store()
    server, port = cs.serve_grpc(cs.ChainState(
        store, port_callable(store, COMMIT_COUNTER), rc=5, limit=1000), 0)
    jserver, jport = jcs.serve_grpc(jcs.ChainState(
        jstore, jax_callable(jstore, COMMIT_COUNTER), rc=5, limit=1000), 0)
    client = cs.GrpcChainClient(f"127.0.0.1:{port}")
    jclient = jcs.GrpcChainClient(f"127.0.0.1:{jport}")
    try:
        cfg = client.config()
        assert cfg == jclient.config()
        assert cfg["field"] == "bn256" and cfg["rc"] == 5
        r1 = client.chain("9", prove=False)
        r2 = client.chain("12", prove=False)
        assert [r1, r2] == [jclient.chain("9", prove=False),
                            jclient.chain("12", prove=False)]
        assert [result_of(r1), result_of(r2)] == [9, 21]
        assert r1["next_callable"] != r2["next_callable"]
        assert jcs.GrpcChainClient(f"127.0.0.1:{port}").config() == \
            client.config() != cfg
    finally:
        client.close()
        server.stop(0)
        jserver.stop(0)


@pytest.mark.parametrize("n", PB_LENGTHS)
def test_pb_framing_matches_jax(n):
    data = np.random.default_rng(n).bytes(n)
    wrapped = cs._pb_wrap(data)
    assert wrapped == jcs._pb_wrap(data)
    assert cs._pb_unwrap(wrapped) == jcs._pb_unwrap(wrapped) == data


def test_pb_unwrap_rejects_another_field():
    assert cs._pb_unwrap(b"") == b""
    with pytest.raises(ValueError, match="field 1"):
        cs._pb_unwrap(b"\x12\x01x")
