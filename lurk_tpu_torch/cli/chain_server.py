"""Chain server: continuous proving of chained functional commitments.

The port of the JAX package's ``cli/chain_server.py``. Functionality
parity: reference chain-server/src/server.rs, a service holding a
chained callable commitment; each ``chain`` call evaluates ``(callable
arg)``, proves it, extracts the next callable from the result's cdr,
commits to it and carries the proving session across calls, with
session dump and resume to disk. :class:`StreamState` is the
reference's StreamService: one paused stream resumed by each call, one
:class:`..proof.nova_cycle.CycleSNARK` accumulator extended across
calls.

The store's device (``cuda`` by default) is where both states hash and
prove: hydration waves of 64 or more go to the Poseidon kernel, the
Nova cycle's commits to the MSM kernel. ``python -m
lurk_tpu_torch.cli.chain_server --callable SRC [--device cpu]`` serves
one over HTTP; without a card the default device makes it exit 1.

Transports: gRPC (``serve_grpc``, the reference's wire protocol,
chain-server/proto/chain-server.proto: service chain_prover.ChainProver
with Config and Chain; the single-bytes-field messages are encoded by
hand, so no codegen is needed; ``grpc`` is imported only there and in
``GrpcChainClient``) and JSON over HTTP (``serve``). Inner payloads are
JSON where the reference uses bincode. Responses and session files are
the JAX package's, key for key, so either package resumes the other's
session.

Where the JAX module asserts, this one raises ``ValueError``: a
session's commitment neither in the store nor in the cache, a session
that is not a stream's or of another field, and a message whose field
tag is not 1. ``ChainState.resume`` loads the commitment outside any
assert, so it also loads under ``python -O``.
"""

from __future__ import annotations

import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from typing import Optional

from ..device import resolve_device
from ..fields import FIELDS
from ..lem import dummy_channel
from ..lem import evaluation as ev
from ..parser import read_with_default_state
from ..proof.prover_cycle import (
    CycleNovaProver, compress_cycle, cycle_public_params,
    verify_compressed_cycle,
)
from ..store.core import Ptr, Store, ZPtr
from ..store.zdag import ZDag
from ..tags import ContTag, ExprTag
from ..utils import metrics
from .lurk_proof import Commitment, cycle_snark_from_json, cycle_snark_to_json
from .repl import Repl


def _z_json(z: ZPtr) -> dict:
    return {"tag": z.tag, "digest": f"{z.digest:x}"}


def _dump_ptr(ptr: Ptr, store: Store) -> dict:
    z_dag = ZDag()
    z = z_dag.populate_with(ptr, store)
    return {"root": _z_json(z), "zdag": z_dag.to_json()}


def _compress_and_verify(pp, proof, resp: dict) -> None:
    """Compress a cycle proof, verify the compressed proof, and record
    both in the response (``chain.compress``, ``chain.verify``)."""
    with metrics.timed("chain.compress"):
        compressed = compress_cycle(pp, proof)
    with metrics.timed("chain.verify"):
        resp["proof_verified"] = verify_compressed_cycle(pp, compressed)
    resp["proof_steps"] = proof.n


class ChainState:
    """Current callable + proving session (server.rs SessionData)."""

    def __init__(self, store: Store, callable_ptr: Ptr, rc: int = 10,
                 limit: int = 100_000):
        self.store = store
        self.callable = callable_ptr
        self.callable_digest: Optional[int] = None
        self.rc = rc
        self.limit = limit
        self.lock = threading.Lock()
        self.calls = 0

    def chain(self, arg: Ptr, prove: bool = True) -> dict:
        with self.lock:
            s = self.store
            expr = s.list([self.callable, arg])
            frames = ev.evaluate(None, expr, s, self.limit)
            out = frames[-1].output
            pair = None if out[2].tag == ContTag.Error else \
                s.fetch_cons(out[0])
            if pair is None:
                return {"error": "chain result is not a pair"}
            result, next_comm = pair
            s.hydrate_z_cache()
            if next_comm.tag == ExprTag.Comm:
                # the next callable is the commitment made in-eval:
                # persist its opening and keep the OPENED function as the
                # callable (the reference evaluates ((open hash) arg)
                # each call)
                opened = s.open(s.hash_ptr(next_comm).digest)
                if opened is None:
                    return {"error":
                            "chained commitment not opened in-store"}
                secret, fun = opened
                comm = Commitment.new(secret, fun, s)
                self.callable = fun
            else:
                comm = Commitment.new(0, next_comm, s)
                self.callable = next_comm
            comm.persist()
            self.callable_digest = comm.digest
            self.calls += 1
            resp = {
                "result": _dump_ptr(result, s),
                "next_callable": f"0x{comm.digest:064x}",
                "iterations": len(frames),
            }
            if prove:
                prover = CycleNovaProver(rc=self.rc, device=s.device)
                with metrics.timed("chain.prove"):
                    pp, proof = prover.prove_from_frames(s, frames)
                _compress_and_verify(pp, proof, resp)
            return resp

    def dump_session(self, path: Path) -> None:
        s = self.store
        digest = self.callable_digest
        if digest is None:
            s.hydrate_z_cache()
            comm = Commitment.new(0, self.callable, s)
            comm.persist()
            digest = comm.digest
        path.write_text(json.dumps({
            "field": s.field.name,
            "rc": self.rc,
            "calls": self.calls,
            "callable_comm": f"{digest:x}",
        }))

    @staticmethod
    def resume(path: Path, store: Store) -> "ChainState":
        d = json.loads(path.read_text())
        digest = int(d["callable_comm"], 16)
        if not store.can_open(digest) and not Commitment.load(digest, store):
            raise ValueError(f"the session's commitment {digest:064x} is "
                             f"neither in the store nor in the cache")
        _, fun = store.open(digest)
        state = ChainState(store, fun, rc=d["rc"])
        state.callable_digest = digest
        state.calls = d["calls"]
        return state


class StreamState:
    """Paused-stream continuation service with one incremental proof
    across calls (chain-server/src/server.rs:227-440 StreamService: one
    long streamed evaluation, each ``chain`` call resumes it with the
    next argument and extends ONE proof covering every call so far).

    The proof backend is the Nova cycle
    (``CycleNovaProver.prove_incremental``); the reference uses its
    SuperNova prover with ``previous_proof`` the same way."""

    def __init__(self, store: Store, callable_ptr: Ptr, rc: int = 10,
                 limit: int = 100_000,
                 session: Optional[Path] = None):
        self.store = store
        self.first_callable = callable_ptr
        self.callable = callable_ptr
        self.result: Optional[Ptr] = None
        self.prover = CycleNovaProver(rc=rc, device=store.device)
        self.pp = None
        self.snark = None            # live CycleSNARK accumulator
        self.rc = rc
        self.limit = limit
        self.session = session
        self.calls = 0
        self.lock = threading.Lock()

    def chain(self, arg: Ptr, prove: bool = True) -> dict:
        with self.lock:
            s = self.store
            ch = dummy_channel()
            if self.result is None:
                ch.feed(arg)
                frames = ev.start_stream(None, self.callable, s,
                                         self.limit, ch)
            else:
                ch.feed(s.intern_nil())    # no stutter
                ch.feed(arg)
                inp = [s.cons(self.result, self.callable),
                       s.intern_empty_env(), s.cont_stream_pause()]
                frames = ev.resume_stream(None, inp, s, self.limit, ch)
            out = frames[-1].output
            if out[2].tag != ContTag.StreamPause:
                return {"error": "evaluation did not pause the stream"}
            pair = s.fetch_cons(out[0])
            if pair is None:
                return {"error": "chain result is not a pair"}
            result, next_callable = pair
            s.hydrate_z_cache()
            resp = {
                "result": _dump_ptr(result, s),
                "iterations": len(frames),
                "calls": self.calls + 1,
            }
            if prove:
                with metrics.timed("chain.prove"):
                    pp, snark = self.prover.prove_incremental(
                        s, frames, init=self.snark)
                    self.pp, self.snark = pp, snark
                    proof = snark.finish()
                _compress_and_verify(pp, proof, resp)
            self.result = result
            self.callable = next_callable
            self.calls += 1
            resp["next_callable"] = _z_json(s.hash_ptr(next_callable))
            if self.session is not None:
                self.dump_session(self.session)
            return resp

    def dump_session(self, path: Path) -> None:
        """Session dump with the running accumulator (server.rs
        SessionData::pack_stream + StreamSessionData), timed as
        ``chain.dump_session``."""
        with metrics.timed("chain.dump_session"):
            s = self.store
            s.hydrate_z_cache()
            z_dag = ZDag()
            cache: dict = {}
            z_callable = z_dag.populate_with(self.callable, s, cache)
            z_first = z_dag.populate_with(self.first_callable, s, cache)
            z_result = (z_dag.populate_with(self.result, s, cache)
                        if self.result is not None else None)
            path.write_text(json.dumps({
                "kind": "stream",
                "field": s.field.name,
                "rc": self.rc,
                "limit": self.limit,
                "calls": self.calls,
                "callable": [z_callable.tag, f"{z_callable.digest:x}"],
                "first_callable": [z_first.tag, f"{z_first.digest:x}"],
                "result": ([z_result.tag, f"{z_result.digest:x}"]
                           if z_result else None),
                "zdag": z_dag.to_json(),
                "snark": (cycle_snark_to_json(self.snark)
                          if self.snark is not None else None),
            }))

    @staticmethod
    def resume(path: Path, store: Store) -> "StreamState":
        d = json.loads(path.read_text())
        if d.get("kind") != "stream":
            raise ValueError(f"{path} is not a stream session")
        if d["field"] != store.field.name:
            raise ValueError(f"the session's field {d['field']} is not the "
                             f"store's {store.field.name}")
        z_dag = ZDag.from_json(d["zdag"])

        def ptr(pair):
            return z_dag.populate_store(ZPtr(pair[0], int(pair[1], 16)),
                                        store)
        state = StreamState(store, ptr(d["callable"]), rc=d["rc"],
                            limit=d["limit"], session=path)
        state.first_callable = ptr(d["first_callable"])
        if d["result"] is not None:
            state.result = ptr(d["result"])
        if d["snark"] is not None:
            state.pp = cycle_public_params(store, d["rc"],
                                           state.prover.step_func(), None,
                                           store.device)
            state.snark = cycle_snark_from_json(d["snark"], state.pp)
        state.calls = d["calls"]
        return state


def make_handler(state):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/config":
                z = state.store.hash_ptr(state.callable)
                self._send(200, {
                    "field": state.store.field.name,
                    "rc": state.rc,
                    "callable": _z_json(z),
                    "calls": state.calls,
                })
            else:
                self._send(404, {"error": "unknown endpoint"})

        def do_POST(self):
            if self.path != "/chain":
                self._send(404, {"error": "unknown endpoint"})
                return
            length = int(self.headers.get("Content-Length", "0"))
            try:
                req = json.loads(self.rfile.read(length))
                s = state.store
                if "arg_num" in req:
                    arg = s.num(int(req["arg_num"]))
                elif "arg_zdag" in req:
                    z_dag = ZDag.from_json(req["arg_zdag"]["zdag"])
                    root = req["arg_zdag"]["root"]
                    arg = z_dag.populate_store(
                        ZPtr(root["tag"], int(root["digest"], 16)), s)
                else:
                    self._send(400, {"error": "missing arg"})
                    return
                resp = state.chain(arg, prove=req.get("prove", False))
                self._send(200, resp)
            except Exception as e:  # noqa: BLE001 - the server keeps serving
                traceback.print_exc()
                self._send(500, {"error": str(e)})

        def log_message(self, *args):
            pass

    return Handler


def serve(state, port: int = 50051) -> HTTPServer:
    """Serve ``state`` over HTTP on 127.0.0.1 from a daemon thread
    (``port`` 0: a free one, ``server.server_address[1]``)."""
    server = HTTPServer(("127.0.0.1", port), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def main(argv=None) -> int:
    import argparse
    import sys
    parser = argparse.ArgumentParser(prog="lurk_tpu_torch.cli.chain_server")
    parser.add_argument("--port", type=int, default=50051)
    parser.add_argument("--field", default="bn256", choices=list(FIELDS))
    parser.add_argument("--rc", type=int, default=10)
    parser.add_argument("--callable", required=True,
                        help="lurk source for the initial callable")
    parser.add_argument("--resume", type=Path, default=None)
    parser.add_argument("--stream", action="store_true",
                        help="paused-stream continuation service with "
                             "one incremental proof across calls "
                             "(server.rs StreamService)")
    parser.add_argument("--session", type=Path, default=None,
                        help="dump the session here after each call")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the store hashes and the prover "
                             "commits (default cuda; fails without a card)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e} (on the command line: --device cpu)",
              file=sys.stderr)
        return 1
    field = FIELDS[args.field]
    if args.resume:
        store = Store(field, device)
        kind = json.loads(args.resume.read_text()).get("kind")
        if kind == "stream":
            state = StreamState.resume(args.resume, store)
        else:
            state = ChainState.resume(args.resume, store)
    else:
        repl = Repl(field, rc=args.rc, device=device)
        store = repl.store
        out = repl.eval_expr(read_with_default_state(store, args.callable))
        if args.stream:
            state = StreamState(store, out[0], rc=args.rc,
                                session=args.session)
        else:
            state = ChainState(store, out[0], rc=args.rc)
    server = serve(state, args.port)
    print(f"chain server listening on 127.0.0.1:{server.server_address[1]}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
    return 0


# ---------------------------------------------------------------------------
# gRPC transport: the reference's wire protocol
# (chain-server/proto/chain-server.proto: service chain_prover.ChainProver
# with Config/Chain RPCs whose messages are single-`bytes` wrappers).
# The one-field proto messages are encoded by hand, so no codegen is
# needed; the inner payload stays the documented JSON encoding.
# ---------------------------------------------------------------------------


def _pb_wrap(data: bytes) -> bytes:
    """Encode `bytes field = 1` (tag 0x0a + varint length + data)."""
    out = bytearray(b"\x0a")
    n = len(data)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    return bytes(out) + data


def _pb_unwrap(msg: bytes) -> bytes:
    if not msg:
        return b""
    if msg[0] != 0x0A:
        raise ValueError(f"expected field 1 (bytes), tag {msg[0]:#04x}")
    n = 0
    shift = 0
    i = 1
    while True:
        b = msg[i]
        n |= (b & 0x7F) << shift
        shift += 7
        i += 1
        if not (b & 0x80):
            break
    return msg[i:i + n]


def serve_grpc(state, port: int = 50051):
    """Serve ChainProver over gRPC (server.rs:633-703 parity): (server,
    bound port)."""
    from concurrent import futures

    import grpc

    def config_rpc(request: bytes, context) -> bytes:
        return json.dumps({
            "field": state.store.field.name,
            "rc": state.rc,
            "callable": _z_json(state.store.hash_ptr(state.callable)),
        }).encode()

    def chain_rpc(request: bytes, context) -> bytes:
        req = json.loads(request.decode() or "{}")
        arg_ptr = _parse_arg(state, req)
        resp = state.chain(arg_ptr, prove=bool(req.get("prove", True)))
        return json.dumps(resp).encode()

    handlers = grpc.method_handlers_generic_handler(
        "chain_prover.ChainProver",
        {
            "Config": grpc.unary_unary_rpc_method_handler(
                config_rpc, request_deserializer=_pb_unwrap,
                response_serializer=_pb_wrap),
            "Chain": grpc.unary_unary_rpc_method_handler(
                chain_rpc, request_deserializer=_pb_unwrap,
                response_serializer=_pb_wrap),
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((handlers,))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server, bound


def _parse_arg(state, req: dict) -> Ptr:
    s = state.store
    if "arg_zdag" in req:
        d = req["arg_zdag"]
        z_dag = ZDag.from_json(d["zdag"])
        root = ZPtr(d["root"]["tag"], int(d["root"]["digest"], 16))
        return z_dag.populate_store(root, s)
    return read_with_default_state(s, str(req.get("arg", "nil")))


class GrpcChainClient:
    """Minimal client mirroring chain-server/src/client.rs."""

    def __init__(self, addr: str):
        import grpc
        self._channel = grpc.insecure_channel(addr)

    def _call(self, method: str, payload: bytes) -> bytes:
        fn = self._channel.unary_unary(
            f"/chain_prover.ChainProver/{method}",
            request_serializer=_pb_wrap,
            response_deserializer=_pb_unwrap)
        return fn(payload)

    def config(self) -> dict:
        return json.loads(self._call("Config", b"").decode())

    def chain(self, arg: str, prove: bool = True) -> dict:
        payload = json.dumps({"arg": arg, "prove": prove}).encode()
        return json.loads(self._call("Chain", payload).decode())

    def close(self) -> None:
        self._channel.close()


if __name__ == "__main__":
    raise SystemExit(main())
