"""Lurk REPL: interactive evaluation, meta commands, proving.

The port of the JAX package's ``cli/repl.py``: the same meta commands,
printing the same lines and raising the same ``ReplError`` messages,
and writing the same proof, meta and commitment files
(:mod:`.lurk_proof`). A ``Repl`` runs on one device (default ``cuda``,
which raises without a card; ``"cpu"`` takes the plain paths): its
store hydrates there and every prover and public-parameter call of
``prove_frames`` and ``verify_proof_key`` commits there.

Parity: reference src/cli/repl/mod.rs (Repl, handle_non_meta /
handle_meta, prove_frames) and meta_cmd.rs (the meta command table).
Implemented meta commands: load, def, defrec, assert, assert-eq,
assert-error, assert-emitted, hide, commit, fetch, open, clear, set-env,
current-env, prove, verify, inspect, inspect-full, defpackage, import,
in-package, dump-data, def-load-data, defprotocol, prove-protocol,
verify-protocol, call, chain, help.

NIVC proofs (``supernova`` and ``supernova-fold``) verify with circuit
0's shape only: a proof with a step of any other circuit index needs
coprocessors, which are not ported, and is refused.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..fields import BN256_SCALAR, FieldSpec
from ..lem import Channel, dummy_channel, evaluation as ev
from ..lem.eval_step import eval_step
from ..lem.interpreter import EvalError, Frame
from ..parser import read_maybe_meta
from ..proof.multiframe import MultiFrame
from ..proof.nova import R1CSShape
from ..proof.params_cache import cache_base, cached_shape, shape_cache_key
from ..store.core import ATOM, Ptr, Store, ZPtr
from ..store.printer import fmt_to_string
from ..store.zdag import ZDag
from ..symbol import Package, State
from ..tags import ContTag, ExprTag
from .lurk_proof import Commitment, LurkProof, LurkProofMeta


@dataclasses.dataclass
class Evaluation:
    frames: List[Frame]
    iterations: int


class ReplError(Exception):
    pass


class Repl:
    def __init__(self, field: FieldSpec = BN256_SCALAR, rc: int = 10,
                 limit: int = 100_000_000,
                 backend: str = "supernova-cycle",
                 compress: bool = True, device=None):
        self.store = store = Store(field, device)
        self.device = store.device
        self.state = State.init_lurk_state()
        self.rc = rc
        self.limit = limit
        self.backend = backend
        # reference parity: always compress before persisting
        # (repl/mod.rs:263-409 -> nova.rs:331); --no-compress opts out
        self.compress = compress
        self.env = store.intern_empty_env()
        self.evaluation: Optional[Evaluation] = None
        self.channel: Channel = dummy_channel()
        self.lang = ev.Lang()
        self.nil = store.intern_nil()

    # -- printing ----------------------------------------------------------

    def fmt(self, ptr: Ptr) -> str:
        return fmt_to_string(ptr, self.store, self.state)

    def print_io(self, frames: List[Frame]) -> None:
        out = frames[-1].output
        iters = len(frames)
        it = "iteration" if iters == 1 else "iterations"
        cont = out[2].tag
        if cont == ContTag.Terminal:
            print(f"[{iters} {it}] => {self.fmt(out[0])}")
        elif cont == ContTag.Error:
            print(f"Evaluation encountered an error after {iters} {it}")
        else:
            print(f"Limit reached after {iters} {it}")

    # -- evaluation --------------------------------------------------------

    def eval_expr_and_memoize(self, expr: Ptr) -> Tuple[List[Ptr], int]:
        frames = ev.evaluate_with_env(None, expr, self.env, self.store,
                                      self.limit, self.channel)
        iterations = len(frames)
        output = frames[-1].output
        self.evaluation = Evaluation(frames, iterations)
        return output, iterations

    def eval_expr(self, expr: Ptr) -> List[Ptr]:
        """Evaluate without memoizing; raises on error continuation."""
        out, _ = ev.evaluate_simple_with_env_and_cont(
            None, expr, self.env, self.store.cont_outermost(), self.store,
            self.limit, self.channel)
        if out[2].tag == ContTag.Error:
            raise ReplError(f"evaluation error on {self.fmt(expr)}")
        return out

    def handle_non_meta(self, expr: Ptr) -> None:
        frames = ev.evaluate_with_env(None, expr, self.env, self.store,
                                      self.limit, self.channel)
        self.evaluation = Evaluation(frames, len(frames))
        self.print_io(frames)

    # -- proving -----------------------------------------------------------

    def proof_claim(self, inp: List[Ptr], out: List[Ptr]) -> Ptr:
        s = self.store
        cont_in = s.hash_ptr(inp[2])
        cont_out = s.hash_ptr(out[2])
        return s.list([
            s.key("expr"), inp[0],
            s.key("env"), inp[1],
            s.key("cont"), s.cons(s.num(cont_in.tag),
                                  s.num(cont_in.digest)),
            s.key("expr-out"), out[0],
            s.key("env-out"), out[1],
            s.key("cont-out"), s.cons(s.num(cont_out.tag),
                                      s.num(cont_out.digest)),
        ])

    def proof_key(self, claim_hash: str) -> str:
        return f"{self.backend}_{self.store.field.name}_{self.rc}_" \
            f"{claim_hash}"

    def prove_frames(self, frames: List[Frame], iterations: int) -> str:
        s = self.store
        # every wave hashed before the claim is interned and before a
        # cycle prover forks its pool: a forked worker must not hash
        s.hydrate_z_cache()
        inp, out = frames[0].input, frames[-1].output
        z_dag = ZDag()
        cache: Dict[Ptr, object] = {}
        zs = [z_dag.populate_with(p, s, cache) for p in inp + out]
        claim = self.proof_claim(list(inp), list(out))
        claim_comm = Commitment.new(0, claim, s)
        claim_hash = f"{claim_comm.digest:064x}"
        proof_key = self.proof_key(claim_hash)
        if not LurkProof.is_cached(proof_key):
            proof, kind = self._prove(frames)
            LurkProof(proof, self.rc, s.field.name,
                      self.backend, kind).persist(proof_key)
        LurkProofMeta(iterations, (zs[0], zs[3]), (zs[1], zs[4]),
                      (zs[2], zs[5]), z_dag).persist(proof_key)
        claim_comm.persist()
        print(f"Claim hash: 0x{claim_hash}")
        print(f'Proof key: "{proof_key}"')
        return proof_key

    def _prove(self, frames: List[Frame]) -> Tuple[object, str]:
        """The backend's proof of ``frames``, compressed unless
        ``compress`` is off, and its kind; each proof checked by its
        verifier before it is returned."""
        s, dev = self.store, self.device
        if self.backend == "nova":
            from ..proof import prover_cycle as pcy
            pp, proof = pcy.CycleNovaProver(
                rc=self.rc, lang=self.lang, device=dev
            ).prove_from_frames(s, frames)
            compress, verify, verify_compressed = (
                pcy.compress_cycle, pcy.CycleNovaProver.verify,
                pcy.verify_compressed_cycle)
        elif self.backend == "supernova-cycle":
            from ..proof import prover_supernova_cycle as psc
            pp, proof = psc.SuperNovaCycleProver(
                rc=self.rc, lang=self.lang, device=dev
            ).prove_from_frames(s, frames)
            compress, verify, verify_compressed = (
                psc.compress_sn_cycle, psc.SuperNovaCycleProver.verify,
                psc.verify_compressed_sn_cycle)
        elif self.backend.startswith("supernova"):
            from ..proof import supernova as sn
            pp, proof = sn.SuperNovaProver(
                self.rc, self.lang, device=dev
            ).prove_from_frames(s, frames)
            compress, verify, verify_compressed = (
                sn.compress, sn.verify, sn.verify_compressed)
        else:
            from ..proof import spartan
            from ..proof.prover import NovaProver
            pp, proof = NovaProver(
                rc=self.rc, lang=self.lang, device=dev
            ).prove_from_frames(s, frames)
            compress, verify, verify_compressed = (
                spartan.compress, NovaProver.verify, _verify_compressed_ivc)
        kind = "recursive"
        if self.compress:
            proof = compress(pp, proof)
            kind = "compressed"
            ok = verify_compressed(pp, proof)
        else:
            ok = verify(pp, proof)
        if not ok:
            raise ReplError("self-check failed")
        return proof, kind

    def prove_last_frames(self) -> str:
        if self.evaluation is None:
            raise ReplError("no evaluation to prove")
        return self.prove_frames(self.evaluation.frames,
                                 self.evaluation.iterations)

    def verify_proof_key(self, proof_key: str) -> bool:
        lp = LurkProof.load(proof_key)
        if lp is None:
            raise ReplError(f"proof {proof_key} not found")
        s, dev = self.store, self.device
        compressed = lp.kind == "compressed"
        if lp.backend == "supernova-cycle":
            from ..proof import prover_supernova_cycle as psc
            prover = psc.SuperNovaCycleProver(rc=lp.rc, lang=self.lang)
            lurk_step, cprocs = prover.setup_funcs()
            pp = psc.sn_cycle_public_params(s, lp.rc, lurk_step, cprocs,
                                            self.lang, dev)
            verify = (psc.verify_compressed_sn_cycle if compressed
                      else psc.SuperNovaCycleProver.verify)
        elif lp.backend == "nova":
            from ..proof import prover_cycle as pcy
            prover = pcy.CycleNovaProver(rc=lp.rc, lang=self.lang)
            pp = pcy.cycle_public_params(s, lp.rc, prover.step_func(),
                                         self.lang, dev)
            verify = (pcy.verify_compressed_cycle if compressed
                      else pcy.CycleNovaProver.verify)
        elif lp.backend.startswith("supernova"):
            from ..proof import supernova as sn
            pcs = {pc for pc, _, _ in lp.proof.steps}
            if pcs != {0}:
                raise ReplError(
                    f"the proof has steps of circuits {sorted(pcs - {0})}, "
                    f"which need coprocessors; coprocessors are not ported "
                    f"yet (ROADMAP.md, section 1, item 8)")
            lurk_step = sn.SuperNovaProver(lp.rc, self.lang).lurk_step
            key = shape_cache_key(s.field.name, lp.rc, lurk_step) + "-nivc"
            shape = self._cached_step_shape(key, lp.rc, lurk_step)
            pp = sn.SuperNovaPublicParams.setup({0: shape}, dev)
            verify = sn.verify_compressed if compressed else sn.verify
        else:
            from ..proof.prover import NovaProver, public_params
            step = eval_step()
            key = shape_cache_key(s.field.name, lp.rc, step)
            pp = public_params(self._cached_step_shape(key, lp.rc, step),
                               dev)
            verify = (_verify_compressed_ivc if compressed
                      else NovaProver.verify)
        ok = verify(pp, lp.proof)
        print("✓ Proof verified" if ok else "✗ Proof failed on verification")
        return ok

    def _cached_step_shape(self, key: str, rc: int, lurk_step):
        """The uniform step shape at ``rc`` from the disk cache (where
        the prove saved it), else synthesized on a nil evaluation and
        saved."""
        s = self.store

        def synthesize() -> R1CSShape:
            frames = ev.evaluate(None, self.nil, s, rc)
            s.hydrate_z_cache()
            mfs = MultiFrame.from_frames(frames, rc, lurk_step, s)
            _, _, cs = mfs[0].instance(lurk_step, s)
            return R1CSShape(cs)

        return cached_shape(key, s.field, synthesize)

    # -- reading ------------------------------------------------------------

    def read_eval_first(self, args: Ptr) -> Tuple[Ptr, List[Ptr]]:
        """(first . rest) -> (evaluated first, rest elements)."""
        first, rest = self.store.car_cdr(args)
        out = self.eval_expr(first)
        lst = self.store.fetch_proper_list(rest)
        return out[0], (lst or [])

    # -- meta commands -------------------------------------------------------

    def handle_meta(self, expr: Ptr) -> None:
        s = self.store
        if expr.tag != ExprTag.Cons:
            raise ReplError("meta command must be a list")
        head, args = s.car_cdr(expr)
        sym = s.fetch_symbol(head)
        if sym is None:
            raise ReplError("meta command head is not a symbol")
        name = sym.path[-1] if sym.path else ""
        handler = getattr(self, f"_meta_{name.replace('-', '_')}", None)
        if handler is None:
            raise ReplError(f"unsupported meta command: {name}")
        handler(args)

    def _args(self, args: Ptr, n: Optional[int] = None) -> List[Ptr]:
        lst = self.store.fetch_proper_list(args)
        if lst is None:
            raise ReplError("meta command arguments must be a proper list")
        if n is not None and len(lst) != n:
            raise ReplError(f"expected {n} arguments, got {len(lst)}")
        return lst

    def _meta_load(self, args: Ptr) -> None:
        (path_ptr,) = self._args(args, 1)
        path = self.store.fetch_string(path_ptr)
        if path is None:
            raise ReplError("load expects a string path")
        self.load_file(Path(path))

    def _meta_def(self, args: Ptr) -> None:
        sym_ptr, val_expr = self._args(args, 2)
        s = self.store
        let_ = s.intern_lurk_symbol("let")
        current_env = s.list([s.intern_lurk_symbol("current-env")])
        binding = s.list([sym_ptr, val_expr])
        expr = s.list([let_, s.list([binding]), current_env])
        out = self.eval_expr(expr)
        self.env = out[0]
        print(self.fmt(sym_ptr))

    def _meta_defrec(self, args: Ptr) -> None:
        sym_ptr, val_expr = self._args(args, 2)
        s = self.store
        letrec = s.intern_lurk_symbol("letrec")
        current_env = s.list([s.intern_lurk_symbol("current-env")])
        binding = s.list([sym_ptr, val_expr])
        expr = s.list([letrec, s.list([binding]), current_env])
        out = self.eval_expr(expr)
        self.env = out[0]
        print(self.fmt(sym_ptr))

    def _meta_assert(self, args: Ptr) -> None:
        (expr,) = self._args(args, 1)
        out = self.eval_expr(expr)
        if out[0] == self.nil:
            raise ReplError(f"assertion failed: {self.fmt(expr)} is nil")

    def _meta_assert_eq(self, args: Ptr) -> None:
        e1, e2 = self._args(args, 2)
        o1 = self.eval_expr(e1)
        o2 = self.eval_expr(e2)
        s = self.store
        if s.hash_ptr(o1[0]) != s.hash_ptr(o2[0]):
            raise ReplError(
                f"assert-eq failed: {self.fmt(o1[0])} != "
                f"{self.fmt(o2[0])}")

    def _meta_assert_error(self, args: Ptr) -> None:
        (expr,) = self._args(args, 1)
        out, _ = ev.evaluate_simple_with_env_and_cont(
            None, expr, self.env, self.store.cont_outermost(), self.store,
            self.limit, self.channel)
        if out[2].tag != ContTag.Error:
            raise ReplError(
                f"assert-error failed: {self.fmt(expr)} did not error")

    def _meta_assert_emitted(self, args: Ptr) -> None:
        expected_expr, expr = self._args(args, 2)
        expected = self.eval_expr(expected_expr)[0]
        ch = dummy_channel()
        ev.evaluate_with_env(None, expr, self.env, self.store, self.limit,
                             ch)
        emitted = self.store.list(list(ch.outbound))
        s = self.store
        if s.hash_ptr(emitted) != s.hash_ptr(expected):
            raise ReplError("assert-emitted failed")

    def _meta_hide(self, args: Ptr) -> None:
        secret_expr, payload_expr = self._args(args, 2)
        secret = self.eval_expr(secret_expr)[0]
        payload = self.eval_expr(payload_expr)[0]
        sec_f = self.store.fetch_num(secret)
        if sec_f is None:
            raise ReplError("hide secret must be a Num")
        self._hide(sec_f, payload)

    def _meta_commit(self, args: Ptr) -> None:
        (payload_expr,) = self._args(args, 1)
        payload = self.eval_expr(payload_expr)[0]
        self._hide(0, payload)

    def _hide(self, secret: int, payload: Ptr) -> None:
        self.store.hydrate_z_cache()
        comm = Commitment.new(secret, payload, self.store)
        comm.persist()
        print(f"Hash: 0x{comm.digest:064x}")

    def _comm_digest(self, ptr: Ptr) -> int:
        s = self.store
        if ptr.tag not in (ExprTag.Comm, ExprTag.Num) or ptr.kind != ATOM:
            raise ReplError("expected a commitment hash")
        return s.atoms[ptr.idx]

    def _meta_fetch(self, args: Ptr) -> None:
        (expr,) = self._args(args, 1)
        digest = self._comm_digest(self.eval_expr(expr)[0])
        if not Commitment.load(digest, self.store):
            raise ReplError(f"commitment 0x{digest:x} not found")
        print(f"Data for 0x{digest:064x} is now available")

    def _meta_open(self, args: Ptr) -> None:
        (expr,) = self._args(args, 1)
        digest = self._comm_digest(self.eval_expr(expr)[0])
        if not self.store.can_open(digest):
            if not Commitment.load(digest, self.store):
                raise ReplError(f"commitment 0x{digest:x} not found")
        _, payload = self.store.open(digest)
        print(f"=> {self.fmt(payload)}")

    def _meta_clear(self, args: Ptr) -> None:
        self.env = self.store.intern_empty_env()

    def _meta_set_env(self, args: Ptr) -> None:
        (expr,) = self._args(args, 1)
        out = self.eval_expr(expr)
        if out[0].tag != ExprTag.Env:
            raise ReplError("set-env expects an Env")
        self.env = out[0]

    def _meta_current_env(self, args: Ptr) -> None:
        print(self.fmt(self.env))

    def _meta_prove(self, args: Ptr) -> None:
        lst = self._args(args)
        if lst:
            self.handle_non_meta(lst[0])
        self.prove_last_frames()

    def _meta_verify(self, args: Ptr) -> None:
        (key_ptr,) = self._args(args, 1)
        key = self.store.fetch_string(key_ptr)
        if key is None:
            raise ReplError("verify expects a proof key string")
        self.verify_proof_key(key)

    def _meta_inspect(self, args: Ptr) -> None:
        (key_ptr,) = self._args(args, 1)
        key = self.store.fetch_string(key_ptr)
        meta = LurkProofMeta.load(key)
        if meta is None:
            raise ReplError(f"no proof meta for {key}")
        print(f"Iterations: {meta.iterations}")
        print(f"Expr: tag {meta.expr_io[0].tag:#06x} "
              f"digest 0x{meta.expr_io[0].digest:x}")
        print(f"Expr-out: tag {meta.expr_io[1].tag:#06x} "
              f"digest 0x{meta.expr_io[1].digest:x}")

    def _meta_inspect_full(self, args: Ptr) -> None:
        (key_ptr,) = self._args(args, 1)
        key = self.store.fetch_string(key_ptr)
        meta = LurkProofMeta.load(key)
        if meta is None:
            raise ReplError(f"no proof meta for {key}")
        print(f"Iterations: {meta.iterations}")
        s = self.store
        # reconstruct the claim IO from the zdag for full display
        for label, (zin, zout) in (("Expr", meta.expr_io),
                                   ("Env", meta.env_io),
                                   ("Cont", meta.cont_io)):
            pin = meta.z_dag.populate_store(zin, s)
            pout = meta.z_dag.populate_store(zout, s)
            print(f"{label}: {self.fmt(pin)}")
            print(f"{label}-out: {self.fmt(pout)}")

    def _meta_defpackage(self, args: Ptr) -> None:
        (name_ptr,) = self._args(args, 1)
        name = self.store.fetch_symbol(name_ptr)
        if name is None:
            name_str = self.store.fetch_string(name_ptr)
            if name_str is None:
                raise ReplError("defpackage expects a symbol or string")
            name = self.state.intern(name_str)
        self.state.add_package(Package(name))

    def _meta_import(self, args: Ptr) -> None:
        lst = self._args(args)
        for ptr in lst:
            sym = self.store.fetch_symbol(ptr)
            if sym is None:
                raise ReplError("import expects symbols")
            self.state.import_symbols([sym])

    def _meta_in_package(self, args: Ptr) -> None:
        (name_ptr,) = self._args(args, 1)
        name_str = self.store.fetch_string(name_ptr)
        if name_str is not None:
            self.state.set_current_package(self.state.intern(name_str))
            return
        sym = self.store.fetch_symbol(name_ptr)
        if sym is None:
            raise ReplError("in-package expects a symbol or string")
        self.state.set_current_package(sym)

    def _meta_dump_data(self, args: Ptr) -> None:
        expr_ptr, path_ptr = self._args(args, 2)
        path = self.store.fetch_string(path_ptr)
        out = self.eval_expr(expr_ptr)
        self.store.hydrate_z_cache()
        z_dag = ZDag()
        z = z_dag.populate_with(out[0], self.store)
        Path(path).write_text(json.dumps({
            "root": {"tag": z.tag, "digest": f"{z.digest:x}"},
            "zdag": z_dag.to_json(),
        }))
        print(f"Data dumped to {path}")

    def _meta_def_load_data(self, args: Ptr) -> None:
        sym_ptr, path_ptr = self._args(args, 2)
        path = self.store.fetch_string(path_ptr)
        data = json.loads(Path(path).read_text())
        z_dag = ZDag.from_json(data["zdag"])
        root = ZPtr(data["root"]["tag"], int(data["root"]["digest"], 16))
        ptr = z_dag.populate_store(root, self.store)
        s = self.store
        quote = s.intern_lurk_symbol("quote")
        self._meta_def(s.list([sym_ptr, s.list([quote, ptr])]))

    def _meta_call(self, args: Ptr) -> None:
        """Build ((open <hash>) <args>...) exactly like the reference
        (meta_cmd.rs fn call) — the claim binds the INPUT expression, so
        its shape must match for proof-key parity with the demos."""
        s = self.store
        hash_expr, rest = s.car_cdr_simple(args)
        callable_ = self.eval_expr(hash_expr)[0]
        if callable_.tag in (ExprTag.Comm, ExprTag.Num):
            digest = self._comm_digest(callable_)
            if not self.store.can_open(digest):
                Commitment.load(digest, self.store)
        else:
            raise ReplError("call expects a commitment hash")
        open_sym = s.intern_lurk_symbol("open")
        open_expr = s.list([open_sym, s.num(digest)])
        arg_list = s.fetch_proper_list(rest)
        if arg_list is None:
            raise ReplError("call arguments must be a proper list")
        call_expr = s.list([open_expr] + arg_list)
        self.handle_non_meta(call_expr)

    def _meta_chain(self, args: Ptr) -> None:
        """Chained functional commitment: call, then commit to the next
        callable (meta_cmd.rs chain)."""
        self._meta_call(args)
        out = self.evaluation.frames[-1].output[0]
        lst = self.store.fetch_cons(out)
        if lst is None:
            raise ReplError("chain result must be a pair")
        _, next_callable = lst
        if next_callable.tag != ExprTag.Comm:
            raise ReplError("second component of a chain must be a "
                            "commitment")
        # the next callable IS already a commitment made during
        # evaluation — persist THAT opening (meta_cmd.rs chain re-hides
        # with the commitment's own secret, not a fresh commitment)
        self.store.hydrate_z_cache()
        digest = self.store.hash_ptr(next_callable).digest
        opened = self.store.open(digest)
        if opened is None:
            raise ReplError("chained commitment was not opened in-store")
        secret, fun = opened
        comm = Commitment.new(secret, fun, self.store)
        assert comm.digest == digest
        comm.persist()
        print(f"Next callable: 0x{comm.digest:064x}")

    # -- protocols (meta_cmd.rs:689-1033) -----------------------------------

    def _get_properties(self, props: List[Ptr],
                        keys: List[str]) -> Dict[str, Ptr]:
        """Find `:key value` pairs for the KNOWN keys; unknown keywords
        are silently ignored (repl/mod.rs:244-260 scans the list for
        each known key only — the reference demos use e.g. :descr)."""
        out: Dict[str, Ptr] = {}
        s = self.store
        for key in keys:
            key_ptr = s.key(key)
            for i, ptr in enumerate(props):
                if ptr == key_ptr and i + 1 < len(props):
                    out[key] = props[i + 1]
                    break
        return out

    def _meta_defprotocol(self, args: Ptr) -> None:
        lst = self._args(args)
        if len(lst) < 3:
            raise ReplError("defprotocol expects (name vars body props...)")
        name_ptr, vars_ptr, body = lst[0], lst[1], lst[2]
        props = self._get_properties(
            lst[3:], ["backend", "rc", "lang", "description"])
        s = self.store
        lam = s.list([s.intern_lurk_symbol("lambda"), vars_ptr, body])
        out = ev.evaluate_simple_with_env_and_cont(
            None, lam, s.intern_empty_env(), s.cont_outermost(), s,
            self.limit, self.channel)[0]
        fun = out[0]
        if fun.tag != ExprTag.Fun:
            raise ReplError("protocol definition must evaluate to a "
                            "function")
        backend = props.get("backend", s.intern_string(self.backend))
        rc = props.get("rc", s.num(self.rc))
        lang_p = props.get("lang", self.nil)
        description = props.get("description", s.intern_string(""))
        protocol = s.list([fun, backend, rc, lang_p, description])
        self.env = s.push_binding(name_ptr, protocol, self.env)
        print(self.fmt(name_ptr))

    def _protocol_parts(self, ptcl_expr: Ptr):
        """Evaluate a protocol expression -> (fun, backend, rc)."""
        s = self.store
        out = self.eval_expr(ptcl_expr)
        lst = s.fetch_proper_list(out[0])
        if lst is None or len(lst) != 5:
            raise ReplError("not a protocol value")
        fun, backend_p, rc_p, _lang, _desc = lst
        backend = s.fetch_string(backend_p)
        rc = s.fetch_num(rc_p)
        if backend is None or rc is None:
            raise ReplError("malformed protocol")
        return fun, backend, rc

    def _cont_from_key(self, key_ptr: Ptr) -> Ptr:
        s = self.store
        sym = s.fetch_symbol(key_ptr)
        name = sym.path[-1] if sym and sym.path else None
        if name == "outermost":
            return s.cont_outermost()
        if name == "terminal":
            return s.cont_terminal()
        if name == "error":
            return s.cont_error()
        raise ReplError(f"invalid continuation key {self.fmt(key_ptr)}")

    def _run_protocol_fn(self, fun: Ptr, args_evaled: List[Ptr]):
        """Apply the protocol fn to quoted args -> (cek_io, post_verify)."""
        s = self.store
        quote = s.intern_lurk_symbol("quote")
        call = s.list([fun] + [s.list([quote, a]) for a in args_evaled])
        out = ev.evaluate_simple_with_env_and_cont(
            None, call, s.intern_empty_env(), s.cont_outermost(), s,
            self.limit, self.channel)[0]
        if out[2].tag == ContTag.Error:
            raise ReplError("protocol function call errored")
        pair = s.fetch_cons(out[0])
        if pair is None:
            raise ReplError("protocol function must return a pair")
        pre_verify, post_verify = pair
        if pre_verify.tag == ExprTag.Nil:
            raise ReplError("pre-verification predicate rejected the "
                            "input")
        cek_io = s.fetch_proper_list(pre_verify)
        if cek_io is None or len(cek_io) != 6:
            raise ReplError("protocol must return a 6-element CEK io "
                            "list")
        return cek_io, post_verify

    def _post_verify_check(self, post_verify: Ptr) -> None:
        if post_verify.tag == ExprTag.Nil:
            return
        s = self.store
        call = s.list([post_verify])
        out = ev.evaluate_simple_with_env_and_cont(
            None, call, s.intern_empty_env(), s.cont_outermost(), s,
            self.limit, self.channel)[0]
        if out[0].tag == ExprTag.Nil or out[2].tag == ContTag.Error:
            raise ReplError("post-verification predicate rejected the "
                            "input")

    def _meta_prove_protocol(self, args: Ptr) -> None:
        lst = self._args(args)
        if len(lst) < 2:
            raise ReplError(
                "prove-protocol expects (protocol path args...)")
        s = self.store
        fun, backend, rc = self._protocol_parts(lst[0])
        path = s.fetch_string(lst[1])
        if path is None:
            raise ReplError("prove-protocol path must be a string")
        if rc != self.rc:
            raise ReplError(f"protocol rc={rc} != repl rc={self.rc}")
        args_evaled = [self.eval_expr(a)[0] for a in lst[2:]]
        cek_io, post_verify = self._run_protocol_fn(fun, args_evaled)
        self._post_verify_check(post_verify)
        frames = ev.evaluate_with_env_and_cont(
            None, cek_io[0], cek_io[1], self._cont_from_key(cek_io[2]),
            s, self.limit, self.channel)
        res = frames[-1].output
        if s.hash_ptr(res[0]) != s.hash_ptr(cek_io[3]) or \
                s.hash_ptr(res[1]) != s.hash_ptr(cek_io[4]) or \
                res[2] != self._cont_from_key(cek_io[5]):
            raise ReplError("mismatch between expected and computed "
                            "output")
        proof_key = self.prove_frames(frames, len(frames))
        # dump the protocol proof: args zdag + proof key reference
        s.hydrate_z_cache()
        z_dag = ZDag()
        args_list = s.list(args_evaled)
        z_args = z_dag.populate_with(args_list, s)
        Path(path).write_text(json.dumps({
            "args": {"root": {"tag": z_args.tag,
                              "digest": f"{z_args.digest:x}"},
                     "zdag": z_dag.to_json()},
            "proof_key": proof_key,
        }))
        print(f"Protocol proof saved at {path}")

    def _meta_verify_protocol(self, args: Ptr) -> None:
        lst = self._args(args, 2)
        s = self.store
        fun, backend, rc = self._protocol_parts(lst[0])
        path = s.fetch_string(lst[1])
        if path is None:
            raise ReplError("verify-protocol path must be a string")
        data = json.loads(Path(path).read_text())
        z_dag = ZDag.from_json(data["args"]["zdag"])
        root = ZPtr(data["args"]["root"]["tag"],
                    int(data["args"]["root"]["digest"], 16))
        args_list = z_dag.populate_store(root, s)
        args_vec = s.fetch_proper_list(args_list)
        if args_vec is None:
            raise ReplError("protocol proof args must be a list")
        cek_io, post_verify = self._run_protocol_fn(fun, args_vec)
        # check the proof's public IO against the protocol's CEK io
        lp = LurkProof.load(data["proof_key"])
        if lp is None:
            raise ReplError(f"proof {data['proof_key']} not found")
        s.hydrate_z_cache()
        expect_z0 = []
        for p in (cek_io[0], cek_io[1], self._cont_from_key(cek_io[2])):
            z = s.hash_ptr(p)
            expect_z0.extend((z.tag, z.digest))
        expect_zi = []
        for p in (cek_io[3], cek_io[4], self._cont_from_key(cek_io[5])):
            z = s.hash_ptr(p)
            expect_zi.extend((z.tag, z.digest))
        proof_z0 = list(lp.proof.z0)
        # cycle proofs name the final state zn; fold chains zi
        proof_zi = list(getattr(lp.proof, "zi", None)
                        or getattr(lp.proof, "zn"))
        if proof_z0 != expect_z0 or proof_zi != expect_zi:
            raise ReplError("proof IO does not match the protocol")
        if not self.verify_proof_key(data["proof_key"]):
            raise ReplError("proof failed verification")
        self._post_verify_check(post_verify)
        print("Protocol proof verified")

    def _meta_help(self, args: Ptr) -> None:
        cmds = sorted(
            m[6:].replace("_", "-") for m in dir(self)
            if m.startswith("_meta_"))
        print("Available meta commands:", ", ".join(cmds))

    # -- driver ---------------------------------------------------------------

    def handle_form(self, src: str, pos: int) -> Optional[int]:
        res = read_maybe_meta(self.store, self.state, src, pos)
        if res is None:
            return None
        is_meta, ptr, next_pos = res
        if is_meta:
            self.handle_meta(ptr)
        else:
            self.handle_non_meta(ptr)
        return next_pos

    def load_string(self, src: str) -> None:
        pos = 0
        while True:
            nxt = self.handle_form(src, pos)
            if nxt is None:
                return
            pos = nxt

    def load_file(self, path: Path) -> None:
        print(f"Loading {path}")
        self.load_string(path.read_text())

    def _completion_candidates(self) -> List[str]:
        """Meta commands + every symbol interned so far (builtins from
        the eval step, user defs, package symbols)."""
        metas = [
            "!(" + name[len("_meta_"):].replace("_", "-")
            for name in dir(self)
            if name.startswith("_meta_")]
        syms = {
            sym.path[-1]
            for sym in self.store._ptr_symbol_cache.values()
            if sym.path}
        return sorted(metas) + sorted(syms)

    def _install_completer(self, readline) -> None:
        def complete(text: str, state: int):
            cands = [c for c in self._completion_candidates()
                     if c.startswith(text)]
            return cands[state] if state < len(cands) else None

        readline.set_completer(complete)
        readline.set_completer_delims(" \t\n()'\"")
        readline.parse_and_bind("tab: complete")

    def start(self) -> None:
        """Interactive readline loop (rustyline parity: tab completion
        over builtins/meta commands, persistent history like the
        reference's ~/.lurk/repl-history, here ``repl-history`` under
        the cache base ``$LURK_TPU_CACHE``, default ``~/.lurk_tpu``)."""
        import atexit
        import readline
        self._install_completer(readline)
        base = cache_base()
        base.mkdir(parents=True, exist_ok=True)
        hist = str(base / "repl-history")
        try:
            readline.read_history_file(hist)
        except OSError:
            pass
        atexit.register(lambda: _save_history(readline, hist))
        print(f"Lurk TPU REPL [{self.store.field.name}, rc={self.rc}]")
        while True:
            try:
                line = input("lurk-tpu> ")
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not line.strip():
                continue
            if line.strip() in ("exit", "quit"):
                break
            try:
                self.load_string(line)
            except (ReplError, EvalError, Exception) as e:  # noqa: BLE001
                print(f"Error: {e}")


def _save_history(readline, path: str) -> None:
    try:
        readline.set_history_length(1000)
        readline.write_history_file(path)
    except OSError:
        pass


def _verify_compressed_ivc(pp, proof) -> bool:
    """The Nova IVC's compressed proof, with its IO chain checked."""
    from ..proof import spartan
    from ..proof.multiframe import io_chain_checker
    return spartan.verify_compressed(pp, proof,
                                     io_chain_checker(proof.z0, proof.zi))
