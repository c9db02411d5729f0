"""Hash-consed content-addressed store (parity: src/lem/store_core.rs, store.rs).

Device-batched redesign of the reference's Store:
  - interning is host-side (append-only index tables, like the reference),
  - content addressing (Poseidon hashing) is deferred and batched: the
    dehydrated queue is levelized by DAG depth and each wave of at least
    ``_DEVICE_WAVE_THRESHOLD`` preimages is hashed as one batch on the
    store's device by :func:`lurk_tpu_torch.poseidon.kernel.hash_batch`
    (replacing rayon par_iter chunks, store_core.rs:256-269), or, while
    :func:`lurk_tpu_torch.parallel.sharding.prover_devices` names several
    devices, sharded over them by ``shard_hash_batch_ints``. Smaller
    waves hash on the host, one preimage at a time.

Pointers are flat named tuples (tag, kind, idx) — index-based, no field
hashing during interpretation (pointers.rs:189-197 "delay ZPtrs").
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..fields import FieldSpec
from ..parallel import sharding
from ..poseidon.host import hash_preimage
from ..poseidon import kernel as poseidon_kernel
from ..symbol import Symbol, lurk_sym
from ..tags import ContTag, ExprTag
from ..utils import tracing

# IVal kinds
ATOM = 0
TUPLE2 = 1
TUPLE3 = 2
TUPLE4 = 3
COMPACT = 4


def hash_batch(field: FieldSpec, arity: int, pres: Sequence[Sequence[int]],
               device=None) -> List[int]:
    """One wave of preimages hashed as a batch on ``device`` (K1), in
    the span ``store.hash_batch``."""
    with tracing.span("store.hash_batch", arity=arity, hashes=len(pres)):
        return poseidon_kernel.hash_batch(field, arity, pres, device=device)


class Ptr(NamedTuple):
    tag: int        # u16 tag value (ExprTag/ContTag/Op1/Op2)
    kind: int       # ATOM..COMPACT
    idx: int        # index into the kind's table

    @property
    def val(self) -> Tuple[int, int]:
        return (self.kind, self.idx)


class ZPtr(NamedTuple):
    tag: int
    digest: int


# Device-batch threshold: waves smaller than this hash on the host.
_DEVICE_WAVE_THRESHOLD = 64


class PoseidonMemo:
    """Memoizing Poseidon host hasher, one per field (PoseidonCache parity)."""

    def __init__(self, field: FieldSpec):
        self.field = field
        self._memo: Dict[Tuple[int, ...], int] = {}
        # digest -> preimage (InversePoseidonCache, used by the Trie coproc)
        self.inverse: Dict[Tuple[int, int], Tuple[int, ...]] = {}

    def hash(self, preimage: Sequence[int]) -> int:
        key = tuple(preimage)
        d = self._memo.get(key)
        if d is None:
            d = hash_preimage(self.field, key)
            self._memo[key] = d
            self.inverse[(len(key), d)] = key
        return d

    def insert(self, preimage: Tuple[int, ...], digest: int) -> None:
        self._memo[preimage] = digest
        self.inverse[(len(preimage), digest)] = preimage


class Store:
    """Lurk store: tables, interning, commitments, batched hydration.

    ``device`` is where hydration waves are hashed: ``"cuda"`` (the
    default) launches the CUDA Poseidon kernel and raises if there is no
    card; ``"cpu"`` runs the kernel's plain PyTorch version.
    """

    def __init__(self, field: FieldSpec,
                 device: "str | torch.device | None" = None):
        self.field = field
        self.poseidon = PoseidonMemo(field)
        self.device = resolve_device(device)

        self.atoms: List[int] = []
        self._atom_map: Dict[int, int] = {}
        self.tuple2: List[Tuple[Ptr, Ptr]] = []
        self._tuple2_map: Dict[Tuple[Ptr, Ptr], int] = {}
        # tuple3 table shared by Tuple3 and Compact (reference parity)
        self.tuple3: List[Tuple[Ptr, Ptr, Ptr]] = []
        self._tuple3_map: Dict[Tuple[Ptr, Ptr, Ptr], int] = {}
        self.tuple4: List[Tuple[Ptr, Ptr, Ptr, Ptr]] = []
        self._tuple4_map: Dict[Tuple[Ptr, Ptr, Ptr, Ptr], int] = {}

        self.comms: Dict[int, Tuple[int, Ptr]] = {}
        self.dehydrated: List[Tuple[int, int]] = []
        self.z_cache: Dict[Tuple[int, int], int] = {}
        self.inverse_z_cache: Dict[int, Tuple[int, int]] = {}

        self._string_ptr_cache: Dict[str, Ptr] = {}
        self._ptr_string_cache: Dict[Ptr, str] = {}
        self._symbol_ptr_cache: Dict[Symbol, Ptr] = {}
        self._ptr_symbol_cache: Dict[Ptr, Symbol] = {}

        # hashes of zero-padded preimages (Store::default parity)
        self.hash3zeros = self.poseidon.hash([0, 0, 0])
        self.hash4zeros = self.poseidon.hash([0, 0, 0, 0])
        self.hash6zeros = self.poseidon.hash([0] * 6)
        self.hash8zeros = self.poseidon.hash([0] * 8)
        self.hash3zeros_idx = self.intern_digest(self.hash3zeros)
        self.hash4zeros_idx = self.intern_digest(self.hash4zeros)
        self.hash6zeros_idx = self.intern_digest(self.hash6zeros)
        self.hash8zeros_idx = self.intern_digest(self.hash8zeros)

    # ------------------------------------------------------------------
    # core interning
    # ------------------------------------------------------------------

    def intern_digest(self, digest: int) -> int:
        idx = self._atom_map.get(digest)
        if idx is None:
            idx = len(self.atoms)
            self.atoms.append(digest)
            self._atom_map[digest] = idx
        return idx

    def fetch_digest(self, idx: int) -> int:
        return self.atoms[idx]

    def intern_atom(self, tag: int, f: int) -> Ptr:
        return Ptr(tag, ATOM, self.intern_digest(f % self.field.modulus))

    def _intern_tuple(self, table, table_map, kind, ptrs, tag,
                      digest: Optional[int]) -> Ptr:
        key = tuple(ptrs)
        idx = table_map.get(key)
        inserted = idx is None
        if inserted:
            idx = len(table)
            table.append(key)
            table_map[key] = idx
        ival = (kind, idx)
        if digest is not None:
            self.z_cache[ival] = digest
            self.inverse_z_cache[digest] = ival
        elif inserted and ival not in self.z_cache:
            self.dehydrated.append(ival)
        return Ptr(tag, kind, idx)

    def intern_tuple2(self, ptrs, tag, digest=None) -> Ptr:
        return self._intern_tuple(self.tuple2, self._tuple2_map, TUPLE2,
                                  ptrs, tag, digest)

    def intern_tuple3(self, ptrs, tag, digest=None) -> Ptr:
        return self._intern_tuple(self.tuple3, self._tuple3_map, TUPLE3,
                                  ptrs, tag, digest)

    def intern_tuple4(self, ptrs, tag, digest=None) -> Ptr:
        return self._intern_tuple(self.tuple4, self._tuple4_map, TUPLE4,
                                  ptrs, tag, digest)

    def intern_compact(self, ptrs, tag, digest=None) -> Ptr:
        return self._intern_tuple(self.tuple3, self._tuple3_map, COMPACT,
                                  ptrs, tag, digest)

    def fetch_tuple2(self, idx: int):
        return self.tuple2[idx]

    def fetch_tuple3(self, idx: int):
        return self.tuple3[idx]

    def fetch_tuple4(self, idx: int):
        return self.tuple4[idx]

    def fetch_compact(self, ptr: Ptr):
        assert ptr.kind == COMPACT
        return self.tuple3[ptr.idx]

    # ------------------------------------------------------------------
    # hashing / content addressing
    # ------------------------------------------------------------------

    def _children(self, ival: Tuple[int, int]) -> Tuple[Ptr, ...]:
        kind, idx = ival
        if kind == ATOM:
            return ()
        if kind == TUPLE2:
            return self.tuple2[idx]
        if kind in (TUPLE3, COMPACT):
            return self.tuple3[idx]
        return self.tuple4[idx]

    def _preimage(self, ival: Tuple[int, int]) -> List[int]:
        """Poseidon preimage of a compound ival; children must be hashed."""
        kind, idx = ival
        children = self._children(ival)
        if kind == COMPACT:
            a, b, c = children
            return [
                self._digest_of(a), b.tag,
                self._digest_of(b), self._digest_of(c),
            ]
        pre: List[int] = []
        for ch in children:
            pre.append(ch.tag)
            pre.append(self._digest_of(ch))
        return pre

    def _digest_of(self, ptr: Ptr) -> int:
        if ptr.kind == ATOM:
            return self.atoms[ptr.idx]
        return self.z_cache[ptr.val]

    def hash_ptr_val(self, ival: Tuple[int, int]) -> int:
        """Hash one ival (iterative, memoized)."""
        kind, idx = ival
        if kind == ATOM:
            return self.atoms[idx]
        cached = self.z_cache.get(ival)
        if cached is not None:
            return cached
        # iterative post-order: a node is hashed only once all compound
        # children are cached
        stack = [ival]
        while stack:
            iv = stack[-1]
            if iv[0] == ATOM or iv in self.z_cache:
                stack.pop()
                continue
            pending = [
                ch.val for ch in self._children(iv)
                if ch.kind != ATOM and ch.val not in self.z_cache
            ]
            if pending:
                stack.extend(pending)
                continue
            d = self.poseidon.hash(self._preimage(iv))
            self.z_cache[iv] = d
            self.inverse_z_cache[d] = iv
            stack.pop()
        return self.z_cache[ival]

    def hash_ptr(self, ptr: Ptr) -> ZPtr:
        return ZPtr(ptr.tag, self.hash_ptr_val(ptr.val))

    @tracing.instrument("store.hydrate_z_cache")
    def hydrate_z_cache(self) -> None:
        """Batched hydration: levelize the dehydrated queue by DAG depth and
        hash each (level, arity) wave as one device batch."""
        queue = [iv for iv in self.dehydrated if iv not in self.z_cache]
        self.dehydrated = []
        if not queue:
            return
        level: Dict[Tuple[int, int], int] = {}

        def lvl(iv: Tuple[int, int]) -> int:
            if iv[0] == ATOM or iv in self.z_cache:
                return 0
            return level[iv]

        waves: Dict[int, Dict[int, List[Tuple[int, int]]]] = {}
        for iv in queue:  # queue is topologically ordered (children first)
            if iv in level:
                continue
            lv = 1 + max((lvl(ch.val) for ch in self._children(iv)),
                         default=0)
            level[iv] = lv
            arity = {TUPLE2: 4, TUPLE3: 6, TUPLE4: 8, COMPACT: 4}[iv[0]]
            waves.setdefault(lv, {}).setdefault(arity, []).append(iv)

        for lv in sorted(waves):
            for arity, ivs in waves[lv].items():
                pres = [self._preimage(iv) for iv in ivs]
                digests = self._hash_wave(arity, pres)
                for iv, pre, d in zip(ivs, pres, digests):
                    self.z_cache[iv] = d
                    self.inverse_z_cache[d] = iv
                    self.poseidon.insert(tuple(pre), d)

    def _hash_wave(self, arity: int, pres: List[List[int]]) -> List[int]:
        if len(pres) < _DEVICE_WAVE_THRESHOLD:
            return [self.poseidon.hash(p) for p in pres]
        devices = sharding.prover_devices()
        if devices is not None:
            # several devices: the wave is sharded over them, dense
            # Poseidon per shard (store_core.rs:256-269 rayon analog)
            return sharding.shard_hash_batch_ints(devices, self.field,
                                                  arity, pres)
        return hash_batch(self.field, arity, pres, device=self.device)

    # ------------------------------------------------------------------
    # commitments
    # ------------------------------------------------------------------

    def add_comm(self, digest: int, secret: int, payload: Ptr) -> None:
        self.comms[digest] = (secret, payload)

    def hide_and_return_z_payload(self, secret: int,
                                  payload: Ptr) -> Tuple[int, ZPtr]:
        z = self.hash_ptr(payload)
        digest = self.poseidon.hash([secret, z.tag, z.digest])
        self.add_comm(digest, secret, payload)
        return digest, z

    def hide(self, secret: int, payload: Ptr) -> Ptr:
        digest, _ = self.hide_and_return_z_payload(secret, payload)
        return self.comm(digest)

    def commit(self, payload: Ptr) -> Ptr:
        return self.hide(0, payload)  # NON_HIDING_COMMITMENT_SECRET = 0

    def open(self, digest: int) -> Optional[Tuple[int, Ptr]]:
        return self.comms.get(digest)

    def can_open(self, digest: int) -> bool:
        return digest in self.comms

    # ------------------------------------------------------------------
    # opaque / inverse
    # ------------------------------------------------------------------

    def opaque(self, z: ZPtr) -> Ptr:
        return self.intern_atom(z.tag, z.digest)

    def to_ptr_val(self, digest: int) -> Tuple[int, int]:
        iv = self.inverse_z_cache.get(digest)
        if iv is None:
            return (ATOM, self.intern_digest(digest))
        return iv

    def to_ptr(self, z: ZPtr) -> Ptr:
        kind, idx = self.to_ptr_val(z.digest)
        return Ptr(z.tag, kind, idx)

    def ptr_eq(self, a: Ptr, b: Ptr) -> bool:
        return self.hash_ptr(a) == self.hash_ptr(b)

    # ------------------------------------------------------------------
    # Lurk-specific interning (Store parity)
    # ------------------------------------------------------------------

    def zero(self, tag: int) -> Ptr:
        return self.intern_atom(tag, 0)

    def dummy(self) -> Ptr:
        return self.zero(ExprTag.Nil)

    def num(self, f: int) -> Ptr:
        return self.intern_atom(ExprTag.Num, f)

    def num_u64(self, u: int) -> Ptr:
        return self.intern_atom(ExprTag.Num, u)

    def u64(self, u: int) -> Ptr:
        assert 0 <= u < (1 << 64)
        return self.intern_atom(ExprTag.U64, u)

    def char(self, c: str) -> Ptr:
        return self.intern_atom(ExprTag.Char, ord(c))

    def comm(self, digest: int) -> Ptr:
        return self.intern_atom(ExprTag.Comm, digest)

    def is_zero(self, ptr: Ptr) -> bool:
        return ptr.kind == ATOM and self.atoms[ptr.idx] == 0

    def fetch_f(self, ptr: Ptr) -> Optional[int]:
        if ptr.kind != ATOM:
            return None
        return self.atoms[ptr.idx]

    def fetch_num(self, ptr: Ptr) -> Optional[int]:
        if ptr.tag != ExprTag.Num:
            return None
        return self.fetch_f(ptr)

    def fetch_u64(self, ptr: Ptr) -> Optional[int]:
        if ptr.tag != ExprTag.U64:
            return None
        return self.fetch_f(ptr)

    def fetch_char(self, ptr: Ptr) -> Optional[str]:
        if ptr.tag != ExprTag.Char:
            return None
        f = self.fetch_f(ptr)
        return chr(f) if f is not None and f < 0x110000 else None

    # strings: char-cons chains terminated by Str-tagged zero atom
    def intern_string(self, s: str) -> Ptr:
        cached = self._string_ptr_cache.get(s)
        if cached is not None:
            return cached
        ptr = self.zero(ExprTag.Str)
        for c in reversed(s):
            ptr = self.intern_tuple2([self.char(c), ptr], ExprTag.Str)
        self._string_ptr_cache[s] = ptr
        self._ptr_string_cache[ptr] = s
        return ptr

    def fetch_string(self, ptr: Ptr) -> Optional[str]:
        cached = self._ptr_string_cache.get(ptr)
        if cached is not None:
            return cached
        if ptr.tag != ExprTag.Str:
            return None
        out: List[str] = []
        cur = ptr
        while True:
            if cur.kind == ATOM:
                if self.atoms[cur.idx] == 0:
                    s = "".join(out)
                    self._ptr_string_cache[ptr] = s
                    return s
                return None
            if cur.kind != TUPLE2:
                return None
            car, cdr = self.tuple2[cur.idx]
            c = self.fetch_char(car)
            if c is None:
                return None
            out.append(c)
            cur = cdr

    # symbols: string-cons chains terminated by Sym-tagged zero atom
    def intern_symbol_path(self, path: Sequence[str]) -> Ptr:
        acc = self.zero(ExprTag.Sym)
        for s in path:
            acc = self.intern_tuple2([self.intern_string(s), acc],
                                     ExprTag.Sym)
        return acc

    def intern_symbol(self, sym: Symbol) -> Ptr:
        cached = self._symbol_ptr_cache.get(sym)
        if cached is not None:
            return cached
        path_ptr = self.intern_symbol_path(sym.path)
        if sym == lurk_sym("nil"):
            sym_ptr = Ptr(ExprTag.Nil, path_ptr.kind, path_ptr.idx)
        elif sym.keyword:
            sym_ptr = Ptr(ExprTag.Key, path_ptr.kind, path_ptr.idx)
        else:
            sym_ptr = path_ptr
        self._symbol_ptr_cache[sym] = sym_ptr
        self._ptr_symbol_cache[sym_ptr] = sym
        return sym_ptr

    def fetch_symbol(self, ptr: Ptr) -> Optional[Symbol]:
        cached = self._ptr_symbol_cache.get(ptr)
        if cached is not None:
            return cached
        if ptr.tag in (ExprTag.Sym, ExprTag.Key) and ptr.kind == ATOM:
            if self.atoms[ptr.idx] == 0:
                sym = Symbol((), ptr.tag == ExprTag.Key)
                self._ptr_symbol_cache[ptr] = sym
                return sym
            return None
        if ptr.tag in (ExprTag.Sym, ExprTag.Nil, ExprTag.Key) and \
                ptr.kind == TUPLE2:
            path: List[str] = []
            idx = ptr.idx
            while True:
                car, cdr = self.tuple2[idx]
                if car.tag != ExprTag.Str or cdr.tag != ExprTag.Sym:
                    return None
                s = self.fetch_string(car)
                if s is None:
                    return None
                path.append(s)
                if cdr.kind == ATOM:
                    if self.atoms[cdr.idx] != 0:
                        return None
                    path.reverse()
                    sym = Symbol(tuple(path), ptr.tag == ExprTag.Key)
                    self._ptr_symbol_cache[ptr] = sym
                    return sym
                if cdr.kind != TUPLE2:
                    return None
                idx = cdr.idx
        return None

    def intern_lurk_symbol(self, name: str) -> Ptr:
        return self.intern_symbol(lurk_sym(name))

    def intern_nil(self) -> Ptr:
        return self.intern_lurk_symbol("nil")

    def intern_t(self) -> Ptr:
        return self.intern_lurk_symbol("t")

    def intern_user_symbol(self, name: str) -> Ptr:
        from ..symbol import user_sym
        return self.intern_symbol(user_sym(name))

    def key(self, name: str) -> Ptr:
        return self.intern_symbol(Symbol.key([name]))

    # conses / functions / envs / continuations
    def cons(self, car: Ptr, cdr: Ptr) -> Ptr:
        return self.intern_tuple2([car, cdr], ExprTag.Cons)

    def intern_fun(self, args: Ptr, body: Ptr, env: Ptr) -> Ptr:
        return self.intern_tuple4([args, body, env, self.dummy()],
                                  ExprTag.Fun)

    def intern_empty_env(self) -> Ptr:
        return self.intern_atom(ExprTag.Env, 0)

    def push_binding(self, sym: Ptr, v: Ptr, env: Ptr) -> Ptr:
        assert sym.tag == ExprTag.Sym and env.tag == ExprTag.Env
        return self.intern_compact([sym, v, env], ExprTag.Env)

    def pop_binding(self, env: Ptr):
        assert env.tag == ExprTag.Env
        if env.kind != COMPACT:
            return None
        return self.tuple3[env.idx]

    def intern_provenance(self, query: Ptr, val: Ptr, deps: Ptr) -> Ptr:
        assert query.tag == ExprTag.Cons
        return self.intern_compact([query, val, deps], ExprTag.Prov)

    def cont_atom(self, cont_tag: int) -> Ptr:
        return Ptr(cont_tag, ATOM, self.hash8zeros_idx)

    def cont_outermost(self) -> Ptr:
        return self.cont_atom(ContTag.Outermost)

    def cont_error(self) -> Ptr:
        return self.cont_atom(ContTag.Error)

    def cont_terminal(self) -> Ptr:
        return self.cont_atom(ContTag.Terminal)

    def cont_stream_start(self) -> Ptr:
        return self.cont_atom(ContTag.StreamStart)

    def cont_stream_pause(self) -> Ptr:
        return self.cont_atom(ContTag.StreamPause)

    # lists
    def list(self, elts: Sequence[Ptr], last: Optional[Ptr] = None) -> Ptr:
        acc = last if last is not None else self.intern_nil()
        for elt in reversed(list(elts)):
            acc = self.cons(elt, acc)
        return acc

    def improper_list(self, elts: Sequence[Ptr], last: Ptr) -> Ptr:
        return self.list(elts, last)

    def fetch_cons(self, ptr: Ptr):
        if ptr.tag == ExprTag.Cons and ptr.kind == TUPLE2:
            return self.tuple2[ptr.idx]
        return None

    def car_cdr(self, ptr: Ptr) -> Tuple[Ptr, Ptr]:
        """Cons/str-aware car/cdr (errors mirror reference car_cdr)."""
        if ptr.tag == ExprTag.Nil:
            nil = self.intern_nil()
            return nil, nil
        if ptr.tag == ExprTag.Str and ptr.kind == ATOM:
            if self.atoms[ptr.idx] == 0:
                return self.intern_nil(), self.zero(ExprTag.Str)
            raise ValueError("Invalid empty string pointer")
        if ptr.tag in (ExprTag.Cons, ExprTag.Str) and ptr.kind == TUPLE2:
            car, cdr = self.tuple2[ptr.idx]
            return car, cdr
        raise ValueError("invalid pointer to extract car/cdr from")

    def car_cdr_simple(self, ptr: Ptr) -> Tuple[Ptr, Ptr]:
        if ptr.tag == ExprTag.Nil:
            nil = self.intern_nil()
            return nil, nil
        if ptr.tag == ExprTag.Cons and ptr.kind == TUPLE2:
            car, cdr = self.tuple2[ptr.idx]
            return car, cdr
        raise ValueError("invalid pointer to extract car/cdr (simple) from")

    def fetch_list(self, ptr: Ptr):
        """Returns (elements, improper_tail_or_None) or None."""
        if ptr == self.intern_nil():
            return [], None
        if ptr.tag != ExprTag.Cons or ptr.kind != TUPLE2:
            return None
        out: List[Ptr] = []
        last = None
        idx = ptr.idx
        while True:
            car, cdr = self.tuple2[idx]
            out.append(car)
            if cdr.tag == ExprTag.Nil:
                break
            if cdr.tag == ExprTag.Cons and cdr.kind == TUPLE2:
                idx = cdr.idx
                continue
            last = cdr
            break
        return out, last

    def fetch_proper_list(self, ptr: Ptr) -> Optional[List[Ptr]]:
        res = self.fetch_list(ptr)
        if res is None:
            return None
        lst, tail = res
        assert tail is None, "improper list when proper list expected"
        return lst

    def fetch_env(self, ptr: Ptr):
        if ptr.tag != ExprTag.Env:
            return None
        out = []
        cur = ptr
        empty = self.intern_empty_env()
        while cur.kind == COMPACT:
            sym, v, rest = self.tuple3[cur.idx]
            out.append((sym, v))
            if rest.val == empty.val:
                break
            cur = rest
        return out

    # scalar IO vector for proofs (to_scalar_vector parity)
    def to_scalar_vector(self, ptrs: Sequence[Ptr]) -> List[int]:
        out: List[int] = []
        for ptr in ptrs:
            z = self.hash_ptr(ptr)
            out.append(z.tag)
            out.append(z.digest)
        return out
