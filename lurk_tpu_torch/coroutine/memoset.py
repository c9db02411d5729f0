"""MemoSet: memoized deferred proofs of (mutually recursive) queries.

The port of the JAX package's ``coroutine/memoset.py`` (reference
functionality: src/coroutine/memoset/mod.rs): the LogUp (logarithmic
derivative) multiset with a content-addressed Lurk-list transcript:

  - each query USE inserts its provenance into the multiset;
  - each unique query is removed ONCE with its use-count multiplicity;
  - Fiat-Shamir randomness r = the hash of the finished transcript;
  - balance: sum over insertions of 1/(r + hash(prov)) equals the sum
    over removals of count/(r + hash(prov)).

The Scope does the evaluation-time bookkeeping (queries, dependencies,
provenances by topological waves, the transcript). The circuits are in
:mod:`.circuit`, the provers in :mod:`.prove` and :mod:`.prove_cycle`;
the balance check here is the arithmetic those circuits enforce.

The transcript's order decides ``r``: every list below keeps the JAX
package's order. The transcript's digest hydrates the store first, so
its waves of 64 or more preimages hash as batches on the store's
device. Where the JAX package asserts on its input, the port raises
``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ..store.core import Ptr, Store
from ..symbol import Symbol
from ..tags import ExprTag


class Transcript:
    """Content-addressed Lurk list (memoset/mod.rs:78-115)."""

    def __init__(self, store: Store):
        self.store = store
        self.acc = store.intern_nil()

    def add(self, item: Ptr) -> None:
        self.acc = self.store.cons(item, self.acc)

    @staticmethod
    def make_kv(store: Store, key: Ptr, value: Ptr) -> Ptr:
        return store.cons(key, value)

    @staticmethod
    def make_provenance_count(store: Store, provenance: Ptr,
                              count: int) -> Ptr:
        return store.cons(provenance, store.num(count))

    def r(self) -> int:
        self.store.hydrate_z_cache()
        z = self.store.hash_ptr(self.acc)
        if z.tag != ExprTag.Cons:
            raise ValueError("transcript must be non-empty")
        return z.digest


@dataclasses.dataclass
class Provenance:
    """(query, result, dependency provenances) as a Compact Prov ptr."""

    query: Ptr
    result: Ptr
    dependencies: List[Ptr]

    def to_ptr(self, store: Store) -> Ptr:
        if len(self.dependencies) == 1:
            deps = self.dependencies[0]
        else:
            deps = store.list(self.dependencies)
        return store.intern_provenance(self.query, self.result, deps)

    @staticmethod
    def dummy(store: Store) -> "Provenance":
        nil = store.intern_nil()
        sym = store.intern_symbol(Symbol(("lurk", "query", "dummy"),
                                         False))
        return Provenance(store.cons(sym, nil), nil, [])


class Query:
    """Query protocol (memoset/query.rs). Subclasses define:
    symbol() -> Symbol, eval(scope) -> Ptr, and from_ptr/to_ptr."""

    def symbol(self) -> Symbol:
        raise NotImplementedError

    def eval(self, scope: "Scope") -> Ptr:
        raise NotImplementedError

    def to_ptr(self, store: Store) -> Ptr:
        raise NotImplementedError

    @classmethod
    def from_ptr(cls, store: Store, ptr: Ptr) -> Optional["Query"]:
        raise NotImplementedError

    def index(self) -> int:
        return 0


class Scope:
    """Evaluation-time memoset bookkeeping (memoset/mod.rs:315-845)."""

    def __init__(self, store: Store, query_cls, default_rc: int = 1):
        self.store = store
        self.query_cls = query_cls
        self.default_rc = default_rc
        self.queries: Dict[Ptr, Ptr] = {}
        self.toplevel_insertions: List[Ptr] = []
        self.internal_insertions: List[Ptr] = []
        self.dependencies: Dict[Ptr, List[Query]] = {}
        self.dependents: Dict[Ptr, Set[Ptr]] = {}
        self.multiset: Dict[Ptr, int] = {}
        self.transcript: Optional[Transcript] = None
        self.r: Optional[int] = None
        self.unique_inserted_keys: Dict[int, List[Ptr]] = {}

    # -- querying ----------------------------------------------------------

    def query(self, form: Ptr) -> Ptr:
        result, kv = self._query_aux(form)
        self.toplevel_insertions.append(kv)
        return result

    def query_recursively(self, parent: Query, child: Query) -> Ptr:
        s = self.store
        form = child.to_ptr(s)
        self.internal_insertions.append(form)
        result, _ = self._query_aux(form)
        self._register_dependency(parent, child)
        return result

    def _register_dependency(self, parent: Query, child: Query) -> None:
        s = self.store
        parent_ptr = parent.to_ptr(s)
        self.dependents.setdefault(child.to_ptr(s), set()).add(parent_ptr)
        self.dependencies.setdefault(parent_ptr, []).append(child)

    def _query_aux(self, form: Ptr) -> Tuple[Ptr, Ptr]:
        self.dependencies.setdefault(form, [])
        result = self.queries.get(form)
        if result is None:
            query = self.query_cls.from_ptr(self.store, form)
            if query is None:
                raise ValueError("invalid query")
            result = query.eval(self)
            self.queries[form] = result
        kv = Transcript.make_kv(self.store, form, result)
        self.multiset[kv] = self.multiset.get(kv, 0) + 1
        return result, kv

    # -- provenances --------------------------------------------------------

    def compute_provenances(self) -> Dict[Ptr, Ptr]:
        """Topological waves over the dependency DAG
        (memoset/mod.rs:659-747). The walk goes over sets; only the
        order of interning depends on it, never a digest or a list."""
        s = self.store
        provenances: Dict[Ptr, Ptr] = {}
        missing: Dict[Ptr, int] = {}
        ready: Set[Ptr] = set()
        for key in self.queries:
            n = len(self.dependencies.get(key, []))
            missing[key] = n
            if n == 0:
                ready.add(key)
        while ready:
            nxt: Set[Ptr] = set()
            for query in ready:
                if query in provenances:
                    continue
                subs = [
                    provenances[dep.to_ptr(s)]
                    for dep in self.dependencies.get(query, [])
                ]
                result = self.queries[query]
                provenances[query] = Provenance(
                    query, result, subs).to_ptr(s)
                for dependent in self.dependents.get(query, ()):
                    missing[dependent] -= 1
                    if missing[dependent] < 0:
                        raise ValueError("cyclic query")
                    if missing[dependent] == 0:
                        nxt.add(dependent)
            ready = nxt
        if len(provenances) != len(self.queries):
            raise ValueError("incomplete provenances (cyclic query?)")
        return provenances

    # -- transcript ----------------------------------------------------------

    def finalize_transcript(self) -> Transcript:
        """Assemble the transcript (memoset/mod.rs:756-845): toplevel
        provenance insertions, then per-query-index removals with
        multiplicities."""
        s = self.store
        provenances = self.compute_provenances()
        transcript = Transcript(s)

        kvs_by_key: Dict[Ptr, Ptr] = {}
        unique_keys: Dict[int, List[Ptr]] = {}

        def record_kv(kv: Ptr) -> None:
            key, _ = s.car_cdr_simple(kv)
            if key not in kvs_by_key:
                q = self.query_cls.from_ptr(s, key)
                unique_keys.setdefault(q.index(), []).append(key)
                kvs_by_key[key] = kv

        for kv in self.toplevel_insertions:
            record_kv(kv)
        for key in self.internal_insertions:
            record_kv(Transcript.make_kv(s, key, self.queries[key]))

        for kv in self.toplevel_insertions:
            key, _ = s.car_cdr_simple(kv)
            transcript.add(provenances[key])

        removal_counts: Dict[Ptr, int] = {}
        dummy_prov = Provenance.dummy(s).to_ptr(s)
        for index in sorted(unique_keys):
            keys = unique_keys[index]
            rc = self.default_rc
            # chunks padded to rc with (dummy, 0) entries: the circuit
            # emits one removal per key SLOT, dummies included, so the
            # host transcript must match (mod.rs:805-829)
            for start in range(0, len(keys), rc):
                chunk = keys[start:start + rc]
                for key in chunk:
                    kv = kvs_by_key[key]
                    count = self.multiset.get(kv, 0)
                    removal_counts[key] = count
                    transcript.add(Transcript.make_provenance_count(
                        s, provenances[key], count))
                for _ in range(rc - len(chunk)):
                    transcript.add(Transcript.make_provenance_count(
                        s, dummy_prov, 0))

        self.transcript = transcript
        self.r = transcript.r()
        self.unique_inserted_keys = unique_keys
        self._provenances = provenances
        # removal multiplicities are COMMITTED in the transcript (r
        # derives from them); verification must use this snapshot
        self._removal_counts = removal_counts
        return transcript

    # -- NIVC z0 components (prove.rs:233-241) -------------------------------

    def init_memoset(self) -> int:
        """LogUp accumulator value after the toplevel insertions
        (mod.rs:399-407); the NIVC steps drive it back to zero."""
        s = self.store
        p = s.field.modulus
        r = self.r
        acc = 0
        for kv in self.toplevel_insertions:
            key, _ = s.car_cdr_simple(kv)
            x = s.hash_ptr(self._provenances[key]).digest
            acc = (acc + pow((r + x) % p, p - 2, p)) % p
        return acc

    def init_transcript_ptr(self) -> Ptr:
        """Transcript holding only the toplevel provenance insertions."""
        s = self.store
        t = Transcript(s)
        for kv in self.toplevel_insertions:
            key, _ = s.car_cdr_simple(kv)
            t.add(self._provenances[key])
        return t.acc

    # -- LogUp balance check -------------------------------------------------

    def verify_balance(self) -> bool:
        """The multiset equality the circuit enforces: for each unique
        query, count insertions (uses) == the removal multiplicity, via
        logarithmic derivatives at r."""
        if self.transcript is None:
            self.finalize_transcript()
        s = self.store
        p = s.field.modulus
        r = self.r
        provenances = self._provenances

        def element(prov: Ptr) -> int:
            x = s.hash_ptr(prov).digest
            return pow((r + x) % p, p - 2, p)

        add_acc = 0
        # every USE of every query inserts its provenance once
        for kv, count in self.multiset.items():
            key, _ = s.car_cdr_simple(kv)
            add_acc = (add_acc + count * element(provenances[key])) % p
        remove_acc = 0
        for key, count in self._removal_counts.items():
            remove_acc = (
                remove_acc + count * element(provenances[key])) % p
        return add_acc == remove_acc


# ---------------------------------------------------------------------------
# Demo query (memoset/demo.rs): factorial with memoized subqueries
# ---------------------------------------------------------------------------


class DemoQuery(Query):
    SYMBOL = Symbol(("lurk", "user", "factorial"), False)

    def __init__(self, n_ptr: Ptr):
        self.n_ptr = n_ptr

    def symbol(self) -> Symbol:
        return self.SYMBOL

    def to_ptr(self, store: Store) -> Ptr:
        return store.cons(store.intern_symbol(self.SYMBOL),
                          store.cons(self.n_ptr, store.intern_nil()))

    @classmethod
    def from_ptr(cls, store: Store, ptr: Ptr) -> Optional["DemoQuery"]:
        lst = store.fetch_proper_list(ptr)
        if not lst or len(lst) != 2:
            return None
        head, arg = lst
        if store.fetch_symbol(head) != cls.SYMBOL:
            return None
        return cls(arg)

    def eval(self, scope: Scope) -> Ptr:
        s = scope.store
        n = s.fetch_num(self.n_ptr)
        if n is None:
            raise ValueError("factorial of a non-number")
        if n == 0:
            return s.num(1)
        sub = DemoQuery(s.num(n - 1))
        sub_result = scope.query_recursively(self, sub)
        m = s.fetch_num(sub_result)
        return s.num((n * m) % s.field.modulus)
