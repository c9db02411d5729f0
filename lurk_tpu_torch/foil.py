"""Foil: Flat Optimization Intermediate Language (experimental).

A copy of the JAX package's ``foil.py``, its circuits through the
port's :mod:`.poseidon.circuit` and :mod:`.r1cs.gadgets`. Parity target:
reference foil/, an e-graph-like congruence-closure graph used to
minimize flat programs before circuit synthesis (not wired into the
reference's prover pipeline either; foil/src/lib.rs:1-40).

A `Foil` holds vertices labeled by a head (operator or variable) with
ordered successor edges. `minimize` runs congruence closure: vertices
asserted equal are merged, and vertices with equal heads and congruent
successors are merged until fixpoint, yielding the minimal DAG. Where
the JAX module asserts on Lurk source (an improper list, a `let` with
an empty body), `Coil.add_program` raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Tuple

from .poseidon.circuit import poseidon_circuit
from .r1cs.gadgets import alloc_num, enforce_equal
from .tags import ExprTag


@dataclasses.dataclass(frozen=True)
class Func:
    """A named head with optional projectors and typed metadata
    (foil/src/lib.rs:83-120 Func<M: MetaData>; metadata is any hashable
    value — the python-native MetaData bound)."""

    name: str
    projectors: Optional[Tuple["Func", ...]] = None
    metadata: Hashable = None

    @staticmethod
    def constructor(name: str, projectors: List["Func"],
                    metadata: Hashable = None) -> "Func":
        return Func(name, tuple(projectors), metadata)


@dataclasses.dataclass
class Schema:
    """Registry of equivalence heads and constructor Funcs
    (foil/src/lib.rs:37-52). `finalize_for_schema` drives constructor
    deduction and equivalence enforcement from it."""

    equivalences: List[Func] = dataclasses.field(default_factory=list)
    constructors: List[Func] = dataclasses.field(default_factory=list)

    def add_constructor(self, constructor: Func,
                        metadata: Hashable = None) -> None:
        self.constructors.append(constructor)

    def constructor_for_projector(self, head_name
                                  ) -> Optional[Tuple[Func, int]]:
        for ctor in self.constructors:
            for k, pj in enumerate(ctor.projectors or ()):
                if pj.name == head_name:
                    return ctor, k
        return None


@dataclasses.dataclass
class Vert:
    head: Hashable
    successors: List[int]
    meta: Hashable = None


def _head_name(head) -> Hashable:
    return head[0] if isinstance(head, tuple) else head


class Foil:
    def __init__(self, schema: Optional[Schema] = None):
        self.verts: List[Vert] = []
        self.parent: List[int] = []
        self.pending_equalities: List[Tuple[int, int]] = []
        self.schema = schema or Schema()

    # -- construction ------------------------------------------------------

    def add(self, head: Hashable, successors: Optional[List[int]] = None,
            meta: Hashable = None) -> int:
        idx = len(self.verts)
        self.verts.append(Vert(head, list(successors or []), meta))
        self.parent.append(idx)
        return idx

    def assert_eq(self, a: int, b: int) -> None:
        self.pending_equalities.append((a, b))

    # -- union-find --------------------------------------------------------

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        # keep the lower index as representative (determinism)
        if rb < ra:
            ra, rb = rb, ra
        self.parent[rb] = ra
        return True

    # -- congruence closure ---------------------------------------------------

    def minimize(self) -> None:
        """Merge asserted equalities, then merge congruent vertices
        (same head, pairwise-equal successor classes) to fixpoint."""
        for a, b in self.pending_equalities:
            self.union(a, b)
        self.pending_equalities = []
        changed = True
        while changed:
            changed = False
            sig: Dict[Tuple, int] = {}
            for i, v in enumerate(self.verts):
                key = (v.head, tuple(self.find(s) for s in v.successors))
                j = sig.get(key)
                if j is None:
                    sig[key] = i
                elif self.union(i, j):
                    changed = True

    # -- views -------------------------------------------------------------

    def classes(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for i in range(len(self.verts)):
            out.setdefault(self.find(i), []).append(i)
        return out

    def canonical_graph(self) -> Dict[int, Tuple[Hashable, Tuple[int, ...]]]:
        """Minimized DAG: representative -> (head, successor reps)."""
        out = {}
        for rep, members in self.classes().items():
            v = self.verts[members[0]]
            out[rep] = (v.head,
                        tuple(self.find(s) for s in v.successors))
        return out

    # -- schema-driven finalization (lib.rs finalize_for_schema) -----------

    def enforce_equivalences(self) -> None:
        """Vertices whose head is a registered equivalence Func assert
        their successors equal (lib.rs: Bindings become trivial after
        finalization)."""
        eq_names = {f.name for f in self.schema.equivalences}
        for v in self.verts:
            if _head_name(v.head) in eq_names and len(v.successors) >= 2:
                first = v.successors[0]
                for other in v.successors[1:]:
                    self.assert_eq(first, other)

    def deduce_constructors(self) -> None:
        """Every projection `proj_k(x)` implies its defining
        constructor: x ~ ctor(proj_0(x), ..., proj_n(x)), with missing
        sibling projections created (constructors.rs:169-341). The new
        constructor vertex inherits the schema Func's metadata."""
        for i in range(len(self.verts)):
            v = self.verts[i]
            owner = self.schema.constructor_for_projector(
                _head_name(v.head))
            if owner is None or not v.successors:
                continue
            ctor, _ = owner
            target = v.successors[0]
            proj_vids = []
            for pj in ctor.projectors or ():
                found = None
                for k in range(len(self.verts)):
                    kv = self.verts[k]
                    if _head_name(kv.head) == pj.name and kv.successors \
                            and self.find(kv.successors[0]) \
                            == self.find(target):
                        found = k
                        break
                if found is None:
                    found = self.add((pj.name,), [target],
                                     meta=pj.metadata)
                proj_vids.append(found)
            ctor_vid = self.add((ctor.name,), proj_vids,
                                meta=ctor.metadata)
            self.assert_eq(ctor_vid, target)

    def propagate_injectivity(self) -> None:
        """Constructor injectivity to fixpoint: ctor(a, b) ~ ctor(c, d)
        implies a ~ c, b ~ d (constructors.rs simplification)."""
        ctor_names = {f.name for f in self.schema.constructors}
        changed = True
        while changed:
            changed = False
            for rep, members in self.classes().items():
                ctors = [m for m in members
                         if _head_name(self.verts[m].head) in ctor_names]
                if len(ctors) < 2:
                    continue
                base = self.verts[ctors[0]].successors
                for other in ctors[1:]:
                    for sa, sb in zip(base,
                                      self.verts[other].successors):
                        if self.find(sa) != self.find(sb):
                            self.union(sa, sb)
                            changed = True
            if changed:
                self.minimize()

    def finalize_for_schema(self) -> None:
        self.enforce_equivalences()
        self.deduce_constructors()

    def finalize(self) -> None:
        """finalize_for_schema + minimize + injectivity (the lib.rs
        finalize/minimize pipeline in one call)."""
        self.finalize_for_schema()
        self.minimize()
        self.propagate_injectivity()


# ---------------------------------------------------------------------------
# general relation synthesis (foil/src/circuit.rs, completed: the
# reference's synthesize is an explicit sketch — witnesses are todo!()
# and allocations filled with zeros; here classes are valued by a host
# valuation and every class is constrained by its mapped Relation)
# ---------------------------------------------------------------------------


class Relation:
    """Per-head circuit relation (circuit.rs `trait Relation`):
    constrain `allocated_head` in terms of its allocated successors."""

    def synthesize(self, cs, allocated_head, successors) -> None:
        raise NotImplementedError


class PoseidonRelation(Relation):
    """head == poseidon(successors) — the content-addressing relation
    used by coil constructor classes."""

    def synthesize(self, cs, allocated_head, successors) -> None:
        digest = poseidon_circuit(cs, cs.field, successors)
        enforce_equal(cs, digest, allocated_head)


class MetaMapper:
    """meta -> Relation lookup (lib.rs:705-707). Dict-backed default;
    subclass `find` for richer dispatch."""

    def __init__(self, table: Optional[Dict[Hashable, Relation]] = None):
        self.table = dict(table or {})

    def find(self, meta: Hashable) -> Optional[Relation]:
        return self.table.get(meta)


class MappedFoil:
    """A minimized Foil + a MetaMapper, synthesizable as a circuit
    (circuit.rs MappedFoil/Circuit impl). One allocation per class;
    each class with a mapped relation is constrained through it."""

    def __init__(self, foil: Foil, mapper: MetaMapper):
        self.foil = foil
        self.mapper = mapper

    def synthesize(self, cs, values: Optional[Dict[int, int]] = None
                   ) -> Dict[int, object]:
        f = self.foil
        values = values or {}
        graph = f.canonical_graph()
        allocs = {rep: alloc_num(cs, values.get(rep, 0))
                  for rep in sorted(graph)}
        classes = f.classes()
        for rep in sorted(graph):
            for member in classes[rep]:
                v = f.verts[member]
                rel = self.mapper.find(v.meta)
                if rel is None:
                    continue
                succ = [allocs[f.find(s)] for s in v.successors]
                rel.synthesize(cs, allocs[rep], succ)
                break
        return allocs


# ---------------------------------------------------------------------------
# Coil: Lurk-as-CAS on top of the congruence core
# (functionality parity: /root/reference/foil/src/coil.rs:56-575 +
# constructors.rs "deduce constructor" — Lurk source walks into a Foil
# graph; `bind` forms assert equivalences; projections (car/cdr) deduce
# their defining constructors during finalization; minimization yields
# the canonical DAG; a circuit synthesizes one allocation per class
# with constructor hash relations.)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CoilDef:
    """Schema: constructor symbols with their ordered projectors, and
    equivalence heads (lib.rs Schema; coil.rs CoilDef::new_std registers
    `.coil.bind` as the standard equivalence)."""

    constructors: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict)
    equivalences: List[str] = dataclasses.field(
        default_factory=lambda: [".coil.bind"])

    @staticmethod
    def std() -> "CoilDef":
        d = CoilDef()
        d.constructors[".lurk.cons"] = [".lurk.car", ".lurk.cdr"]
        return d

    def projector_owner(self, head) -> Optional[Tuple[str, int]]:
        for ctor, projs in self.constructors.items():
            if head in projs:
                return ctor, projs.index(head)
        return None

    def to_schema(self) -> Schema:
        """Typed-schema view: constructor Funcs carry the metadata key
        ("hash", arity) that MappedFoil's MetaMapper resolves to the
        Poseidon content-addressing relation."""
        s = Schema(equivalences=[Func(e) for e in self.equivalences])
        for ctor, projs in self.constructors.items():
            s.add_constructor(Func.constructor(
                ctor, [Func(p, metadata=("proj", ctor, k))
                       for k, p in enumerate(projs)],
                metadata=("hash", len(projs))))
        return s


class Coil:
    """Walks Lurk source (via the repo's parser/store) into a Foil
    graph. Variable labels are scope-deduped with a serial suffix
    (FoilConfig.dedup_var_names) so shadowed names stay distinct."""

    def __init__(self, defn: Optional[CoilDef] = None):
        self.defn = defn or CoilDef.std()
        self.schema = self.defn.to_schema()
        self.foil = Foil(self.schema)
        self._var_count = 0
        self._binds: List[int] = []

    def _meta_for_head(self, head_name) -> Hashable:
        for ctor in self.schema.constructors:
            if ctor.name == head_name:
                return ctor.metadata
        owner = self.schema.constructor_for_projector(head_name)
        if owner is not None:
            ctor, k = owner
            return (ctor.projectors or ())[k].metadata
        return None

    # -- graph construction from Lurk source ------------------------------

    def _var(self, scope: Dict[str, int], name: str,
             fresh: bool) -> int:
        if not fresh and name in scope:
            return scope[name]
        vid = self.foil.add(("var", name, self._var_count))
        self._var_count += 1
        scope[name] = vid
        return vid

    def add_program(self, store, ptr, scope: Optional[Dict] = None
                    ) -> int:
        """Interns one Lurk form; returns its vertex. Understands
        `(let ((x e)) body...)` (coil.rs Let syntax) and treats any
        other list as an application."""
        scope = {} if scope is None else scope
        if ptr.tag == ExprTag.Sym:
            name = str(store.fetch_symbol(ptr))
            return self._var(scope, name, fresh=False)
        if ptr.tag in (ExprTag.Num, ExprTag.U64, ExprTag.Char):
            return self.foil.add(("const", store.fetch_num(ptr)
                                  if ptr.tag == ExprTag.Num
                                  else store.atoms[ptr.idx]))
        if ptr.tag != ExprTag.Cons:
            raise ValueError(f"coil: unsupported form tag {ptr.tag}")
        elts, tail = store.fetch_list(ptr)
        if tail is not None:
            raise ValueError("coil: improper list")
        head = elts[0]
        head_name = (str(store.fetch_symbol(head))
                     if head.tag == ExprTag.Sym else None)
        if head_name == ".lurk.let":
            bindings, _ = store.fetch_list(elts[1])
            inner = dict(scope)
            for b in bindings:
                (var_ptr, expr_ptr), _ = store.fetch_list(b)
                val_vid = self.add_program(store, expr_ptr, inner)
                vname = str(store.fetch_symbol(var_ptr))
                var_vid = self._var(inner, vname, fresh=True)
                bind_vid = self.foil.add(
                    (".coil.bind",), [var_vid, val_vid])
                self._binds.append(bind_vid)
            last = None
            for form in elts[2:]:
                last = self.add_program(store, form, inner)
            if last is None:
                raise ValueError("coil: let with empty body")
            return last
        args = [self.add_program(store, e, scope) for e in elts[1:]]
        return self.foil.add((head_name,), args,
                             meta=self._meta_for_head(head_name))

    # -- finalization ------------------------------------------------------

    def finalize(self) -> None:
        """Schema-driven pipeline (lib.rs finalize + minimize):
        equivalence enforcement (binds), defining-constructor deduction
        (constructors.rs:169-341: car(x) implies x ~ cons(car(x),
        cdr(x))), congruence minimization, injectivity propagation."""
        self.foil.finalize()

    # -- circuit synthesis -------------------------------------------------

    def mapped(self) -> MappedFoil:
        """The general-synthesis view: constructor classes (metadata
        ("hash", n)) map to the Poseidon content-addressing relation."""
        table: Dict[Hashable, Relation] = {}
        for ctor in self.schema.constructors:
            table[ctor.metadata] = PoseidonRelation()
        return MappedFoil(self.foil, MetaMapper(table))

    def synthesize(self, cs, values: Dict[int, int]):
        """One allocation per minimized class; constructor classes get
        a Poseidon hash constraint over their successor allocations
        (coil.rs synthesize via the general MappedFoil/Relation walk).
        `values` maps class representatives to field values (the host
        valuation)."""
        return self.mapped().synthesize(cs, values)

    def class_info(self) -> List[Tuple[int, List, Optional[List[int]]]]:
        """(rep, member labels, successor reps) per class — the
        reference's graph.class_info test surface."""
        out = []
        f = self.foil
        for rep in sorted(f.classes()):
            members = f.classes()[rep]
            labels = [f.verts[m].head for m in members]
            succs = None
            for m in members:
                if f.verts[m].successors:
                    succs = [f.find(s) for s in f.verts[m].successors]
                    break
            out.append((rep, labels, succs))
        return out
