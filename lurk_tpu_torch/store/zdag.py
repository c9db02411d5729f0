"""ZDag / ZStore: content-addressed serialization of store DAGs.

A copy of the JAX package's ``store/zdag.py`` without its field-data
envelope (``dump_field_data``/``load_field_data``), which nothing calls;
its JSON is byte for byte the JAX package's, so either package reads
the other's files.

Parity: reference src/cli/zstore.rs:31-395 (ZDag::populate_with /
populate_store, ZStore with commitments) — the current-generation dump/
load format used for proof claims, `!(dump-data)` and zstore files.

Serialized form: JSON-compatible dict with hex field elements (the
reference uses bincode inside a field-modulus-tagged envelope; see
field_data.rs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .core import ATOM, COMPACT, Ptr, Store, TUPLE2, TUPLE3, TUPLE4, ZPtr

# ZPtrType kinds
Z_ATOM = "atom"
Z_TUPLE2 = "tuple2"
Z_TUPLE3 = "tuple3"
Z_TUPLE4 = "tuple4"
Z_COMPACT = "compact"


@dataclasses.dataclass
class ZDag:
    """Map ZPtr -> (kind, child ZPtrs)."""

    dag: Dict[ZPtr, Tuple[str, Tuple[ZPtr, ...]]] = dataclasses.field(
        default_factory=dict)

    def populate_with(self, ptr: Ptr, store: Store,
                      cache: Optional[Dict[Ptr, ZPtr]] = None) -> ZPtr:
        """Recursively intern ptr's content addresses into the dag."""
        cache = cache if cache is not None else {}
        hit = cache.get(ptr)
        if hit is not None:
            return hit
        kind = ptr.kind
        if kind == ATOM:
            z = store.hash_ptr(ptr)
            self.dag[z] = (Z_ATOM, ())
        elif kind == TUPLE2:
            a, b = store.tuple2[ptr.idx]
            za = self.populate_with(a, store, cache)
            zb = self.populate_with(b, store, cache)
            z = store.hash_ptr(ptr)
            self.dag[z] = (Z_TUPLE2, (za, zb))
        elif kind in (TUPLE3, COMPACT):
            a, b, c = store.tuple3[ptr.idx]
            za = self.populate_with(a, store, cache)
            zb = self.populate_with(b, store, cache)
            zc = self.populate_with(c, store, cache)
            z = store.hash_ptr(ptr)
            self.dag[z] = (Z_COMPACT if kind == COMPACT else Z_TUPLE3,
                           (za, zb, zc))
        else:
            a, b, c, d = store.tuple4[ptr.idx]
            children = tuple(
                self.populate_with(x, store, cache) for x in (a, b, c, d))
            z = store.hash_ptr(ptr)
            self.dag[z] = (Z_TUPLE4, children)
        cache[ptr] = z
        return z

    def populate_store(self, z: ZPtr, store: Store,
                       cache: Optional[Dict[ZPtr, Ptr]] = None) -> Ptr:
        """Inverse: intern the dag rooted at z into a store."""
        cache = cache if cache is not None else {}
        hit = cache.get(z)
        if hit is not None:
            return hit
        entry = self.dag.get(z)
        if entry is None or entry[0] == Z_ATOM:
            ptr = store.intern_atom(z.tag, z.digest)
        else:
            kind, children = entry
            ptrs = [self.populate_store(c, store, cache) for c in children]
            if kind == Z_TUPLE2:
                ptr = store.intern_tuple2(ptrs, z.tag, digest=z.digest)
            elif kind == Z_TUPLE3:
                ptr = store.intern_tuple3(ptrs, z.tag, digest=z.digest)
            elif kind == Z_COMPACT:
                ptr = store.intern_compact(ptrs, z.tag, digest=z.digest)
            else:
                ptr = store.intern_tuple4(ptrs, z.tag, digest=z.digest)
        cache[z] = ptr
        return ptr

    # -- (de)serialization ---------------------------------------------------

    def to_json(self) -> list:
        out = []
        for z, (kind, children) in self.dag.items():
            out.append({
                "tag": z.tag,
                "digest": f"{z.digest:x}",
                "kind": kind,
                "children": [
                    {"tag": c.tag, "digest": f"{c.digest:x}"}
                    for c in children
                ],
            })
        return out

    @staticmethod
    def from_json(data: list) -> "ZDag":
        dag = {}
        for e in data:
            z = ZPtr(e["tag"], int(e["digest"], 16))
            children = tuple(
                ZPtr(c["tag"], int(c["digest"], 16))
                for c in e["children"])
            dag[z] = (e["kind"], children)
        return ZDag(dag)


@dataclasses.dataclass
class ZStore:
    """ZDag + commitment openings (zstore.rs ZStore parity)."""

    zdag: ZDag = dataclasses.field(default_factory=ZDag)
    comms: Dict[int, Tuple[int, ZPtr]] = dataclasses.field(
        default_factory=dict)

    def populate_with_commitment(self, digest: int, store: Store) -> None:
        secret, payload = store.comms[digest]
        zpay = self.zdag.populate_with(payload, store)
        self.comms[digest] = (secret, zpay)

    def to_json(self) -> dict:
        return {
            "zdag": self.zdag.to_json(),
            "comms": [
                {"digest": f"{d:x}", "secret": f"{s:x}",
                 "payload": {"tag": z.tag, "digest": f"{z.digest:x}"}}
                for d, (s, z) in self.comms.items()
            ],
        }

    @staticmethod
    def from_json(data: dict) -> "ZStore":
        zs = ZStore(ZDag.from_json(data["zdag"]))
        for e in data["comms"]:
            zs.comms[int(e["digest"], 16)] = (
                int(e["secret"], 16),
                ZPtr(e["payload"]["tag"], int(e["payload"]["digest"], 16)))
        return zs

    def populate_store(self, store: Store) -> None:
        for digest, (secret, zpay) in self.comms.items():
            pay = self.zdag.populate_store(zpay, store)
            store.add_comm(digest, secret, pay)

