"""Trie coprocessor: arity-8, height-85 Merkle-Poseidon trie.

The port of the JAX package's ``coproc/trie.py`` (reference
src/coprocessor/trie/mod.rs): `StandardTrie =
Trie<F, 8, 85>` with New/Lookup/Insert coprocessors. Key path = the
big-endian bits of the key taken 3 at a time (85 * 3 = 255); empty
subtrees are precomputed (empty_roots chain of hash8); preimages are
registered in the store's inverse Poseidon cache so lookups can walk
digests back to children.

Anchors: the reference pins empty roots for small heights
(trie/mod.rs:925-940), reproduced in tests. ``HEIGHT`` is a module
global that every function reads when it is called, so a test can make
the trie shallow.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..lem.circuit import AllocatedPtr
from ..lem.evaluation import Coprocessor, Lang
from ..poseidon.circuit import poseidon_circuit
from ..r1cs.gadgets import (
    Bool, Num, alloc_num, bool_and, implies_equal, pick, to_bits_le_strict,
)
from ..store.core import Ptr, Store
from ..symbol import Symbol
from ..tags import ExprTag

ARITY = 8
ARITY_BITS = 3
HEIGHT = 85


class TrieError(Exception):
    pass


class Trie:
    """Sparse Merkle trie backed by a store's Poseidon inverse cache."""

    def __init__(self, store: Store, root: Optional[int] = None):
        self.store = store
        self.empty_roots = self._compute_empty_roots()
        self.root = self.empty_roots[HEIGHT - 1] if root is None else root

    def _hash(self, preimage: List[int]) -> int:
        # memoized + registered in the inverse cache
        return self.store.poseidon.hash(preimage)

    def _preimage(self, digest: int) -> Optional[Tuple[int, ...]]:
        return self.store.poseidon.inverse.get((ARITY, digest))

    def _compute_empty_roots(self) -> List[int]:
        cache = getattr(self.store, "_trie_empty_roots", None)
        if cache is not None:
            return cache
        roots = []
        preimage = [0] * ARITY
        for _ in range(HEIGHT):
            h = self._hash(list(preimage))
            roots.append(h)
            preimage = [h] * ARITY
        self.store._trie_empty_roots = roots
        return roots

    def empty_root_for_height(self, height: int) -> int:
        if height == 0:
            return 0
        return self.empty_roots[height - 1]

    @staticmethod
    def path(key: int, num_bits: int) -> List[int]:
        """Big-endian 3-bit chunks of the key (trie/mod.rs:580-607)."""
        bits_needed = ARITY_BITS * HEIGHT
        bits = [(key >> i) & 1 for i in range(num_bits)]  # LE
        bits += [0] * (bits_needed - len(bits))
        bits.reverse()  # BE
        bits = bits[len(bits) - bits_needed:]
        out = []
        for c in range(HEIGHT):
            chunk = bits[c * ARITY_BITS:(c + 1) * ARITY_BITS]
            acc = 0
            for b in chunk:
                acc = 2 * acc + b
            out.append(acc)
        return out

    def _key_path(self, key: int) -> List[int]:
        return self.path(key, self.store.field.num_bits)

    # -- lookup ---------------------------------------------------------------

    def prove_lookup(self, key: int) -> List[Tuple[int, ...]]:
        """Preimage path from root to leaf (Merkle inclusion hint)."""
        path = self._key_path(key)
        preimages = []
        nxt = self.root
        for k in path:
            pre = self._preimage(nxt)
            if pre is None:
                raise TrieError(f"missing preimage for {nxt:#x}")
            preimages.append(pre)
            nxt = pre[k]
        return preimages

    def lookup_aux(self, key: int) -> int:
        path = self._key_path(key)
        preimages = self.prove_lookup(key)
        return preimages[-1][path[-1]]

    def lookup(self, key: int) -> Optional[int]:
        payload = self.lookup_aux(key)
        return payload if payload != 0 else None

    # -- insert ---------------------------------------------------------------

    def insert(self, key: int, value: int) -> bool:
        path = self._key_path(key)
        old_preimages = self.prove_lookup(key)
        new_value = value
        for k, pre in zip(reversed(path), reversed(old_preimages)):
            new_pre = list(pre)
            new_pre[k] = new_value
            new_value = self._hash(new_pre)
        inserted = new_value != self.root
        self.root = new_value
        return inserted


# -- circuit side (CoCircuit parity, trie/mod.rs:611-890) ----------------------
#
# Merkle path verification in-circuit: HEIGHT levels, each allocating the
# arity-8 preimage as advice, constraining poseidon8(preimage) == parent
# (under not_dummy) and selecting the followed child with a constrained
# 3-bit multiplexer. Insert re-hashes the modified path bottom-up with
# minterm-selected substitution (the reference allocates the new preimage
# unconstrained at non-path indices, trie/mod.rs:846-876; we constrain
# every entry — strictly sounder, same shape every frame).


def _path_chunks_bits(cs, key_num):
    """In-circuit analog of Trie.path: 85 chunks of 3 Bools, each chunk
    [msb, mid, lsb] so that k = 4*b0 + 2*b1 + b2 (trie/mod.rs:611-629)."""
    bits = to_bits_le_strict(cs, key_num)        # LE, num_bits long
    bits_needed = ARITY_BITS * HEIGHT
    bits = bits + [Bool.false()] * (bits_needed - len(bits))
    bits.reverse()                               # BE
    bits = bits[len(bits) - bits_needed:]
    return [bits[c * ARITY_BITS:(c + 1) * ARITY_BITS]
            for c in range(HEIGHT)]


def _select8(cs, vals, chunk):
    """Constrained 8-way multiplexer by the 3-bit chunk [b0(msb),b1,b2]."""
    b0, b1, b2 = chunk
    lvl1 = [pick(cs, b2, vals[2 * j + 1], vals[2 * j]) for j in range(4)]
    lvl2 = [pick(cs, b1, lvl1[2 * j + 1], lvl1[2 * j]) for j in range(2)]
    return pick(cs, b0, lvl2[1], lvl2[0])


def _minterms8(cs, chunk):
    """is_j booleans for j = 0..7 from the 3-bit chunk."""
    b0, b1, b2 = chunk
    n0, n1, n2 = b0.not_(), b1.not_(), b2.not_()
    out = []
    for j in range(ARITY):
        x0 = b0 if (j >> 2) & 1 else n0
        x1 = b1 if (j >> 1) & 1 else n1
        x2 = b2 if j & 1 else n2
        out.append(bool_and(cs, bool_and(cs, x0, x1), x2))
    return out


def _concrete_trie(synth, not_dummy, root_val: int) -> Trie:
    store = synth.store
    if (not synth.ctx.blank) and not_dummy.value:
        return Trie(store, root_val)
    return Trie(store)   # dummy path: empty trie, key 0


def _synthesize_lookup_path(synth, not_dummy, root_num, key_num,
                            trie: Trie):
    """Walk root->leaf; returns (selected leaf value Num, per-level
    allocated preimages, path chunks). Constraints are implied by
    not_dummy, so dummy/blank frames stay satisfiable."""
    cs = synth.cs
    field = synth.store.field
    key_val = key_num.value % field.modulus
    host_path = Trie.path(key_val, field.num_bits)
    host_preimages = trie.prove_lookup(key_val)
    chunks = _path_chunks_bits(cs, key_num)

    allocated_root = alloc_num(cs, trie.root)
    implies_equal(cs, not_dummy, root_num, allocated_root)

    nxt = allocated_root
    preimage_allocs = []
    for lvl in range(HEIGHT):
        pre = [alloc_num(cs, v) for v in host_preimages[lvl]]
        preimage_allocs.append(pre)
        digest = poseidon_circuit(cs, field, pre)
        implies_equal(cs, not_dummy, digest, nxt)
        nxt = _select8(cs, pre, chunks[lvl])
        assert not ((not synth.ctx.blank) and not_dummy.value) or \
            nxt.value == host_preimages[lvl][host_path[lvl]]
    return nxt, preimage_allocs, chunks


def _synthesize_insert(synth, not_dummy, root_num, key_num, val_num):
    """New root after writing val at key (trie/mod.rs:802-880)."""
    cs = synth.cs
    field = synth.store.field
    trie = _concrete_trie(synth, not_dummy, root_num.value)
    _, preimages, chunks = _synthesize_lookup_path(
        synth, not_dummy, root_num, key_num, trie)
    value = val_num
    for lvl in range(HEIGHT - 1, -1, -1):
        is_j = _minterms8(cs, chunks[lvl])
        new_pre = [pick(cs, is_j[j], value, preimages[lvl][j])
                   for j in range(ARITY)]
        value = poseidon_circuit(cs, field, new_pre)
    return value


class NewCircuit:
    """(.lurk.trie.new): the empty root is a circuit constant
    (trie/mod.rs:76-91)."""

    def synthesize(self, synth, not_dummy, inp):
        cs = synth.cs
        env, cont = inp[-2], inp[-1]
        root = Trie(synth.store).root
        out = AllocatedPtr(Num.constant(cs, int(ExprTag.Num)),
                           Num.constant(cs, root))
        return [out, env, cont]


class LookupCircuit:
    """(.lurk.trie.lookup root key) -> Comm(payload)
    (trie/mod.rs:118-190)."""

    def synthesize(self, synth, not_dummy, inp):
        cs = synth.cs
        root_ptr, key_ptr = inp[0], inp[1]
        env, cont = inp[-2], inp[-1]
        trie = _concrete_trie(synth, not_dummy, root_ptr.hash.value)
        found, _, _ = _synthesize_lookup_path(
            synth, not_dummy, root_ptr.hash, key_ptr.hash, trie)
        out = AllocatedPtr(Num.constant(cs, int(ExprTag.Comm)), found)
        return [out, env, cont]


class InsertCircuit:
    """(.lurk.trie.insert root key val) -> Num(new_root)
    (trie/mod.rs:226-311)."""

    def synthesize(self, synth, not_dummy, inp):
        cs = synth.cs
        root_ptr, key_ptr, val_ptr = inp[0], inp[1], inp[2]
        env, cont = inp[-2], inp[-1]
        new_root = _synthesize_insert(synth, not_dummy, root_ptr.hash,
                                      key_ptr.hash, val_ptr.hash)
        out = AllocatedPtr(Num.constant(cs, int(ExprTag.Num)), new_root)
        return [out, env, cont]


# -- coprocessors (TrieCoproc parity) -----------------------------------------


def _new_evaluate(store: Store, args: List[Ptr]) -> Ptr:
    return store.num(Trie(store).root)


def _lookup_evaluate(store: Store, args: List[Ptr]) -> Ptr:
    root = store.hash_ptr(args[0]).digest
    key = store.hash_ptr(args[1]).digest
    trie = Trie(store, root)
    return store.comm(trie.lookup_aux(key))


def _insert_evaluate(store: Store, args: List[Ptr]) -> Ptr:
    root = store.hash_ptr(args[0]).digest
    key = store.hash_ptr(args[1]).digest
    val = store.hash_ptr(args[2]).digest
    trie = Trie(store, root)
    trie.insert(key, val)
    return store.num(trie.root)


def new_coprocessor() -> Coprocessor:
    return Coprocessor(arity=0, evaluate=_new_evaluate,
                       circuit=NewCircuit())


def lookup_coprocessor() -> Coprocessor:
    return Coprocessor(arity=2, evaluate=_lookup_evaluate,
                       circuit=LookupCircuit())


def insert_coprocessor() -> Coprocessor:
    return Coprocessor(arity=3, evaluate=_insert_evaluate,
                       circuit=InsertCircuit())


def install_trie_lang() -> Tuple[Lang, Symbol, Symbol, Symbol]:
    """Lang with .lurk.trie.{new,lookup,insert} (trie demo parity)."""
    new_sym = Symbol(("lurk", "trie", "new"), False)
    lookup_sym = Symbol(("lurk", "trie", "lookup"), False)
    insert_sym = Symbol(("lurk", "trie", "insert"), False)
    lang = Lang()
    lang.add_coprocessor(new_sym, new_coprocessor())
    lang.add_coprocessor(lookup_sym, lookup_coprocessor())
    lang.add_coprocessor(insert_sym, insert_coprocessor())
    return lang, new_sym, lookup_sym, insert_sym
