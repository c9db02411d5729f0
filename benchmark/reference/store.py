"""Lurk's content addressing on Python integers: a node's digest is
Poseidon over its children's (tag, digest) pairs (4, 6 or 8 elements
for 2, 3 or 4 children), or, for a compact triple (a, b, c), over
(digest a, tag b, digest b, digest c); an atom's digest is its value
(the reference's ``store_core.rs`` and ``store.rs``).

The graph is the program's (which node points at which), handed over as
plain data: ``nodes[key] = ("atom", value)``, ``("tuple", [(tag,
child key), ..])`` or ``("compact", [(tag, child key)] * 3)``. Every
digest is worked out again here from the atoms up.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Tuple

from .poseidon import poseidon_hash

Node = Tuple[str, object]


def digests(nodes: Dict[Hashable, Node], p: int) -> Dict[Hashable, int]:
    out: Dict[Hashable, int] = {}
    for root in nodes:
        stack = [root]
        while stack:
            key = stack[-1]
            if key in out:
                stack.pop()
                continue
            kind, body = nodes[key]
            if kind == "atom":
                out[key] = body % p
                stack.pop()
                continue
            pending = [ch for _, ch in body if ch not in out]
            if pending:
                stack.extend(pending)
                continue
            if kind == "compact":
                (_, a), (tb, b), (_, c) = body
                pre = [out[a], tb, out[b], out[c]]
            else:
                pre = []
                for tag, ch in body:
                    pre += [tag, out[ch]]
            out[key] = poseidon_hash(p, pre)
            stack.pop()
    return out


def reachable_atoms(nodes: Dict[Hashable, Node],
                    roots: List[Tuple[int, Hashable]],
                    tag: int) -> set:
    """Values of the atoms with ``tag`` reachable from ``roots``."""
    seen, found = set(), set()
    stack = list(roots)
    while stack:
        t, key = stack.pop()
        if (t, key) in seen:
            continue
        seen.add((t, key))
        kind, body = nodes[key]
        if kind == "atom":
            if t == tag:
                found.add(body)
            continue
        stack.extend(body)
    return found
