"""R1CS constraint system: shape + witness in one synthesis pass.

A copy of the JAX package's ``r1cs/cs.py``. Replaces the reference's
bellpepper `ConstraintSystem`/`TestConstraintSystem`/`WitnessCS` stack
(bellpepper-core; used via reference src/lem/circuit.rs) with a single
Python builder:

  - Variables are dense indices: 0 is the constant ONE, then `num_inputs`
    public inputs, then aux. A linear combination is a dict {var: coeff}.
  - One synthesis walk yields BOTH the circuit shape (sparse A/B/C rows)
    and the witness values. Because LEM circuits are uniform (every frame
    takes the same allocation path), the shape from any frame is THE shape;
    uniformity is pinned by tests.
  - `to_matrices` exports the shape as numpy CSR-like arrays for the
    device-side sparse matvec used by the Nova fold.

Witness-only mode (`witness_only=True`) skips constraint recording for
fast per-frame witness generation (WitnessCS parity).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..fields import FieldSpec

LC = Dict[int, int]


def lc_add(a: LC, b: LC, p: int) -> LC:
    out = dict(a)
    for k, v in b.items():
        nv = (out.get(k, 0) + v) % p
        if nv:
            out[k] = nv
        else:
            out.pop(k, None)
    return out


def lc_scale(a: LC, s: int, p: int) -> LC:
    s %= p
    if s == 0:
        return {}
    return {k: (v * s) % p for k, v in a.items()}


def lc_sub(a: LC, b: LC, p: int) -> LC:
    return lc_add(a, lc_scale(b, -1, p), p)


class SynthesisError(Exception):
    pass


class ConstraintSystem:
    """R1CS builder over one prime field."""

    def __init__(self, field: FieldSpec, witness_only: bool = False,
                 check: bool = False):
        self.field = field
        self.p = field.modulus
        self.witness_only = witness_only
        self.check = check                    # verify each row on the fly
        self.num_inputs = 1                   # var 0 = ONE
        self.aux: List[int] = []              # aux values
        self.inputs: List[int] = [1]          # input values (incl. ONE)
        # shape rows: (A, B, C) sparse LCs
        self.constraints: List[Tuple[LC, LC, LC]] = []

    # -- variables ----------------------------------------------------------

    ONE_VAR = 0

    def alloc(self, value: int) -> int:
        """Allocate an aux variable; returns its index."""
        v = value % self.p
        self.aux.append(v)
        return self.num_inputs + len(self.aux) - 1

    def alloc_input(self, value: int) -> int:
        """Allocate a public input. Must happen before any aux allocation
        (dense layout)."""
        assert not self.aux, "inputs must be allocated before aux"
        self.inputs.append(value % self.p)
        self.num_inputs += 1
        return self.num_inputs - 1

    def value_of(self, var: int) -> int:
        if var < self.num_inputs:
            return self.inputs[var]
        return self.aux[var - self.num_inputs]

    def eval_lc(self, lc: LC) -> int:
        return sum(c * self.value_of(v) for v, c in lc.items()) % self.p

    # -- constraints ---------------------------------------------------------

    def enforce(self, a: LC, b: LC, c: LC) -> None:
        if self.check:
            av, bv, cv = self.eval_lc(a), self.eval_lc(b), self.eval_lc(c)
            if (av * bv - cv) % self.p != 0:
                raise SynthesisError(
                    f"unsatisfied constraint #{len(self.constraints)}: "
                    f"{av} * {bv} != {cv}")
        if not self.witness_only:
            self.constraints.append((a, b, c))

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    @property
    def num_aux(self) -> int:
        return len(self.aux)

    # -- verification / export ----------------------------------------------

    def witness_vector(self) -> List[int]:
        """Full assignment z = (inputs | aux)."""
        return self.inputs + self.aux

    def is_satisfied(self, z: Optional[List[int]] = None) -> bool:
        z = z if z is not None else self.witness_vector()
        p = self.p

        def ev(lc: LC) -> int:
            return sum(c * z[v] for v, c in lc.items()) % p

        return all((ev(a) * ev(b) - ev(c)) % p == 0
                   for a, b, c in self.constraints)

    def first_unsatisfied(self, z: Optional[List[int]] = None
                          ) -> Optional[int]:
        z = z if z is not None else self.witness_vector()
        p = self.p

        def ev(lc: LC) -> int:
            return sum(c * z[v] for v, c in lc.items()) % p

        for i, (a, b, c) in enumerate(self.constraints):
            if (ev(a) * ev(b) - ev(c)) % p != 0:
                return i
        return None

    def shape_digest(self) -> str:
        """Order-sensitive hash of the full shape — used by uniformity tests
        and public-param cache keys (circuit_cache_key parity)."""
        import hashlib
        h = hashlib.sha256()
        h.update(f"{self.num_inputs}:{len(self.aux)}".encode())
        for a, b, c in self.constraints:
            for lc in (a, b, c):
                for var in sorted(lc):
                    h.update(var.to_bytes(4, "little"))
                    h.update((lc[var]).to_bytes(32, "little"))
                h.update(b"|")
            h.update(b";")
        return h.hexdigest()


class Shape:
    """Frozen circuit shape: sparse A/B/C in COO int arrays (uint32 rows/
    cols, 32-byte little-endian limbs for coeffs handled field-side)."""

    def __init__(self, cs: ConstraintSystem):
        self.field = cs.field
        self.num_inputs = cs.num_inputs
        self.num_aux = cs.num_aux
        self.num_constraints = cs.num_constraints
        self.rows = cs.constraints

    def matrices_coo(self):
        """(A, B, C) each as (row_idx[], col_idx[], coeff[]) python lists."""
        mats = []
        for which in range(3):
            rows, cols, vals = [], [], []
            for i, row in enumerate(self.rows):
                for var, coeff in sorted(row[which].items()):
                    rows.append(i)
                    cols.append(var)
                    vals.append(coeff)
            mats.append((rows, cols, vals))
        return mats
