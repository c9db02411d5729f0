"""Circom coprocessor: load compiled circom gadgets into LEM circuits.

The port of the JAX package's ``coproc/circom.py`` (reference
src/coprocessor/circom/mod.rs: CircomGadget / CircomCoprocessor via the
external circom-scotia crate; src/cli/circom.rs: gadget packaging under
``<circom_dir>/<AUTHOR>/<NAME>``). Host Python: nothing here runs a
torch op, so a forked witness worker may synthesize a circom step.

The reference compiles ``.circom`` sources with a downloaded circom
binary and computes witnesses through a WASM calculator. As in the JAX
package:

  - ``.r1cs`` / ``.wtns`` files are parsed natively (the iden3 binary
    formats), no circom-scotia needed;
  - witnesses come from the gadget's ``<name>.wasm`` run by
    :mod:`.wasm_witness`, else from a user-configured command
    (``LURK_TPU_CIRCOM_WITNESS``, e.g. a circom-generated C++ calculator
    or ``snarkjs wtns calculate``), else from a shipped static ``.wtns``.

Where the JAX package ``assert``s (the wasm field against the r1cs one,
the witness's length, a satisfied witness), the port raises, so that
``python -O`` does not accept an unsatisfied witness.

Wire convention (circom): wire 0 = ONE, then public outputs, public
inputs, private inputs, internal.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..lem.circuit import AllocatedPtr
from ..lem.evaluation import Coprocessor
from ..proof.params_cache import cache_base
from ..r1cs.cs import SynthesisError, lc_add, lc_scale
from ..r1cs.gadgets import Num, alloc_num, implies_equal
from ..tags import ExprTag

LC = Dict[int, int]


# ---------------------------------------------------------------------------
# iden3 binary formats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class R1cs:
    prime: int
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    constraints: List[Tuple[LC, LC, LC]]


def _read_lc(buf: bytes, off: int, fs: int) -> Tuple[LC, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    lc: LC = {}
    for _ in range(n):
        (wire,) = struct.unpack_from("<I", buf, off)
        off += 4
        coeff = int.from_bytes(buf[off:off + fs], "little")
        off += fs
        lc[wire] = coeff
    return lc, off


def _sections(buf: bytes, magic: bytes, what: str) -> Dict[int, int]:
    """The offsets of an iden3 file's sections, by section type."""
    if buf[:4] != magic:
        raise ValueError(f"not a {what} file (bad magic)")
    (_version, n_sections) = struct.unpack_from("<II", buf, 4)
    off = 12
    sections = {}
    for _ in range(n_sections):
        (typ,) = struct.unpack_from("<I", buf, off)
        (size,) = struct.unpack_from("<Q", buf, off + 4)
        sections[typ] = off + 12
        off += 12 + size
    return sections


def parse_r1cs(path) -> R1cs:
    """Parse the iden3 `.r1cs` binary format (magic 'r1cs', sectioned)."""
    buf = Path(path).read_bytes()
    sections = _sections(buf, b"r1cs", "r1cs")
    # section 1: header
    h_off = sections[1]
    (fs,) = struct.unpack_from("<I", buf, h_off)
    prime = int.from_bytes(buf[h_off + 4:h_off + 4 + fs], "little")
    (n_wires, n_pub_out, n_pub_in, n_prv_in) = struct.unpack_from(
        "<IIII", buf, h_off + 4 + fs)
    (n_labels,) = struct.unpack_from("<Q", buf, h_off + 20 + fs)
    (n_constraints,) = struct.unpack_from("<I", buf, h_off + 28 + fs)
    # section 2: constraints
    constraints = []
    off = sections[2]
    for _ in range(n_constraints):
        a, off = _read_lc(buf, off, fs)
        b, off = _read_lc(buf, off, fs)
        c, off = _read_lc(buf, off, fs)
        constraints.append((a, b, c))
    return R1cs(prime, n_wires, n_pub_out, n_pub_in, n_prv_in,
                n_labels, constraints)


def parse_wtns(path) -> List[int]:
    """Parse the iden3 `.wtns` binary witness format."""
    buf = Path(path).read_bytes()
    sections = _sections(buf, b"wtns", "wtns")
    h_off = sections[1]
    (fs,) = struct.unpack_from("<I", buf, h_off)
    (n,) = struct.unpack_from("<I", buf, h_off + 4 + fs)
    off = sections[2]
    return [int.from_bytes(buf[off + i * fs:off + (i + 1) * fs], "little")
            for i in range(n)]


def write_wtns(path, values: Sequence[int], prime: int) -> None:
    """Emit a `.wtns` file (test harness / external-calculator shim)."""
    fs = 32
    body1 = struct.pack("<I", fs) + prime.to_bytes(fs, "little") + \
        struct.pack("<I", len(values))
    body2 = b"".join(int(v).to_bytes(fs, "little") for v in values)
    out = b"wtns" + struct.pack("<II", 2, 2)
    out += struct.pack("<IQ", 1, len(body1)) + body1
    out += struct.pack("<IQ", 2, len(body2)) + body2
    Path(path).write_bytes(out)


# ---------------------------------------------------------------------------
# Gadget registry (cli/circom.rs parity)
# ---------------------------------------------------------------------------


def circom_dir() -> Path:
    """``<cache>/circom``: the JAX package's layout under the same base,
    so a gadget packaged by either package loads in the other."""
    d = cache_base() / "circom"
    d.mkdir(parents=True, exist_ok=True)
    return d


def create_circom_gadget(folder, reference: str,
                         field: str = "vesta") -> Path:
    """Package a gadget under `<circom_dir>/<AUTHOR>/<NAME>`.

    If `<folder>/<NAME>.r1cs` (+ optional `.wasm`, `.wtns`) already exist
    they are copied; otherwise a circom binary (LURK_TPU_CIRCOM_BIN or
    `circom` on PATH) compiles `<NAME>.circom` — mirroring
    cli/circom.rs:80-140 minus the binary auto-download. `meta.json` is
    the JAX package's, byte for byte."""
    parts = reference.split("/")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        raise ValueError(
            f'expected a reference of format "<AUTHOR>/<NAME>", '
            f'got "{reference}"')
    author, name = parts
    folder = Path(folder)
    dest = circom_dir() / author / name
    dest.mkdir(parents=True, exist_ok=True)
    r1cs_src = folder / f"{name}.r1cs"
    if not r1cs_src.exists():
        circom_bin = os.environ.get("LURK_TPU_CIRCOM_BIN", "circom")
        src = folder / f"{name}.circom"
        if not src.exists():
            raise FileNotFoundError(
                f"neither {r1cs_src} nor {src} exists")
        subprocess.run(
            [circom_bin, str(src), "--r1cs", "--wasm",
             "--output", str(folder), "--prime", field],
            check=True)
    # validate + copy static files
    r1cs = parse_r1cs(r1cs_src)
    (dest / f"{name}.r1cs").write_bytes(r1cs_src.read_bytes())
    for ext in ("wasm", "wtns"):
        extra = folder / f"{name}.{ext}"
        if extra.exists():
            (dest / f"{name}.{ext}").write_bytes(extra.read_bytes())
    (dest / "meta.json").write_text(json.dumps({
        "reference": reference,
        "n_wires": r1cs.n_wires,
        "n_pub_out": r1cs.n_pub_out,
        "n_pub_in": r1cs.n_pub_in,
        "n_constraints": len(r1cs.constraints),
        "prime": f"{r1cs.prime:x}",
    }))
    return dest


# ---------------------------------------------------------------------------
# Coprocessor (CircomCoprocessor parity)
# ---------------------------------------------------------------------------


def _digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()


@dataclasses.dataclass
class CircomGadget:
    """A loaded gadget. Witness sources, in priority order: the
    circom-compiled `<name>.wasm` run by the wasm interpreter
    (:mod:`.wasm_witness` — the reference's own mechanism, via
    circom-scotia's witness calculator); an external `witness_cmd`
    invoked as `cmd <input.json> <output.wtns>`; a shipped static
    `.wtns`."""

    reference: str
    r1cs: R1cs = dataclasses.field(repr=False)
    wasm_path: Optional[str] = None
    witness_cmd: Optional[str] = None
    static_wtns: Optional[List[int]] = dataclasses.field(default=None,
                                                         repr=False)

    @staticmethod
    def load(reference: str) -> "CircomGadget":
        author, name = reference.split("/")
        base = circom_dir() / author / name
        r1cs = parse_r1cs(base / f"{name}.r1cs")
        wtns_path = base / f"{name}.wtns"
        static_wtns = parse_wtns(wtns_path) if wtns_path.exists() else None
        wasm = None
        for cand in (base / f"{name}.wasm",
                     base / f"{name}_js" / f"{name}.wasm"):
            if cand.exists():
                wasm = str(cand)
                break
        return CircomGadget(
            reference, r1cs, wasm_path=wasm,
            witness_cmd=os.environ.get("LURK_TPU_CIRCOM_WITNESS"),
            static_wtns=static_wtns)

    # digests of the r1cs and the static witness, computed once: the
    # repr (and so the key of cached public parameters, params_cache.
    # lang_circuits) names the gadget by its reference, witness sources
    # and these, and does not walk the constraints again
    key: tuple = dataclasses.field(init=False, compare=False)

    def __post_init__(self):
        r = self.r1cs
        self.key = (_digest((r.prime, r.n_wires, r.n_pub_out, r.n_pub_in,
                             r.n_prv_in, r.n_labels, r.constraints)),
                    None if self.static_wtns is None
                    else _digest(self.static_wtns))

    def calculate_witness(self, inputs: Dict[str, List[int]]
                          ) -> List[int]:
        if self.wasm_path:
            from .wasm_witness import load_witness_calculator
            calc = load_witness_calculator(self.wasm_path)
            if calc.prime != self.r1cs.prime:
                raise ValueError(
                    f"circom gadget {self.reference}: the wasm field "
                    "does not match the r1cs one")
            return calc.calculate_witness(inputs)
        if self.witness_cmd:
            import tempfile
            with tempfile.TemporaryDirectory() as td:
                inp = Path(td) / "input.json"
                out = Path(td) / "out.wtns"
                inp.write_text(json.dumps(
                    {k: [str(x) for x in v] for k, v in inputs.items()}))
                subprocess.run(
                    self.witness_cmd.split() + [str(inp), str(out)],
                    check=True)
                return parse_wtns(out)
        if self.static_wtns is not None:
            return list(self.static_wtns)
        raise RuntimeError(
            f"no witness source for circom gadget {self.reference}: "
            "set LURK_TPU_CIRCOM_WITNESS or ship a .wtns file")

    def check_witness(self, w: Sequence[int]) -> bool:
        p = self.r1cs.prime

        def ev(lc: LC) -> int:
            return sum(c * w[i] for i, c in lc.items()) % p
        return all(
            (ev(a) * ev(b) - ev(c)) % p == 0
            for a, b, c in self.r1cs.constraints)


class CircomCircuit:
    """CoCircuit side: allocates every circom wire, enforces all r1cs
    rows (implied by not_dummy), binds wire[1+n_pub_out..] public inputs
    to the lurk argument hashes, returns public output 0 as a Num ptr
    (circom/mod.rs:150-220 functional parity). A concrete synthesis runs
    the gadget's witness source again, in whatever process synthesizes
    the step."""

    def __init__(self, gadget: CircomGadget):
        self.gadget = gadget

    def synthesize(self, synth, not_dummy, inp):
        cs = synth.cs
        r1 = self.gadget.r1cs
        if r1.prime != cs.p:
            raise SynthesisError(
                f"circom gadget {self.gadget.reference} compiled for a "
                f"different prime than the lurk field")
        n_args = r1.n_pub_in
        args = inp[:n_args]
        env, cont = inp[-2], inp[-1]
        concrete = (not synth.ctx.blank) and not_dummy.value
        if concrete:
            wit = self.gadget.calculate_witness({
                "in": [a.hash.value for a in args]})
            if len(wit) != r1.n_wires:
                raise SynthesisError(
                    f"circom gadget {self.gadget.reference}: a witness of "
                    f"{len(wit)} wires, expected {r1.n_wires}")
        else:
            wit = [1] + [0] * (r1.n_wires - 1)
        wires = [Num.constant(cs, 1)] + \
            [alloc_num(cs, v) for v in wit[1:]]
        # bind public inputs to the lurk args
        for i, a in enumerate(args):
            implies_equal(cs, not_dummy, a.hash,
                          wires[1 + r1.n_pub_out + i])

        def to_lc(lc: LC):
            acc: Dict[int, int] = {}
            for wire, coeff in lc.items():
                acc = lc_add(acc, lc_scale(wires[wire].lc, coeff, cs.p),
                             cs.p)
            return acc

        nd = not_dummy.lc(cs)
        for a, b, c in r1.constraints:
            # not_dummy * (A*B - C) == 0 requires degree 3; instead
            # allocate ab = A*B then imply ab == C (2 constraints/row)
            av = sum(coeff * wit[wi] for wi, coeff in a.items()) % cs.p
            bv = sum(coeff * wit[wi] for wi, coeff in b.items()) % cs.p
            ab = alloc_num(cs, av * bv % cs.p)
            cs.enforce(to_lc(a), to_lc(b), ab.lc)
            cs.enforce(nd, lc_add(ab.lc, lc_scale(to_lc(c), cs.p - 1,
                                                  cs.p), cs.p), {})
        out = AllocatedPtr(Num.constant(cs, int(ExprTag.Num)), wires[1])
        return [out, env, cont]


def circom_coprocessor(gadget: CircomGadget) -> Coprocessor:
    """Coprocessor wrapping a circom gadget: evaluation computes the
    witness, checks it against the r1cs (raising ``ValueError`` if it
    fails) and returns public output 0; the circuit enforces the full
    r1cs."""

    def evaluate(store, args):
        wit = gadget.calculate_witness({
            "in": [store.hash_ptr(a).digest for a in args]})
        if not gadget.check_witness(wit):
            raise ValueError(
                f"circom gadget {gadget.reference}: the witness does not "
                "satisfy its r1cs")
        return store.num(wit[1] % store.field.modulus)

    return Coprocessor(arity=gadget.r1cs.n_pub_in, evaluate=evaluate,
                       circuit=CircomCircuit(gadget))
