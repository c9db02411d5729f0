"""Proof persistence: LurkProof / LurkProofMeta / Commitment files.

The port of the JAX package's ``cli/lurk_proof.py``. Proofs and
commitments live in the same directories, ``$LURK_TPU_CACHE/proofs``
and ``$LURK_TPU_CACHE/commits`` (default base ``~/.lurk_tpu``), under
the same names, as the same bytes: a proof file is a proof file,
whichever package wrote it. Parity: reference src/cli/lurk_proof.rs:
30-80, field_data.rs, commitment.rs, paths.rs; the proof key is
``{backend}_{field}_{rc}_{claim_hash}`` (repl/mod.rs:297-300).

The writers take Python ints (and their subclasses, such as the tags)
only: a tensor or a numpy scalar raises ``TypeError`` instead of
reaching the file. Field vectors may be
:class:`..hostlib.r1cs.PackedVec`; the readers return lists of ints,
which every verifier takes. The port's Spartan opens W and E jointly
(``hkzg_joint``); the separate HyperKZG openings (``hkzg_w``/``hkzg_e``)
of the JAX package's older proofs are read, and verified, too.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple

from ..curves.weierstrass import Affine
from ..hostlib.r1cs import PackedVec
from ..proof.nova import (
    FoldingProof, R1CSInstance, RelaxedInstance, RelaxedWitness,
)
from ..proof.params_cache import cache_base
from ..store.core import Store, ZPtr
from ..store.zdag import ZDag


def _cache_subdir(name: str) -> Path:
    d = cache_base() / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def proofs_dir() -> Path:
    return _cache_subdir("proofs")


def commits_dir() -> Path:
    return _cache_subdir("commits")


def _hex(v) -> str:
    if not isinstance(v, int):     # a tag may be an IntEnum
        raise TypeError(f"a proof value of type {type(v).__name__}, not a "
                        f"Python int")
    return f"{v:x}"


def _hexes(vec) -> list:
    vals = vec.ints() if isinstance(vec, PackedVec) else vec
    return [_hex(v) for v in vals]


def _ints(vals) -> list:
    return [int(v, 16) for v in vals]


def _pt(p: Affine):
    return None if p is None else [_hex(p[0]), _hex(p[1])]


def _un_pt(v) -> Affine:
    return None if v is None else (int(v[0], 16), int(v[1], 16))


def _inst_to_json(inst: R1CSInstance) -> dict:
    return {"comm_w": _pt(inst.comm_w), "x": _hexes(inst.x)}


def _inst_from_json(d: dict) -> R1CSInstance:
    return R1CSInstance(_un_pt(d["comm_w"]), _ints(d["x"]))


def _steps_to_json(steps) -> list:
    """(instance, comm_T) steps of a fold chain."""
    return [{**_inst_to_json(inst), "comm_t": _pt(comm_t)}
            for inst, comm_t in steps]


def _steps_from_json(steps) -> list:
    return [(_inst_from_json(s), _un_pt(s["comm_t"])) for s in steps]


def _nivc_steps_to_json(steps) -> list:
    """(pc, instance, comm_T) steps of an NIVC fold chain."""
    return [{"pc": pc, **_inst_to_json(inst), "comm_t": _pt(comm_t)}
            for pc, inst, comm_t in steps]


def _nivc_steps_from_json(steps) -> list:
    return [(s["pc"], _inst_from_json(s), _un_pt(s["comm_t"]))
            for s in steps]


def proof_to_json(proof: FoldingProof) -> dict:
    return {
        "steps": _steps_to_json(proof.steps),
        "final_w": _hexes(proof.final_witness.w),
        "final_e": _hexes(proof.final_witness.e),
        "z0": _hexes(proof.z0),
        "zi": _hexes(proof.zi),
    }


def proof_from_json(d: dict) -> FoldingProof:
    return FoldingProof(_steps_from_json(d["steps"]),
                        RelaxedWitness(_ints(d["final_w"]),
                                       _ints(d["final_e"])),
                        _ints(d["z0"]), _ints(d["zi"]))


def nivc_proof_to_json(proof) -> dict:
    return {
        "steps": _nivc_steps_to_json(proof.steps),
        "final": {str(pc): _relaxed_wit_to_json(wit)
                  for pc, wit in proof.final_witnesses.items()},
        "z0": _hexes(proof.z0),
        "zi": _hexes(proof.zi),
    }


def nivc_proof_from_json(d: dict):
    from ..proof.supernova import NivcProof
    final = {int(pc): _relaxed_wit_from_json(wd)
             for pc, wd in d["final"].items()}
    return NivcProof(_nivc_steps_from_json(d["steps"]), final,
                     _ints(d["z0"]), _ints(d["zi"]))


def _spartan_to_json(sp) -> dict:
    out = {
        "sc1": [_hexes(row) for row in sp.sc1_polys],
        "claims": _hexes(sp.claims),
        "sc2": [_hexes(row) for row in sp.sc2_polys],
        "w_eval": _hex(sp.w_eval),
    }
    if sp.hkzg_joint is not None:
        j = sp.hkzg_joint
        out["hkzg_joint"] = {
            "comms": [[_pt(q) for q in cms] for cms in j.comms],
            "evals": [[_hexes(ev) for ev in evs] for evs in j.evals],
            "w": _pt(j.w), "wp": _pt(j.wp)}
    elif sp.hkzg_w is not None:
        for name, pr in (("hkzg_w", sp.hkzg_w), ("hkzg_e", sp.hkzg_e)):
            out[name] = {"comms": [_pt(q) for q in pr.comms],
                         "evals": [_hexes(ev) for ev in pr.evals],
                         "quotients": [_pt(q) for q in pr.quotients]}
    else:
        for name, pr in (("ipa_w", sp.ipa_w), ("ipa_e", sp.ipa_e)):
            out[name] = {"ls": [_pt(q) for q in pr.ls],
                         "rs": [_pt(q) for q in pr.rs],
                         "a": _hex(pr.a_final)}
    return out


def _spartan_from_json(d: dict):
    from ..proof.hyperkzg import HkzgBatchProof, HkzgProof
    from ..proof.ipa import IpaProof
    from ..proof.spartan import SpartanProof

    def ipa(v):
        return IpaProof([_un_pt(q) for q in v["ls"]],
                        [_un_pt(q) for q in v["rs"]], int(v["a"], 16))

    def hkzg(v):
        return HkzgProof([_un_pt(q) for q in v["comms"]],
                         [tuple(_ints(ev)) for ev in v["evals"]],
                         [_un_pt(q) for q in v["quotients"]])

    base = [[_ints(row) for row in d["sc1"]], tuple(_ints(d["claims"])),
            [_ints(row) for row in d["sc2"]], int(d["w_eval"], 16)]
    if "hkzg_joint" in d:
        v = d["hkzg_joint"]
        joint = HkzgBatchProof(
            [[_un_pt(q) for q in cms] for cms in v["comms"]],
            [[tuple(_ints(ev)) for ev in evs] for evs in v["evals"]],
            _un_pt(v["w"]), _un_pt(v["wp"]))
        return SpartanProof(*base, None, None, hkzg_joint=joint)
    if "hkzg_w" in d:
        return SpartanProof(*base, None, None, hkzg(d["hkzg_w"]),
                            hkzg(d["hkzg_e"]))
    return SpartanProof(*base, ipa(d["ipa_w"]), ipa(d["ipa_e"]))


def compressed_proof_to_json(proof) -> dict:
    """spartan.CompressedProof (IVC) -> json dict."""
    return {
        "steps": _steps_to_json(proof.steps),
        "spartan": _spartan_to_json(proof.spartan),
        "z0": _hexes(proof.z0),
        "zi": _hexes(proof.zi),
    }


def compressed_proof_from_json(d: dict):
    from ..proof.spartan import CompressedProof
    return CompressedProof(_steps_from_json(d["steps"]),
                           _spartan_from_json(d["spartan"]),
                           _ints(d["z0"]), _ints(d["zi"]))


def compressed_nivc_to_json(proof) -> dict:
    return {
        "steps": _nivc_steps_to_json(proof.steps),
        "spartans": {str(pc): _spartan_to_json(sp)
                     for pc, sp in proof.spartans.items()},
        "z0": _hexes(proof.z0),
        "zi": _hexes(proof.zi),
    }


def compressed_nivc_from_json(d: dict):
    from ..proof.supernova import CompressedNivcProof
    spartans = {int(pc): _spartan_from_json(sp)
                for pc, sp in d["spartans"].items()}
    return CompressedNivcProof(_nivc_steps_from_json(d["steps"]), spartans,
                               _ints(d["z0"]), _ints(d["zi"]))


def _relaxed_to_json(u) -> dict:
    return {"comm_w": _pt(u.comm_w), "comm_e": _pt(u.comm_e),
            "x": _hexes(u.x), "u": _hex(u.u)}


def _relaxed_from_json(d: dict) -> RelaxedInstance:
    return RelaxedInstance(_un_pt(d["comm_w"]), _un_pt(d["comm_e"]),
                           _ints(d["x"]), int(d["u"], 16))


def _relaxed_wit_to_json(w) -> dict:
    return {"w": _hexes(w.w), "e": _hexes(w.e)}


def _relaxed_wit_from_json(d: dict) -> RelaxedWitness:
    return RelaxedWitness(_ints(d["w"]), _ints(d["e"]))


def _packed_wit_from_json(d: dict, p: int) -> RelaxedWitness:
    return RelaxedWitness(PackedVec.pack(_ints(d["w"]), p),
                          PackedVec.pack(_ints(d["e"]), p))


def cycle_snark_to_json(snark) -> dict:
    """A live :class:`..proof.nova_cycle.CycleSNARK` accumulator as JSON
    (the chain server's session dumps: the reference serializes the
    running RecursiveSNARK itself, chain-server/src/server.rs:427-440
    StreamSessionData). The JAX package's fields, in its order; the
    folded ``Az1|Bz1|Cz1`` is left out, and recomputed by the first
    step after a resume."""
    pending = None
    if snark.pending is not None:
        u, wvec = snark.pending
        pending = {**_inst_to_json(u), "w": _hexes(wvec)}
    return {"z0": _hexes(snark.z0), "zi": _hexes(snark.zi), "i": snark.i,
            "h": _hex(snark.h), "g": _hex(snark.g),
            "u1": _relaxed_to_json(snark.U1),
            "w1": _relaxed_wit_to_json(snark.W1),
            "u2": _relaxed_to_json(snark.U2),
            "w2": _relaxed_wit_to_json(snark.W2),
            "pending": pending}


def cycle_snark_from_json(d: dict, pp):
    """The accumulator of :func:`cycle_snark_to_json` over ``pp``."""
    from ..proof.nova_cycle import CycleSNARK
    p1, p2 = pp.field1.modulus, pp.field2.modulus
    snark = CycleSNARK(pp, _ints(d["z0"]))
    snark.zi = _ints(d["zi"])
    snark.i = d["i"]
    snark.h = int(d["h"], 16)
    snark.g = int(d["g"], 16)
    snark.U1 = _relaxed_from_json(d["u1"])
    snark.W1 = _packed_wit_from_json(d["w1"], p1)
    snark.U2 = _relaxed_from_json(d["u2"])
    snark.W2 = _packed_wit_from_json(d["w2"], p2)
    pend = d["pending"]
    if pend is not None:
        snark.pending = (_inst_from_json(pend),
                         PackedVec.pack(_ints(pend["w"]), p2))
    return snark


def _cycle_head(p) -> dict:
    """The fields that open every cycle proof, plain or compressed."""
    return {"n": p.n, "z0": _hexes(p.z0), "zn": _hexes(p.zn)}


def _cycle_tail(p) -> dict:
    """The secondary's pending instance and the final fold's cross-term
    of a cycle proof."""
    return {"u2_pending": _inst_to_json(p.u2_pending),
            "comm_t_last": _pt(p.comm_t_last)}


def cycle_proof_to_json(proof) -> dict:
    """prover_cycle CycleProof (O(1) augmented-circuit IVC) -> json."""
    return {**_cycle_head(proof),
            "u1": _relaxed_to_json(proof.u1),
            "w1": _relaxed_wit_to_json(proof.w1),
            "u2": _relaxed_to_json(proof.u2),
            **_cycle_tail(proof),
            "w2_folded": _relaxed_wit_to_json(proof.w2_folded)}


def cycle_proof_from_json(d: dict):
    from ..proof.nova_cycle import CycleProof
    return CycleProof(
        d["n"], _ints(d["z0"]), _ints(d["zn"]),
        _relaxed_from_json(d["u1"]), _relaxed_wit_from_json(d["w1"]),
        _relaxed_from_json(d["u2"]), _inst_from_json(d["u2_pending"]),
        _un_pt(d["comm_t_last"]), _relaxed_wit_from_json(d["w2_folded"]))


def compressed_cycle_to_json(cp) -> dict:
    return {**_cycle_head(cp),
            "u1": _relaxed_to_json(cp.u1),
            "u2": _relaxed_to_json(cp.u2),
            **_cycle_tail(cp),
            "spartan1": _spartan_to_json(cp.spartan1),
            "spartan2": _spartan_to_json(cp.spartan2)}


def compressed_cycle_from_json(d: dict):
    from ..proof.prover_cycle import CompressedCycleProof
    return CompressedCycleProof(
        d["n"], _ints(d["z0"]), _ints(d["zn"]),
        _relaxed_from_json(d["u1"]), _relaxed_from_json(d["u2"]),
        _inst_from_json(d["u2_pending"]), _un_pt(d["comm_t_last"]),
        _spartan_from_json(d["spartan1"]), _spartan_from_json(d["spartan2"]))


def sn_cycle_proof_to_json(proof) -> dict:
    return {**_cycle_head(proof),
            "pc_n": proof.pc_n,
            "u1s": [_relaxed_to_json(u) for u in proof.u1s],
            "w1s": [_relaxed_wit_to_json(w) for w in proof.w1s],
            "u2": _relaxed_to_json(proof.u2),
            **_cycle_tail(proof),
            "w2_folded": _relaxed_wit_to_json(proof.w2_folded)}


def sn_cycle_proof_from_json(d: dict):
    from ..proof.supernova_cycle import SnCycleProof
    return SnCycleProof(
        d["n"], _ints(d["z0"]), _ints(d["zn"]), d["pc_n"],
        [_relaxed_from_json(u) for u in d["u1s"]],
        [_relaxed_wit_from_json(w) for w in d["w1s"]],
        _relaxed_from_json(d["u2"]), _inst_from_json(d["u2_pending"]),
        _un_pt(d["comm_t_last"]), _relaxed_wit_from_json(d["w2_folded"]))


def compressed_sn_cycle_to_json(cp) -> dict:
    return {**_cycle_head(cp),
            "pc_n": cp.pc_n,
            "u1s": [_relaxed_to_json(u) for u in cp.u1s],
            "u2": _relaxed_to_json(cp.u2),
            **_cycle_tail(cp),
            "spartans1": [_spartan_to_json(sp) for sp in cp.spartans1],
            "spartan2": _spartan_to_json(cp.spartan2)}


def compressed_sn_cycle_from_json(d: dict):
    from ..proof.prover_supernova_cycle import CompressedSnCycleProof
    return CompressedSnCycleProof(
        d["n"], _ints(d["z0"]), _ints(d["zn"]), d["pc_n"],
        [_relaxed_from_json(u) for u in d["u1s"]],
        _relaxed_from_json(d["u2"]), _inst_from_json(d["u2_pending"]),
        _un_pt(d["comm_t_last"]),
        [_spartan_from_json(sp) for sp in d["spartans1"]],
        _spartan_from_json(d["spartan2"]))


# (backend family, kind) -> (writer, reader); the family of "supernova"
# and "supernova-fold" is NIVC, of "nova-fold" the Nova IVC
_CODECS = {
    ("supernova-cycle", "compressed"): (compressed_sn_cycle_to_json,
                                        compressed_sn_cycle_from_json),
    ("supernova-cycle", "recursive"): (sn_cycle_proof_to_json,
                                       sn_cycle_proof_from_json),
    ("nova", "compressed"): (compressed_cycle_to_json,
                             compressed_cycle_from_json),
    ("nova", "recursive"): (cycle_proof_to_json, cycle_proof_from_json),
    ("nivc", "compressed"): (compressed_nivc_to_json,
                             compressed_nivc_from_json),
    ("nivc", "recursive"): (nivc_proof_to_json, nivc_proof_from_json),
    ("ivc", "compressed"): (compressed_proof_to_json,
                            compressed_proof_from_json),
    ("ivc", "recursive"): (proof_to_json, proof_from_json),
}


def _codec(backend: str, kind: str):
    if backend in ("supernova-cycle", "nova"):
        family = backend
    else:
        family = "nivc" if backend.startswith("supernova") else "ivc"
    return _CODECS[(family, kind)]


@dataclasses.dataclass
class LurkProof:
    """Persisted proof + public IO + rc (lurk_proof.rs parity).

    `kind` is "recursive" (uncompressed fold chain + final witness) or
    "compressed" (fold chain + Spartan/IPA proof — the reference always
    persists the compressed form, nova.rs:331-373)."""

    proof: object
    rc: int
    field: str
    backend: str = "supernova"
    kind: str = "recursive"

    def to_json(self) -> str:
        to_json, _ = _codec(self.backend, self.kind)
        return json.dumps({
            "backend": self.backend,
            "field": self.field,
            "rc": self.rc,
            "kind": self.kind,
            "proof": to_json(self.proof),
        })

    def persist(self, proof_key: str) -> Path:
        path = proofs_dir() / f"{proof_key}.proof.json"
        path.write_text(self.to_json())
        return path

    @staticmethod
    def load(proof_key: str) -> Optional["LurkProof"]:
        path = proofs_dir() / f"{proof_key}.proof.json"
        if not path.exists():
            return None
        d = json.loads(path.read_text())
        kind = d.get("kind", "recursive")
        _, from_json = _codec(d["backend"], kind)
        return LurkProof(from_json(d["proof"]), d["rc"], d["field"],
                         d["backend"], kind)

    @staticmethod
    def is_cached(proof_key: str) -> bool:
        return (proofs_dir() / f"{proof_key}.proof.json").exists()


def _z_to_json(z: ZPtr) -> dict:
    return {"tag": z.tag, "digest": _hex(z.digest)}


def _z_from_json(d: dict) -> ZPtr:
    return ZPtr(d["tag"], int(d["digest"], 16))


@dataclasses.dataclass
class LurkProofMeta:
    """Iterations + IO ZPtrs + ZDag (lurk_proof.rs LurkProofMeta)."""

    iterations: int
    expr_io: Tuple[ZPtr, ZPtr]
    env_io: Tuple[ZPtr, ZPtr]
    cont_io: Tuple[ZPtr, ZPtr]
    z_dag: ZDag

    def persist(self, proof_key: str) -> Path:
        path = proofs_dir() / f"{proof_key}.meta.json"
        path.write_text(json.dumps({
            "iterations": self.iterations,
            "expr_io": [_z_to_json(z) for z in self.expr_io],
            "env_io": [_z_to_json(z) for z in self.env_io],
            "cont_io": [_z_to_json(z) for z in self.cont_io],
            "z_dag": self.z_dag.to_json(),
        }))
        return path

    @staticmethod
    def load(proof_key: str) -> Optional["LurkProofMeta"]:
        path = proofs_dir() / f"{proof_key}.meta.json"
        if not path.exists():
            return None
        d = json.loads(path.read_text())

        def io(name):
            return tuple(_z_from_json(z) for z in d[name])

        return LurkProofMeta(d["iterations"], io("expr_io"), io("env_io"),
                             io("cont_io"), ZDag.from_json(d["z_dag"]))


@dataclasses.dataclass
class Commitment:
    """Persisted commitment opening (cli/commitment.rs parity)."""

    digest: int
    secret: int
    payload_z: ZPtr
    z_dag: ZDag

    @staticmethod
    def new(secret: int, payload, store: Store) -> "Commitment":
        z_dag = ZDag()
        zpay = z_dag.populate_with(payload, store)
        digest, _ = store.hide_and_return_z_payload(secret, payload)
        return Commitment(digest, secret, zpay, z_dag)

    def persist(self) -> Path:
        path = commits_dir() / f"{self.digest:064x}.json"
        path.write_text(json.dumps({
            "digest": _hex(self.digest),
            "secret": _hex(self.secret),
            "payload": _z_to_json(self.payload_z),
            "z_dag": self.z_dag.to_json(),
        }))
        return path

    @staticmethod
    def load(digest: int, store: Store) -> bool:
        """Load a persisted commitment into the store; True on success."""
        path = commits_dir() / f"{digest:064x}.json"
        if not path.exists():
            return False
        d = json.loads(path.read_text())
        z_dag = ZDag.from_json(d["z_dag"])
        payload = z_dag.populate_store(_z_from_json(d["payload"]), store)
        store.add_comm(int(d["digest"], 16), int(d["secret"], 16), payload)
        return True
