"""The program's outputs as plain data for the reference: Python ints,
tuples and NumPy arrays, nothing of the program's types. The reference
reads them only to judge them. What the program derived (its folds, its
verifier's instances) is not handed over: the reference works it out
again."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _ptr(p):
    return int(p.tag), (int(p.kind), int(p.idx))


def _point(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def store_nodes(store) -> dict:
    from lurk_tpu_torch.store import core
    nodes = {}
    for idx, v in enumerate(store.atoms):
        nodes[(core.ATOM, idx)] = ("atom", int(v))
    for kind, table in ((core.TUPLE2, store.tuple2),
                        (core.TUPLE3, store.tuple3),
                        (core.TUPLE4, store.tuple4)):
        for idx, children in enumerate(table):
            nodes[(kind, idx)] = ("tuple", [_ptr(c) for c in children])
    # a compact node shares the triple table
    for kind, idx in store.z_cache:
        if kind == core.COMPACT:
            nodes[(kind, idx)] = (
                "compact", [_ptr(c) for c in store.tuple3[idx]])
    return nodes


def _instance(u):
    return (_point(u.comm_w), _point(u.comm_e), [int(v) for v in u.x],
            int(u.u))


def _shape(shape) -> dict:
    return {"csr": [(np.asarray(i), np.asarray(c), np.asarray(k))
                    for i, c, k in shape.csr()],
            "num_inputs": shape.num_inputs, "num_aux": shape.num_aux,
            "num_constraints": shape.num_constraints, "p": shape.p,
            "digest": shape.digest}


def run_data(pp) -> dict:
    """The public parameters that the reference reads: each circuit's
    matrices, sizes and digest."""
    return {"shapes1": [_shape(s) for s in pp.shapes1],
            "shape2": _shape(pp.shape2)}


def _carried(obj) -> dict:
    return {"n": int(obj.n), "z0": [int(v) for v in obj.z0],
            "zn": [int(v) for v in obj.zn], "pc_n": int(obj.pc_n),
            "u1s": [_instance(u) for u in obj.u1s],
            "u2": _instance(obj.u2),
            "u2_pending": (_point(obj.u2_pending.comm_w),
                           [int(v) for v in obj.u2_pending.x]),
            "comm_t_last": _point(obj.comm_t_last)}


def _limbs(pv) -> np.ndarray:
    return pv.arr[:4 * pv.n].copy()


def _ipa(proof) -> Optional[dict]:
    if proof is None:
        return None
    return {"ls": [_point(v) for v in proof.ls],
            "rs": [_point(v) for v in proof.rs],
            "a_final": int(proof.a_final)}


def _spartan(sp) -> dict:
    out = {"sc1": [[int(v) for v in ev] for ev in sp.sc1_polys],
           "claims": [int(v) for v in sp.claims],
           "sc2": [[int(v) for v in ev] for ev in sp.sc2_polys],
           "w_eval": int(sp.w_eval), "ipa_w": _ipa(sp.ipa_w),
           "ipa_e": _ipa(sp.ipa_e), "hkzg": None}
    joint = sp.hkzg_joint
    if joint is not None:
        out["hkzg"] = {
            "comms": [[_point(c) for c in cms] for cms in joint.comms],
            "evals": [[tuple(int(v) for v in ev) for ev in evs]
                      for evs in joint.evals],
            "w": _point(joint.w), "wp": _point(joint.wp)}
    return out


def job_data(job, run_key=None) -> dict:
    """One job's outputs; ``run_key`` names its public parameters'
    ``run_data``."""
    frames = job.frames
    out = {"inputs": list(job.inputs), "frames": len(frames),
           "first_input": [_ptr(p) for p in frames[0].input],
           "last_output": [_ptr(p) for p in frames[-1].output],
           "nodes": store_nodes(job.store),
           "z_cache": {(int(k), int(i)): int(d)
                       for (k, i), d in job.store.z_cache.items()},
           "verified": job.verified, "run": run_key}
    proof = job.proof
    if proof is None:
        return out
    out["proof"] = {
        "n": int(proof.n), "z0": [int(v) for v in proof.z0],
        "zn": [int(v) for v in proof.zn],
        "u1s": [_instance(u) for u in proof.u1s],
        "w1s": [(_limbs(w.w), _limbs(w.e)) for w in proof.w1s],
        "w2": _limbs(proof.w2_folded.w), "e2": _limbs(proof.w2_folded.e),
        "carried": _carried(proof)}
    comp = job.compressed
    if comp is not None:
        out["compressed"] = {
            "carried": _carried(comp),
            "spartans1": [_spartan(s) for s in comp.spartans1],
            "spartan2": _spartan(comp.spartan2)}
    return out
