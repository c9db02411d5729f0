"""The comparison that decides ``correct``: each job's outputs, as plain
data (``benchmark/harness/extract.py``), against what the reference
works out again. Every job of the window is judged in full. Every
number is a count of disagreements, and every limit is 0: the
arithmetic is exact.

- ``frames_off``: frames evaluated less the configuration's count.
- ``result_off``: numbers in the final state other than the program's
  definition gives (``reference.programs``), and ones missing.
- ``digest_off``: store digests that differ from Poseidon worked out
  again from the atoms up, and public-z entries (the first step's input,
  the last step's output) that differ from those digests.
- ``steps_off``: folding steps less the configuration's count.
- ``shape_off``: sizes of the circuits (constraints, witness, inputs of
  each primary circuit and the secondary) that differ from the
  configuration's.
- ``state_off``: the last secondary instance's second input against the
  state hashes worked out again over n, z0, zn, the next pc and every
  accumulator (the binding the verifier checks).
- ``commit_off``: the final accumulators' commitments (W and E of each
  primary circuit on BN254, [W(tau)] G by the key's public trapdoor;
  and of the secondary on Grumpkin, by an MSM on the hash-derived key)
  that differ from the witnesses'.
- ``relation_off``: rows of the final accumulators (each primary
  circuit, and the secondary with its last instance folded in here)
  that break relaxed R1CS, on the program's matrices.
- ``compressed_off``: entries of the compressed proof's carried
  instances that differ from the folded proof's, and of its Spartan
  proofs (sumcheck rounds, claims, openings) that a plain verifier on
  its own transcript, holding the witnesses, finds wrong
  (``reference.spartan``).
- ``failed_off``: jobs that raised, or whose proof the program's own
  verifier rejected (counted by the harness).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np

from . import pool, programs, r1cs, spartan
from .curve import BN254, GRUMPKIN
from .poseidon import hasher
from .store import digests, reachable_atoms
from .transcript import Transcript, absorb_relaxed

LIMITS = {"frames_off": 0, "result_off": 0, "digest_off": 0,
          "steps_off": 0, "shape_off": 0, "state_off": 0, "commit_off": 0,
          "relation_off": 0, "compressed_off": 0, "failed_off": 0}

KEY_LABEL = b"lurk_tpu.ck."
TAU = spartan.tau()


def vec(limbs) -> np.ndarray:
    return spartan.obj(r1cs.ints_from_limbs(limbs))


def prepare(run: dict) -> dict:
    """A run's public parameters, made ready once for all its jobs: the
    matrices' coefficients as integers, the parameters' digest, and the
    powers of the BN254 key's trapdoor."""
    def ready(s):
        s = dict(s, mats=r1cs.prepare(s["csr"]))
        del s["csr"]
        return s
    for modulus, arity in ((BN254.order, 4), (BN254.order, 6),
                           (BN254.order, 8), (BN254.p, 4)):
        hasher(modulus, arity)      # Poseidon's constants, once
    out = {"shapes1": [ready(s) for s in run["shapes1"]],
           "shape2": ready(run["shape2"]), "tau": TAU}
    h = hashlib.sha256((":".join(s["digest"] for s in run["shapes1"])
                        + "|" + run["shape2"]["digest"]).encode())
    out["pp_digest"] = int(h.hexdigest(), 16) & ((1 << 124) - 1)
    longest = max(max(s["num_aux"], s["num_constraints"])
                  for s in out["shapes1"])
    out["pows"] = {TAU: spartan.powers(TAU, longest, BN254.order)}
    return out


def fold_pending(c: dict, pp_digest: int):
    """The secondary accumulator with its last instance folded in."""
    u2, (pend_w, pend_x), comm_t = c["u2"], c["u2_pending"], \
        c["comm_t_last"]
    tr = Transcript(GRUMPKIN, b"nova.fold")
    tr.absorb(pp_digest)
    absorb_relaxed(tr, u2)
    tr.absorb_point(pend_w)
    for v in pend_x:
        tr.absorb_scalar(v)
    tr.absorb_point(comm_t)
    r = tr.squeeze()
    q = GRUMPKIN.order
    comm_w, comm_e, x, u = u2
    return (GRUMPKIN.add(comm_w, GRUMPKIN.mul(r, pend_w)),
            GRUMPKIN.add(comm_e, GRUMPKIN.mul(r, comm_t)),
            [(a + r * b) % q for a, b in zip(x, pend_x)], (u + r) % q)


def state_off(c: dict, pp_digest: int) -> int:
    tr = Transcript(GRUMPKIN, b"snova.state1")
    for v in [pp_digest, c["n"], *c["z0"], *c["zn"], c["pc_n"]]:
        tr.absorb(v)
    absorb_relaxed(tr, c["u2"])
    tr.absorb_scalar(c["u2_pending"][1][0])
    h_n = tr.squeeze()
    tr = Transcript(BN254, b"snova.state2")
    tr.absorb(pp_digest)
    tr.absorb(c["n"])
    for acc in c["u1s"]:
        absorb_relaxed(tr, acc)
    tr.absorb_scalar(h_n)
    return int(c["u2_pending"][1][1] != tr.squeeze())


def _dims(shape: dict) -> List[int]:
    return [shape["num_constraints"], shape["num_aux"], shape["num_inputs"]]


def check_job(job: dict, run: dict, expect: dict, p: int) -> Dict[str, int]:
    """Every number of one job; ``run`` from ``prepare``."""
    out = {"frames_off": abs(job["frames"] - expect["frames"])}
    nodes = job["nodes"]
    result = expect["result"]
    roots = job["last_output"] if result.get("from", "output") == "output" \
        else job["last_output"][:1]
    got = reachable_atoms(nodes, roots, programs.NUM_TAG)
    want = programs.expected_numbers(result, job["inputs"], p)
    out["result_off"] = len(got ^ want)

    ds = digests(nodes, p)
    out["digest_off"] = sum(1 for key, d in job["z_cache"].items()
                            if ds.get(key) != d)
    proof = job.get("proof")
    if proof is None:
        return out

    def z_of(ptrs):
        z = []
        for tag, key in ptrs:
            z += [tag, ds[key]]
        return z
    out["digest_off"] += sum(
        a != b for a, b in zip(proof["z0"], z_of(job["first_input"])))
    out["digest_off"] += sum(
        a != b for a, b in zip(proof["zn"], z_of(job["last_output"])))
    out["steps_off"] = abs(proof["n"] - expect["steps"])
    shapes1, shape2 = run["shapes1"], run["shape2"]
    want = expect["shapes"]
    out["shape_off"] = sum(
        a != b for got_s, want_s in zip(shapes1 + [shape2],
                                        want["primary"] + [want["secondary"]])
        for a, b in zip(_dims(got_s), want_s)) + \
        abs(len(shapes1) - len(want["primary"]))
    carried = proof["carried"]
    pp_digest = run["pp_digest"]
    out["state_off"] = state_off(carried, pp_digest)

    comp = job.get("compressed")
    claims = spartan.GrumpkinClaims()
    tau, pows = run["tau"], run["pows"]
    commit_off = relation_off = compressed_off = 0
    if comp is not None:
        compressed_off = sum(comp["carried"][k] != carried[k]
                             for k in carried)
        if len(comp["spartans1"]) != len(shapes1):
            compressed_off += 1
    for pc, (inst, (wl, el), shape) in enumerate(
            zip(proof["u1s"], proof["w1s"], shapes1)):
        w, e = vec(wl), vec(el)
        commit_off += (spartan.kzg_commit(w, pows[tau]) != inst[0]) + \
            (spartan.kzg_commit(e, pows[tau]) != inst[1])
        prods = r1cs.products(shape["mats"], inst[3], inst[2], w, p)
        relation_off += r1cs.rows_off(prods, inst[3], e, p)
        if comp is not None and pc < len(comp["spartans1"]):
            compressed_off += spartan.spartan_off(
                BN254, shape, inst, w, e, prods, comp["spartans1"][pc],
                tau, pows, claims)
        del prods
    u2f = fold_pending(carried, pp_digest)
    w2, e2 = vec(proof["w2"]), vec(proof["e2"])
    q = GRUMPKIN.order
    claims.add("commit_off", u2f[0], w2 % q)
    claims.add("commit_off", u2f[1], e2 % q)
    prods2 = r1cs.products(shape2["mats"], u2f[3], u2f[2], w2, q)
    relation_off += r1cs.rows_off(prods2, u2f[3], e2, q)
    if comp is not None:
        compressed_off += spartan.spartan_off(
            GRUMPKIN, shape2, u2f, w2, e2, prods2, comp["spartan2"], tau,
            pows, claims, run["u_gen"])
    del prods2
    found = claims.off(run["gens"])
    out["commit_off"] = commit_off + found.get("commit_off", 0)
    out["relation_off"] = relation_off
    if comp is not None:
        out["compressed_off"] = compressed_off + found.get("compressed_off",
                                                           0)
    return out


def check_each(jobs: List[dict], runs: Dict[int, dict], expect: dict,
               p: int, workers: int = 1) -> List[Dict[str, int]]:
    """Each job's numbers; each job's ``run`` key names its public
    parameters in ``runs``. Jobs run in up to ``workers`` processes,
    each making the parameters ready once."""
    keys = {}
    for k, r in runs.items():
        s2 = r["shape2"]
        n = spartan.next_pow2(max(s2["num_aux"], s2["num_constraints"], 2))
        keys[k] = (GRUMPKIN.generators(KEY_LABEL + b"grumpkin", n, workers),
                   GRUMPKIN.generators(spartan.IPA_U_LABEL, 1)[0])
    runs = {k: dict(r, shapes1=[dict(s, csr=r1cs.compact(s["csr"]))
                                for s in r["shapes1"]],
                    shape2=dict(r["shape2"],
                                csr=r1cs.compact(r["shape2"]["csr"])))
            for k, r in runs.items()}
    return pool.run(_check_one, jobs, workers, _init,
                    (runs, keys, expect, p))


_WORKER: dict = {}


def _init(runs, keys, expect, p) -> None:
    _WORKER.clear()
    _WORKER.update(runs=runs, keys=keys, expect=expect, p=p, ready={})


def _check_one(job: dict) -> Dict[str, int]:
    w = _WORKER
    key = job.get("run")
    if key is not None and key not in w["ready"]:
        run = w["ready"][key] = prepare(w["runs"][key])
        run["gens"], run["u_gen"] = w["keys"][key]
    return check_job(job, w["ready"].get(key), w["expect"], w["p"])


def check_jobs(jobs: List[dict], runs: Dict[int, dict], expect: dict,
               p: int, workers: int = 1) -> Dict[str, int]:
    """The sums over ``jobs`` (``failed_off`` is the harness's)."""
    total = {k: 0 for k in LIMITS if k != "failed_off"}
    for row in check_each(jobs, runs, expect, p, workers):
        for k, v in row.items():
            total[k] += v
    return total


def correct(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in numbers)
