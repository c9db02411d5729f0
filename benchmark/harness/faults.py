"""Faults planted under the timed path, and the control: each breaks one
thing the configuration guarantees, so the reference must find it.
Used by ``benchmark/control.py`` and the tests; never by a run of
``benchmark/run.py``.

- ``control``: the frames of every folding step but the last are
  proved: one step fewer. The proof has its shapes and keys and the
  program's verifier accepts it; it is not the proof of the evaluation.
- ``step_unchanged``: the second folding step returns with the prover's
  state unchanged.
- ``half_batch``: the first half of the frames is proved.
- ``commit_altered``: the first commitment of 64 scalars or more comes
  back moved by the curve's generator (BN254's W1 of the first step).
- ``grumpkin_commit_altered``: the first commitment on the Grumpkin key
  comes back moved by its generator.
- ``digest_altered``: the first hashing wave's first digest comes back
  plus one.

Faults of the compression (a job without it is left as it was):

- ``sumcheck_altered``: the first Spartan proof's last round of its
  second sumcheck comes back with its first evaluation plus one.
- ``kzg_altered``: the first HyperKZG opening's last point comes back
  moved by the generator.
- ``ipa_altered``: the first IPA's last left point comes back moved by
  the generator.
- ``transcript_dropped``: every Spartan transcript, the prover's and
  the verifier's alike, leaves out the circuit's digest, so the port's
  own verifier still accepts.
"""

from __future__ import annotations

import contextlib

FAULTS = ("control", "step_unchanged", "half_batch", "commit_altered",
          "grumpkin_commit_altered", "digest_altered")
COMPRESSION_FAULTS = ("sumcheck_altered", "kzg_altered", "ipa_altered",
                      "transcript_dropped")


@contextlib.contextmanager
def planted(name: str):
    from lurk_tpu_torch.proof import hyperkzg, ipa, nova, spartan
    from lurk_tpu_torch.proof import prover_supernova_cycle as psc
    from lurk_tpu_torch.proof import supernova_cycle as snc
    from lurk_tpu_torch.store import core
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    prove = psc.SuperNovaCycleProver.prove_from_frames
    if name == "control":
        from lurk_tpu_torch.proof.supernova import chunk_frames_nivc

        def all_but_the_last_step(self, store, frames):
            last = chunk_frames_nivc(list(frames), self.rc)[-1]
            return prove(self, store, frames[:len(frames) - len(last)])
        patch(psc.SuperNovaCycleProver, "prove_from_frames",
              all_but_the_last_step)
    elif name == "half_batch":
        patch(psc.SuperNovaCycleProver, "prove_from_frames",
              lambda self, store, frames: prove(
                  self, store, frames[:max(1, len(frames) // 2)]))
    elif name == "step_unchanged":
        step = snc.SnCycleSNARK.prove_step

        def prove_step(self, *args, **kwargs):
            if getattr(self, "_bench_calls", 0) == 1:
                self._bench_calls = 2
                return None
            self._bench_calls = getattr(self, "_bench_calls", 0) + 1
            return step(self, *args, **kwargs)
        patch(snc.SnCycleSNARK, "prove_step", prove_step)
    elif name == "commit_altered":
        commit_async = nova.CommitmentKey.commit_async
        state = {"done": False}

        def altered(self, vec):
            resolve = commit_async(self, vec)
            if state["done"] or len(vec) < 64:
                return resolve
            state["done"] = True
            return lambda: self.curve.add(resolve(), self.curve.generator)
        patch(nova.CommitmentKey, "commit_async", altered)
    elif name == "grumpkin_commit_altered":
        commit_async = nova.CommitmentKey.commit_async
        state = {"done": False}

        def altered(self, vec):
            resolve = commit_async(self, vec)
            if state["done"] or self.curve.name != "grumpkin":
                return resolve
            state["done"] = True
            return lambda: self.curve.add(resolve(), self.curve.generator)
        patch(nova.CommitmentKey, "commit_async", altered)
    elif name in ("sumcheck_altered", "kzg_altered", "ipa_altered"):
        module, attr = {"sumcheck_altered": (spartan, "prove"),
                        "kzg_altered": (hyperkzg, "prove_batch"),
                        "ipa_altered": (ipa, "prove")}[name]
        made = getattr(module, attr)
        state = {"done": False}

        def altered(*args, **kwargs):
            out = made(*args, **kwargs)
            if state["done"]:
                return out
            state["done"] = True
            if name == "sumcheck_altered":
                last = out.sc2_polys[-1]
                last[0] = (last[0] + 1) % args[0].shape.p
            elif name == "kzg_altered":
                out.wp = hyperkzg.CURVE.add(out.wp,
                                            hyperkzg.CURVE.generator)
            else:
                curve = args[0]
                out.ls[-1] = curve.add(out.ls[-1], curve.generator)
            return out
        patch(module, attr, altered)
    elif name == "transcript_dropped":
        from lurk_tpu_torch.proof.transcript import Transcript

        def without_digest(pp, inst):
            tr = Transcript(pp.curve, b"lurk_tpu.spartan")
            nova._absorb_relaxed(tr, inst)
            return tr
        patch(spartan, "_transcript", without_digest)
    elif name == "digest_altered":
        hash_wave = core.Store._hash_wave
        state = {"done": False}

        def altered(self, arity, pres):
            out = list(hash_wave(self, arity, pres))
            if not state["done"] and out:
                state["done"] = True
                out[0] = (out[0] + 1) % self.field.modulus
            return out
        patch(core.Store, "_hash_wave", altered)
    else:
        raise ValueError(f"unknown fault {name!r}; one of "
                         f"{FAULTS + COMPRESSION_FAULTS}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
