"""Top-level Nova prover: evaluate -> MultiFrames -> fold chain.

A copy of the JAX package's ``proof/prover.py``. Parity: reference
src/proof/mod.rs:131-245 (Prover::prove / evaluate_and_prove /
prove_from_frames) + nova.rs prove loop. The reference pipelines witness
generation against folding via a bounded channel (nova.rs:297-332);
here step witness synthesis happens inline.

The prover commits on ``device`` (default ``cuda``: the MSM kernel) and
records each step's witness synthesis (``nova.witness``) and its first
step's shape build (``nova.shape``, ``nova.shape_save``) in
:mod:`..utils.metrics`, beside :class:`.nova.RecursiveSNARK`'s phases.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..lem import evaluation as ev
from ..lem import ir
from ..lem.eval_step import eval_step, make_eval_step
from ..lem.interpreter import Frame
from ..store.core import Ptr, Store
from ..utils import metrics
from ..utils.tracing import instrument
from .multiframe import MultiFrame, io_chain_checker, io_scalars
from .nova import (
    FoldingProof, PublicParams, R1CSShape, RecursiveSNARK, verify,
)
from .params_cache import load_shape, save_shape, shape_cache_key

_PP_CACHE: Dict[Tuple[str, int, torch.device], PublicParams] = {}


def public_params(shape: R1CSShape, device=None) -> PublicParams:
    dev = resolve_device(device)
    key = (shape.digest, shape.num_aux, dev)
    pp = _PP_CACHE.get(key)
    if pp is None:
        pp = PublicParams.setup(shape, device=dev)
        _PP_CACHE[key] = pp
    return pp


@dataclasses.dataclass
class NovaProver:
    """IVC prover over the universal Lurk step circuit."""

    rc: int = 10
    lang: Optional[ev.Lang] = None
    check_steps: bool = False   # debug: verify each step witness
    device: Optional[str] = None

    def step_func(self) -> ir.Func:
        if self.lang is not None and len(self.lang):
            return make_eval_step(tuple(self.lang.cproc_specs()), True)
        return eval_step()

    # -- proving ------------------------------------------------------------

    def evaluate_and_prove(self, store: Store, expr: Ptr, limit: int = 10000
                           ) -> Tuple[PublicParams, FoldingProof,
                                      List[Frame]]:
        lang_setup = None
        if self.lang is not None and len(self.lang):
            lang_setup = ev.LangSetup.ivc(self.lang)
        frames = ev.evaluate(lang_setup, expr, store, limit)
        pp, proof = self.prove_from_frames(store, frames)
        return pp, proof, frames

    @instrument("nova_fold.prove_from_frames")
    def prove_from_frames(self, store: Store, frames: List[Frame]
                          ) -> Tuple[PublicParams, FoldingProof]:
        if not frames:
            raise ValueError("no frames to prove")
        store.hydrate_z_cache()
        step = self.step_func()
        mframes = MultiFrame.from_frames(frames, self.rc, step, store,
                                         self.lang)
        synths = (self.lang.circuit_synthesizers()
                  if self.lang is not None else None)
        # shape from the first step (uniform across steps; pinned by
        # tests), via the disk cache when possible so repeat proves run
        # witness-only everywhere (public_parameters/ DiskCache parity)
        shape = None
        skey = None
        if not self.check_steps and not synths:
            skey = shape_cache_key(store.field.name, self.rc, step)
            shape = load_shape(skey, store.field)
        first = [mframes[0]] if shape is not None else []
        if shape is None:
            with metrics.timed("nova.shape"):
                x0, w0, cs0 = mframes[0].instance(
                    step, store, shape_check=self.check_steps,
                    cproc_synthesizers=synths)
                shape = R1CSShape(cs0)
            if skey is not None:
                with metrics.timed("nova.shape_save"):
                    save_shape(skey, shape)
        else:
            x0 = w0 = None
        pp = public_params(shape, self.device)
        rs = RecursiveSNARK(pp)
        rs.z0 = io_scalars(store, mframes[0].frames[0].input)
        if x0 is not None:
            rs.prove_step(x0, w0, check=self.check_steps)
        for x, w in self._witnesses(first + mframes[1:], step, store,
                                    synths):
            rs.prove_step(x, w, check=self.check_steps)
        rs.zi = io_scalars(store, mframes[-1].frames[-1].output)
        return pp, rs.finish()

    def _witnesses(self, mframes, step, store, synths):
        """Per-step witness synthesis, inline: witness-only unless
        ``check_steps`` asks for full synthesis. The JAX package's fork
        pool (``check_steps`` runs only) is not ported: its workers
        synthesize witness-only anyway, which its own docstring calls
        pure IPC overhead beside the inline loop."""
        for mf in mframes:
            with metrics.timed("nova.witness"):
                x, w, _ = mf.instance(step, store,
                                      shape_check=self.check_steps,
                                      cproc_synthesizers=synths,
                                      witness_only=not self.check_steps)
            yield x, w

    # -- verification --------------------------------------------------------

    @staticmethod
    def verify(pp: PublicParams, proof: FoldingProof) -> bool:
        return verify(pp, proof, io_chain_checker(proof.z0, proof.zi))

