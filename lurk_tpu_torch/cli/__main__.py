"""Lurk command-line interface of the port.

The JAX package's ``python -m lurk_tpu.cli`` with the same subcommands
and flags, plus ``--device {cuda,cpu}``: the device every command runs
on, ``cuda`` by default, which fails without a card. It is the only way
to the CPU.

Parity: reference src/cli/mod.rs:42-99, 590-683 — subcommands `repl`,
`load [--prove]`, `verify <proof-key>`, `inspect <proof-key>`,
`public-params`, with `--rc`, `--limit`, `--field` flags (defaults
mirror the reference: rc=10, limit=10^8). The JAX package's `circom`
subcommand waits for the port of the circom coprocessor (ROADMAP.md,
section 1, item 2).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..device import resolve_device
from ..fields import FIELDS


def make_repl(args):
    from .repl import Repl
    return Repl(FIELDS[args.field], rc=args.rc, limit=args.limit,
                backend=args.backend, compress=args.compress,
                device=args.device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="lurk_tpu_torch", description="Lurk on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--rc", type=int, default=10,
                       help="reduction count (frames per fold step)")
        p.add_argument("--limit", type=int, default=100_000_000,
                       help="max evaluation iterations")
        p.add_argument("--field", default="bn256", choices=list(FIELDS),
                       help="Lurk field")
        p.add_argument("--backend", default="supernova-cycle",
                       choices=["nova", "supernova", "supernova-cycle",
                                "nova-fold", "supernova-fold"],
                       help="folding backend (reference parity: "
                            "supernova-cycle = succinct NIVC with the "
                            "in-circuit fold verifier [default, "
                            "cli/mod.rs backend default=SuperNova], "
                            "nova = O(1) augmented-circuit IVC; "
                            "supernova / *-fold = debug fold chains "
                            "with a recomputing verifier)")
        p.add_argument("--compress", dest="compress",
                       action="store_true", default=True,
                       help="Spartan/IPA-compress proofs before "
                            "persisting (default, reference parity: "
                            "repl/mod.rs:303-401 always compresses)")
        p.add_argument("--no-compress", dest="compress",
                       action="store_false",
                       help="persist the uncompressed recursive proof "
                            "(debug)")
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the store hashes and the provers "
                            "commit (default cuda; fails without a card)")

    p_repl = sub.add_parser("repl", help="interactive REPL")
    common(p_repl)
    p_repl.add_argument("--load", type=Path, default=None,
                        help="lurk file to load before the loop")

    p_load = sub.add_parser("load", help="load a lurk file")
    common(p_load)
    p_load.add_argument("file", type=Path)
    p_load.add_argument("--prove", action="store_true",
                        help="prove the last evaluation")

    p_verify = sub.add_parser("verify", help="verify a cached proof")
    common(p_verify)
    p_verify.add_argument("proof_key")

    p_inspect = sub.add_parser("inspect", help="inspect a cached proof")
    common(p_inspect)
    p_inspect.add_argument("proof_key")

    p_pp = sub.add_parser("public-params",
                          help="manage the public parameter cache "
                               "(cli/mod.rs:590-683 list/clean/"
                               "remove/show)")
    p_pp.add_argument("action", choices=["list", "clean", "remove",
                                         "show"])
    p_pp.add_argument("key", nargs="?", default=None,
                      help="cache entry name (for remove/show)")

    args = parser.parse_args(argv)

    if args.command == "public-params":
        return public_params(args.action, args.key)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e} (on the command line: --device cpu)",
              file=sys.stderr)
        return 1
    if args.command == "repl":
        repl = make_repl(args)
        if args.load is not None:
            repl.load_file(args.load)
        repl.start()
        return 0
    if args.command == "load":
        repl = make_repl(args)
        repl.load_file(args.file)
        if args.prove:
            repl.prove_last_frames()
        return 0
    if args.command == "verify":
        # the persisted proof records its own field (the proof key also
        # embeds it, cli/lurk_proof.rs parity) — never trust the flag
        from .lurk_proof import LurkProof
        lp = LurkProof.load(args.proof_key)
        if lp is not None:
            args.field = lp.field
        repl = make_repl(args)
        return 0 if repl.verify_proof_key(args.proof_key) else 1
    if args.command == "inspect":
        from .repl import ReplError
        repl = make_repl(args)
        try:
            repl._meta_inspect(
                repl.store.list([repl.store.intern_string(
                    args.proof_key)]))
        except ReplError as e:
            print(f"Error: {e}")
            return 1
        return 0
    return 2


def public_params(action: str, key) -> int:
    """list / clean / remove / show on the port's parameter cache,
    ``$LURK_TPU_CACHE/torch_public_params``."""
    from ..proof.params_cache import cache_dir
    d = cache_dir()
    if action == "list":
        for f in sorted(d.iterdir()):
            print(f.name)
    elif action == "clean":
        for f in d.iterdir():
            f.unlink()
        print("public params cache cleaned")
    else:
        if not key:
            print(f"Error: `public-params {action}` needs a cache entry "
                  "name")
            return 1
        path = d / key
        if not path.exists():
            print(f"Error: no cache entry named {key}")
            return 1
        if action == "remove":
            path.unlink()
            print(f"removed {key}")
        else:
            print(f"{key}: {path.stat().st_size} bytes")
            import numpy as np
            try:
                with np.load(path, allow_pickle=False) as z:
                    for name in z.files:
                        arr = z[name]
                        print(f"  {name}: {arr.dtype}{arr.shape}")
            except Exception:
                pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
