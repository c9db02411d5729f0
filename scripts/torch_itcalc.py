"""Iteration-count planning table (the reference's examples/itcalc.rs;
the port of the JAX package's ``examples/itcalc.py``).

For a program modelled as ``setup + loop * n`` iterations, print the
total proved iterations (padded to a multiple of rc) for each (n, rc):
the table to pick rc for a workload by. Host only: no device work.

Usage: ``python3 scripts/torch_itcalc.py [setup] [loop]`` (defaults 7 7,
fib's frame model).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

NS = [10, 20, 40, 60, 80, 100, 120, 200, 400, 600, 800, 1000]
RCS = [100, 200, 300, 400, 500, 600, 700, 800, 900]


@dataclass(frozen=True)
class Prog:
    setup_iterations: int
    loop_iterations: int


def real_iterations(prog: Prog, n: int) -> int:
    return prog.setup_iterations + prog.loop_iterations * n


def ceiling(n: int, m: int) -> int:
    return n // m + (1 if n % m else 0)


def total_iterations(real: int, rc: int):
    """``real`` padded to a multiple of ``rc``; None where rc is larger
    than the workload."""
    if real < rc:
        return None
    return ceiling(real, rc) * rc


def analyze(prog: Prog, ns, rcs):
    """A row a value of n: ``[n, "", total or "-" for each rc]``."""
    rows = []
    for n in ns:
        row = [n, ""]
        for rc in rcs:
            t = total_iterations(real_iterations(prog, n), rc)
            row.append("-" if t is None else t)
        rows.append(row)
    return rows


def table(prog: Prog, ns=NS, rcs=RCS) -> str:
    """The table as the JAX script prints it, right-aligned columns."""
    header = ["n", ""] + [f"rc={rc}" for rc in rcs]
    rows = analyze(prog, ns, rcs)
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    return "\n".join("  ".join(str(v).rjust(w) for v, w in zip(r, widths))
                     for r in [header] + rows)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    setup = int(argv[0]) if len(argv) > 0 else 7
    loop = int(argv[1]) if len(argv) > 1 else 7
    print(table(Prog(setup, loop)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
