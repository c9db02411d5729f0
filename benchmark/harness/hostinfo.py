"""What the host and the card looked like around a run, for reading
spreads: printed on lines before the result, read by nothing."""

from __future__ import annotations

import os
import subprocess

QUERY = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"


def line(when: str) -> str:
    load = os.getloadavg()
    return (f"host {when}: cpus {os.cpu_count()}, load "
            f"{load[0]:.2f} {load[1]:.2f} {load[2]:.2f}; card {nvidia_smi()}")
