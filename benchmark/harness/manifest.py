"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix and metric readers are found by name, so a later cell,
configuration, mix or metric is a new file and a new entry, with no
edit here.

- ``benchmark/configs/<config>.json``: the configuration.
- ``benchmark/traffic/<traffic>.json``: the traffic mix.
- ``benchmark/metrics/<metric name>.py``: a reader with ``read(ctx)``,
  returning a number or None (nothing to read: the metric is left out).
  Where there is no such file, the name before its first dot names the
  reader: ``device_idle_pct.prove`` and ``device_idle_pct.compressed``
  share ``metrics/device_idle_pct.py``, which reads ``ctx.cell``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


class Manifest:
    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                cfg = json.loads((self.root / entry["file"]).read_text())
                cfg["name"] = name
                return cfg
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = self.dir / "traffic" / f"{name}.json"
        if not path.exists():
            raise KeyError(f"no traffic mix file {path}")
        mix = json.loads(path.read_text())
        mix["name"] = name
        return mix

    def metrics_of(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        ones (true): those without ``workloads`` and those that list it."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> ModuleType:
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{metric.split('.')[0]}.py"
        return load_module(path, f"bench_metric_{path.stem}")


_MODULES: Dict[str, ModuleType] = {}


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file whose name need not be an identifier (a metric's
    name may hold dots)."""
    key = str(path)
    mod = _MODULES.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            name.replace(".", "_").replace("-", "_"), path)
        if spec is None or spec.loader is None:
            raise KeyError(f"no metric reader {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return mod


def read_metric(man: Manifest, metric: dict, ctx) -> Optional[float]:
    value = man.reader(metric["name"]).read(ctx)
    return None if value is None else float(value)
