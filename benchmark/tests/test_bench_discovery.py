"""A configuration, a traffic mix and a metric dropped into a copy of
the benchmark are found by name, with no edit to any file there."""

from __future__ import annotations

import json
import shutil

from benchmark.tests.conftest import REPO


def test_new_files_are_found(tmp_path):
    from benchmark.harness.manifest import Manifest, read_metric
    bench = tmp_path / "benchmark"
    shutil.copytree(REPO / "benchmark", bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    (bench / "configs/fib-rc10.json").write_text(json.dumps(
        dict(json.loads((bench / "configs/fib-rc100.json").read_text()),
             rc=10)))
    (bench / "traffic/prove-wide.json").write_text(json.dumps(
        {"stages": ["evaluate", "prove"], "input_bits": 128}))
    (bench / "metrics/jobs_done.py").write_text(
        "def read(ctx):\n    return len(ctx.jobs)\n")
    man["configs"].append(dict(man["configs"][0], name="fib-rc10",
                               file="benchmark/configs/fib-rc10.json"))
    man["workloads"].append({"name": "fib-rc10.prove-wide",
                             "config": "fib-rc10", "traffic": "prove-wide",
                             "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "jobs_done", "unit": "1",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "prove_s",
                             "workloads": ["fib-rc10.prove-wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    m = Manifest(tmp_path, bench)
    cell = m.cell("fib-rc10.prove-wide")
    assert m.config(cell["config"])["rc"] == 10
    assert m.traffic(cell["traffic"])["input_bits"] == 128
    names = [x["name"] for x in m.metrics_of("fib-rc10.prove-wide", True)]
    assert "jobs_done" in names and "params_load_s" in names

    class Ctx:
        jobs = [1, 2, 3]
    assert read_metric(m, {"name": "jobs_done"}, Ctx()) == 3.0
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_a_split_metric_shares_its_reader(tmp_path):
    from benchmark.harness.manifest import Manifest
    m = Manifest(REPO)
    for family in ("device_idle_pct", "msm_roofline"):
        names = [x["name"] for x in m.data["per_layer"]
                 if x["name"].split(".")[0] == family]
        assert len(names) == 2
        assert {m.reader(n).__file__ for n in names} == \
            {str(m.dir / "metrics" / f"{family}.py")}


def test_a_split_metric_shares_its_reader():
    from benchmark.harness.manifest import Manifest
    m = Manifest(REPO)
    for family in ("device_idle_pct", "msm_roofline"):
        names = [x["name"] for x in m.data["per_layer"]
                 if x["name"].split(".")[0] == family]
        assert len(names) == 2
        assert {m.reader(n).__file__ for n in names} == \
            {str(m.dir / "metrics" / f"{family}.py")}


def test_every_metric_has_a_reader():
    from benchmark.harness.manifest import Manifest
    m = Manifest(REPO)
    for metric in m.data["end_to_end"] + m.data["per_layer"]:
        assert callable(m.reader(metric["name"]).read), metric["name"]
