"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name; a new cell, traffic mix and metric added by files
alone."""
import hashlib
import json
import re

import pytest
import torch

from gpubench import harness
from gpubench.tests.tiny import REPO, tiny_root

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contracts_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "gpubench/run.py"]
    assert SPEC["paths"] == ["gpubench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/")
        assert (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
        assert len(c["source"]) <= 200 and all(NAME.match(k)
                                               for k in c["reduced"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(names)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "gpubench" / "traffic" /
                f"{w['traffic']}.json").is_file()
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    every = names + [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in every) and len(set(every)) == len(every)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in metrics:
        assert m["better"] in ("lower", "higher")
        assert (REPO / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
    for w in SPEC["workloads"]:
        reported = {m["name"] for m in SPEC["end_to_end"]
                    if harness.applies(m, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(harness.applies(m, w["name"]) for m in SPEC["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(workload):
    bench = harness.Bench(REPO, workload)
    for hook in ("build", "request", "iterations", "work_bytes",
                 "reference", "as_served", "numbers"):
        assert callable(getattr(bench.entry, hook))
    assert callable(bench.gen.generate)
    assert set(bench.readers) == {m["name"] for m in
                                  bench.end_to_end + bench.per_layer}
    assert set(bench.cfg["limits"]) and bench.cfg["reference"]["storage"] \
        == "float64"


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_traffic_and_metric_are_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    before = _digests(root)
    here = root / "gpubench"
    cfg = json.loads((here / "configs" / "psi-g500-s22.json").read_text())
    cfg.update(name="psi-g500-s9")
    cfg["inputs"]["scale"] = 9
    (here / "configs" / "psi-g500-s9.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "cold.json").read_text())
    traffic["top_k"] = 10
    (here / "traffic" / "cold_top10.json").write_text(json.dumps(traffic))
    (here / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.latencies))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="psi-g500-s9", source="test",
                                file="gpubench/configs/psi-g500-s9.json",
                                reduced=["scale"], why="test"))
    spec["workloads"].append(dict(name="g500s9.top10", config="psi-g500-s9",
                                  traffic="cold_top10", chips=1, why="test"))
    spec["end_to_end"].append(dict(name="requests_done", unit="requests",
                                   better="higher", bound=0.05,
                                   source="host_clock",
                                   workloads=["g500s9.top10"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = harness.run_cell(harness.Bench(root, "g500s9.top10"), 9, 0.1,
                              False, torch.device("cpu"))
    assert result["correct"] is True
    assert result["metrics"]["requests_done"]["value"] >= 1
    after = _digests(root)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {root.joinpath("BENCHMARK.json").relative_to(root)}
