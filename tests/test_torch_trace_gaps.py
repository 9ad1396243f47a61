"""``tools/trace_gaps.py``: idle gaps named by the harness's phase and the
innermost program span open when each began, the per-step idle, and the
tool's flow at a CPU size."""
import importlib.util
import io
import json
import sys
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from gpubench.devtrace import DeviceTrace  # noqa: E402


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_gaps", ROOT / "tools" / "trace_gaps.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


OPS = [("void k_a<float>(int)", 100, 250, None), ("k_b", 300, 400, None),
       ("k_c", 450, 500, None), ("k_d", 700, 800, None)]
PHASES = [("gpubench.request", 50, 900), ("gpubench.solve", 60, 600),
          ("gpubench.read", 600, 850)]
SPANS = [("engine.run", 70, 590), ("engine.issue", 210, 320),
         ("power_step.check", 220, 260), ("engine.gap_read", 400, 480)]


def test_gaps_are_named_by_the_innermost_open_span():
    got = _tool().attribute(OPS, PHASES, SPANS, 1e-6)
    assert [k for k, _ in got["gaps"]] == [
        "solve/engine.run > k_d", "solve/power_step.check > k_b",
        "solve/engine.gap_read > k_c"]
    assert [s for _, s in got["gaps"]] == pytest.approx([2e-7, 5e-8, 5e-8])
    assert got["solve_idle_s"] == pytest.approx(300e-9)
    assert got["solve_idle_named_share"] == 1.0
    assert got["loop_idle_s"] == pytest.approx(100e-9)
    assert got["steps"] == 1 and got["step_idle_us"] == pytest.approx(0.1)
    assert got["busy_s"] == pytest.approx(400e-9)
    assert got["device_idle_pct"] == pytest.approx(60.0)


def test_a_gap_is_named_on_the_hosts_clock():
    """Device times 30_000 ns ahead of the host's, each op started as its
    launch began: the gaps are named as on one clock."""
    skew = 30_000
    ops = [(name, a * 100 + skew, b * 100 + skew, skew)
           for name, a, b, _ in OPS]
    scaled = [(name, a * 100, b * 100) for name, a, b in SPANS]
    phases = [(name, a * 100, b * 100) for name, a, b in PHASES]
    got = _tool().attribute(ops, phases, scaled, 1e-4)
    assert [k for k, _ in got["gaps"]] == [
        "solve/engine.run > k_d", "solve/power_step.check > k_b",
        "solve/engine.gap_read > k_c"]
    assert got["clock_offset_us"]["median"] == pytest.approx(30.0)
    assert got["step_idle_us"] == pytest.approx(10.0)


def test_without_spans_the_gaps_are_the_benchmarks_own():
    got = _tool().attribute(OPS, PHASES, [], 1e-6)
    trace = DeviceTrace(window_s=1e-6, ops=[o[:3] for o in OPS],
                        phases=PHASES)
    assert got["gaps"] == trace.idle_gaps(k=len(OPS))
    assert got["solve_idle_named_share"] == 0.0
    assert got["steps"] == 0 and got["step_idle_us"] is None


def test_the_tool_runs_a_cell_at_a_cpu_size():
    from gpubench.tests.tiny import tiny_root
    tool = _tool()
    with tempfile.TemporaryDirectory() as tmp:
        root = tiny_root(Path(tmp))
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert tool.main(["--seed", str(2**31 + 9), "--seconds", "0.05",
                              "--rounds", "1", "--root", str(root),
                              "--device", "cpu"]) == 0
    out = json.loads(buf.getvalue())
    assert [name for name, _ in out["build"]["spans"]] == [
        "format.build", "engine.prepare"]
    assert set(out["engine_run_ms"]) == {"off", "fast"}
    assert {"engine.issue", "engine.gap_read", "ranking.copy"} <= set(
        out["span_median_us"])
    assert set(out["span_cost_us"]) == {"off", "tracer", "profiler_fast",
                                        "profiler_record_function"}
    assert [w["arm"] for w in out["windows"]] == [
        "fast", "record_function", "off", "off", "record_function", "fast"]
    for window in out["windows"]:
        spans = window["spans"]
        assert spans["engine.run"] == window["requests"]
        if window["arm"] != "off":
            assert spans["ranking.copy"] == window["requests"]
            assert spans["engine.issue"] == spans["engine.gap_read"] \
                == window["steps"] > 0
        else:
            assert set(spans) == {"engine.run"} and window["steps"] == 0
