"""Byte counts from the inputs' sizes, the peaks, and the metric readers
over a synthetic run."""
import pytest
import torch

from gpubench import devtrace, roofline
from gpubench.harness import Run, load_file
from gpubench.tests.tiny import REPO


def _reader(name):
    return load_file(REPO / "gpubench" / "metrics" / f"{name}.py", "metric")


def test_step_bytes_count_edges_offsets_and_five_vectors():
    assert roofline.step_bytes(10, 30, 4) == 4 * 30 + 4 * 11 + 5 * 10 * 4
    assert roofline.step_bytes(10, 30, 8) == 4 * 30 + 4 * 11 + 400


def test_work_bytes_come_from_the_inputs_sizes():
    engine = load_file(REPO / "gpubench" / "entries" / "engine.py", "entry")
    for dtype, elem in (("float64", 8), ("float32", 4)):
        g = dict(n=100, src=torch.zeros(700, dtype=torch.int32))
        step = roofline.step_bytes(100, 700, elem)
        assert engine.work_bytes({"dtype": dtype}, g) == dict(
            step=step, epilogue=step)


def test_peaks_of_the_h100_and_none_elsewhere():
    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks_for("cpu") is None


def _trace():
    ms = 1_000_000
    ops = [("void (anonymous namespace)::power_step_kernel<double>(x)", 0,
            4 * ms),
           ("void (anonymous namespace)::power_step_kernel<double>(x)",
            5 * ms, 9 * ms),
           ("Memcpy DtoH (Device -> Pageable)", 8 * ms, 10 * ms)]
    phases = [("gpubench.request", 0, 20 * ms), ("gpubench.solve", 0,
                                                  9 * ms)]
    return devtrace.DeviceTrace(window_s=0.02, ops=ops, phases=phases)


def test_device_trace_busy_idle_and_breakdown():
    tr = _trace()
    assert tr.busy_s == pytest.approx(0.009)
    assert tr.kernel_seconds("power_step_kernel") == (pytest.approx(0.008),
                                                      2)
    assert tr.top_ops()[0] == ["power_step_kernel", pytest.approx(0.008)]
    assert tr.idle_gaps() == [["solve > power_step_kernel",
                               pytest.approx(0.001)]]


def test_readers_of_a_synthetic_run():
    run = Run(setup_s=3.5, window_s=1.0,
              latencies=[0.1, 0.2, 0.3, 0.4], iterations=[10, 10, 10, 10],
              phases=[("read", 0.0, 0.002), ("read", 1.0, 1.004),
                      ("solve", 0.0, 1.0)],
              program_spans=[dict(name="engine.run", dur=0.05),
                             dict(name="query", dur=0.03)],
              trace=_trace(), work=dict(step=1e9, epilogue=2e9),
              peaks=dict(hbm_bytes_per_s=1e12))
    read = {name: _reader(name).read(run) for name in (
        "rank_ms", "rank_p95_ms", "setup_s", "read_ms", "engine_run_ms",
        "iterations", "power_step_roofline",
        "solve_roofline", "device_idle_pct")}
    assert read["rank_ms"] == pytest.approx(250.0)
    assert read["rank_p95_ms"] == pytest.approx(385.0)
    assert read["setup_s"] == 3.5
    assert read["read_ms"] == pytest.approx(3.0)
    assert read["engine_run_ms"] == pytest.approx(50.0)
    assert read["iterations"] == 10.0
    # 2 launches × 1 GB at 1 TB/s = 2 ms of the kernels' 8 ms
    assert read["power_step_roofline"] == pytest.approx(25.0)
    # 4 × (10 GB + 2 GB) at 1 TB/s = 48 ms of 1 s of requests
    assert read["solve_roofline"] == pytest.approx(4.8)
    assert read["device_idle_pct"] == pytest.approx(55.0)


def test_readers_return_nothing_without_a_trace_or_a_card():
    run = Run()
    for name in ("rank_ms", "read_ms", "power_step_roofline",
                 "solve_roofline", "device_idle_pct", "iterations"):
        assert _reader(name).read(run) is None
