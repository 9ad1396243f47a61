"""The readers of the program's spans inside the solver loop, the ranked
read and the engine's build: each on a made-up run, silent where the
program has no such span, and all of them in a traced run at a CPU size."""
import pytest
import torch

from gpubench import harness
from gpubench.tests.tiny import REPO, tiny_root

SPAN_METRICS = ("step_issue_us", "psi_copy_ms", "prepare_s",
                "format_build_s")


@pytest.fixture
def registry(monkeypatch):
    """A fresh metrics registry of the program for the test."""
    from repro_torch.obs import metrics
    fresh = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_REGISTRY", fresh)
    return fresh


def _reader(name):
    return harness.load_file(REPO / "gpubench" / "metrics" / f"{name}.py",
                             "metric")


def _spans(*pairs):
    return [dict(name=name, dur=dur) for name, dur in pairs]


def test_step_issue_and_psi_copy_read_the_medians_of_their_spans():
    run = harness.Run(program_spans=_spans(
        ("engine.run", 1.0), ("engine.issue", 40e-6),
        ("engine.gap_read", 2e-3), ("engine.issue", 10e-6),
        ("engine.issue", 30e-6), ("ranking.copy", 4e-3),
        ("ranking.copy", 2e-3)))
    assert _reader("step_issue_us").read(run) == pytest.approx(30.0)
    assert _reader("psi_copy_ms").read(run) == pytest.approx(3.0)


def test_build_readers_sum_their_histograms(registry):
    prep = registry.histogram("psi_engine_prepare_seconds",
                              labelnames=("backend",))
    build = registry.histogram("psi_format_build_seconds",
                               labelnames=("regime",))
    prep.labels(backend="cuda").observe(41.5)
    build.labels(regime="edge_tile").observe(12.25)
    build.labels(regime="bsr").observe(0.75)
    run = harness.Run()
    assert _reader("prepare_s").read(run) == pytest.approx(41.5)
    assert _reader("format_build_s").read(run) == pytest.approx(13.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_spans_reads_nothing(registry, name):
    run = harness.Run(program_spans=_spans(("engine.run", 1.0)))
    assert _reader(name).read(run) is None
    registry.histogram("psi_engine_prepare_seconds", labelnames=("backend",))
    registry.histogram("psi_format_build_seconds", labelnames=("regime",))
    assert _reader(name).read(harness.Run()) is None    # nothing observed


def test_a_traced_run_reports_the_span_metrics(tmp_path, registry):
    root = tiny_root(tmp_path)
    result = harness.run_cell(harness.Bench(root, "g500s22.cold"),
                              2**31 + 7, 0.2, True, torch.device("cpu"))
    assert result["correct"] is True
    got = result["metrics"]
    assert set(SPAN_METRICS) <= set(got)
    assert got["step_issue_us"]["unit"] == "us"
    assert all(got[name]["value"] > 0 for name in SPAN_METRICS)
    assert got["format_build_s"]["value"] <= got["prepare_s"]["value"]
    plain = harness.run_cell(harness.Bench(root, "g500s22.cold"),
                             2**31 + 7, 0.1, False, torch.device("cpu"))
    assert not set(SPAN_METRICS) & set(plain["metrics"])
