"""The reader of the step kernel's row-path share: the program's gauge in
percent, silent where the program has no such gauge, and in a traced run
at a CPU size."""
import pytest
import torch

from gpubench import harness
from gpubench.tests.tiny import REPO, tiny_root


@pytest.fixture
def registry(monkeypatch):
    """A fresh metrics registry of the program for the test."""
    from repro_torch.obs import metrics
    fresh = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_REGISTRY", fresh)
    return fresh


def _reader():
    return harness.load_file(REPO / "gpubench" / "metrics" /
                             "row_path_pct.py", "metric")


def test_row_path_pct_reads_the_gauge_in_percent(registry):
    assert _reader().read(harness.Run()) is None
    registry.gauge("psi_edge_tile_row_path_share").set(0.875)
    assert _reader().read(harness.Run()) == pytest.approx(87.5)


def test_a_traced_run_reports_the_row_path_share(tmp_path, registry):
    root = tiny_root(tmp_path)
    result = harness.run_cell(harness.Bench(root, "g500s22.cold"),
                              2**31 + 11, 0.1, True, torch.device("cpu"))
    assert result["correct"] is True
    got = result["metrics"]["row_path_pct"]
    assert got["unit"] == "%" and 0.0 <= got["value"] <= 100.0
    plain = harness.run_cell(harness.Bench(root, "g500s22.cold"),
                             2**31 + 11, 0.1, False, torch.device("cpu"))
    assert "row_path_pct" not in plain["metrics"]
