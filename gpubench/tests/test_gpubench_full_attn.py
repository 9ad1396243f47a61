"""The reader of the full layers' decode-attention roofline share: the
kernel's launches times the program's gauge at the card's bandwidth over
the kernel's and its merge's device time; silent where the program has no
such gauge or kernel (as on a tree without the kernel) or the run no
trace."""
import pytest

from gpubench import devtrace, harness
from gpubench.tests.tiny import REPO


@pytest.fixture
def registry(monkeypatch):
    """A fresh metrics registry of the program for the test."""
    from repro_torch.obs import metrics
    fresh = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_REGISTRY", fresh)
    return fresh


def _reader():
    return harness.load_file(REPO / "gpubench" / "metrics" /
                             "full_attn_roofline.py", "metric")


def _run(ops) -> harness.Run:
    return harness.Run(trace=devtrace.DeviceTrace(window_s=1.0, ops=ops,
                                                  phases=[]),
                       peaks=dict(hbm_bytes_per_s=2e12))


SPLIT = "void (anonymous namespace)::decode_attn_kernel<192, 128>(...)"
MERGE = "void (anonymous namespace)::decode_attn_merge_kernel<128>(...)"


def test_full_attn_roofline_reads_launches_times_the_gauge(registry):
    # two launches of 1.5 ms + 0.1 ms of merge each, 2.4 GB a launch
    ops = [(SPLIT, 0, 1_500_000), (MERGE, 1_500_000, 1_600_000),
           (SPLIT, 2_000_000, 3_500_000), (MERGE, 3_500_000, 3_600_000),
           ("nvjet_tst_128x16", 3_600_000, 9_000_000)]
    registry.gauge("lm_decode_attn_least_bytes").set(2.4e9)
    got = _reader().read(_run(ops))
    assert got == pytest.approx(2 * 2.4e9 / 2e12 / 3.2e-3 * 100)


def test_full_attn_roofline_is_silent_without_its_gauge_or_kernel(registry):
    ops = [(SPLIT, 0, 1_000_000), (MERGE, 1_000_000, 1_100_000)]
    assert _reader().read(_run(ops)) is None             # no gauge: a parent
    registry.gauge("lm_decode_attn_least_bytes").set(1e9)
    assert _reader().read(_run([("nvjet_tst", 0, 10)])) is None
    assert _reader().read(harness.Run()) is None         # untraced
    assert _reader().read(_run(ops)) > 0
