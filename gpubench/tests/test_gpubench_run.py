"""Whole runs of every cell at a CPU size: the result line, and `correct`
coming out false for the control and for each fault the cells can have."""
import json

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.tests.tiny import tiny_root

CPU = torch.device("cpu")
CELLS = ("g500s22.cold",)
SEED = 2**31 + 101


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, workload, *, trace=False, seed=SEED):
    return harness.run_cell(harness.Bench(root, workload), seed, 0.1, trace,
                            CPU)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_prints_the_contracts_line(root, workload, trace, capsys):
    result = _run(root, workload, trace=trace)
    line = harness.result_line(result)
    err = capsys.readouterr().err.strip().splitlines()
    back = json.loads(line)
    assert list(back) == ["correct", "attempted", "failed", "metrics",
                          "device"] + (["breakdown"] if trace else []) + \
        ["check"]
    assert back["correct"] is True and back["failed"] == 0
    assert back["attempted"] >= 1
    assert back["device"]["platform"] == "cpu"
    assert err[-len(back["check"]):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in back["check"].items()]
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"}
    names = set(back["metrics"])
    if trace:
        # the CPU has no device trace: the readers of the card stay silent
        assert {"read_ms", "iterations"} <= names
        assert not names & {"power_step_roofline", "device_idle_pct"}
        assert {"busy_s", "window_s"} <= set(back["device"])
    else:
        assert names == {"rank_ms", "rank_p95_ms", "setup_s"}


def _still(monkeypatch):
    """A step that returns its state unchanged (and a zero gap)."""
    import repro_torch.core.engine as eng
    monkeypatch.setattr(eng, "power_step",
                        lambda s, *a: (s, torch.zeros((), dtype=s.dtype)))


def _half_users(monkeypatch):
    """Half of the users left out of every step: their state stays."""
    import repro_torch.core.engine as eng
    step = eng.power_step

    def halved(s, *a):
        s_new, _ = step(s, *a)
        h = s.shape[0] // 2
        s_new = torch.cat([s_new[:h], s[h:]])
        return s_new, (s_new - s).abs().sum()

    monkeypatch.setattr(eng, "power_step", halved)


def _psi_altered(monkeypatch):
    """One user's ψ altered where the epilogue produces it."""
    from repro_torch.core.engine import CudaEngine
    epi = CudaEngine.epilogue

    def bumped(self, s):
        psi = epi(self, s).clone()
        psi.view(-1)[0] *= 1 + 1e-3
        return psi

    monkeypatch.setattr(CudaEngine, "epilogue", bumped)


def _top_altered(monkeypatch):
    """The top-k read's first id replaced by the (k+1)-th best."""
    from repro_torch.core.incremental import RankingCache
    top = RankingCache.top_k

    def wrong(self, k):
        ids, vals = top(self, k + 1)
        return np.concatenate([ids[k:], ids[1:k]]), vals[:k]

    monkeypatch.setattr(RankingCache, "top_k", wrong)


@pytest.mark.parametrize("workload,fault", [
    ("g500s22.cold", _still), ("g500s22.cold", _half_users),
    ("g500s22.cold", _psi_altered), ("g500s22.cold", _top_altered)])
def test_a_fault_in_the_timed_path_is_not_correct(root, monkeypatch,
                                                   workload, fault):
    fault(monkeypatch)
    result = _run(root, workload)
    assert result["correct"] is False and result["failed"] == 0
    assert any(c["value"] > c["limit"] for c in result["check"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(root, workload):
    result = harness.run_cell(harness.Bench(root, workload), SEED, 0.1,
                              False, CPU, control=True)
    line = json.loads(harness.result_line(result))
    assert line["correct"] is False and line["metrics"] == {}
    assert all(c["value"] > c["limit"] for c in line["check"].values())
