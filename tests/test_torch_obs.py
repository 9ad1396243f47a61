"""The port's copies of the JAX package's jax-free ``obs`` modules.

``metrics``, ``log``, ``convergence`` and ``explain`` are verbatim copies;
``calibrate`` differs only in how a sample's environment is keyed (the
engine's device and dtype instead of the JAX platform and x64 flag), and
``env`` is written anew from torch. The store's arithmetic is held against
the JAX package's on the same samples.
"""
import pathlib

import pytest
import torch

from repro.obs import calibrate as jcal
from repro_torch.obs import (calibrate, device_fingerprint,
                             environment_fingerprint, explain)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("name", ["metrics", "log", "convergence",
                                  "explain"])
def test_copied_modules_are_verbatim(name):
    port = (SRC / "repro_torch" / "obs" / f"{name}.py").read_text()
    assert port == (SRC / "repro" / "obs" / f"{name}.py").read_text()


SAMPLES = [("edge_tile", 100.0, 200.0), ("edge_tile", 100.0, 400.0),
           ("edge_tile", 50.0, 50.0), ("bsr", 2.0, 6.0), ("bsr", 2.0, 10.0),
           ("bsr", 1.0, 9.0)]


def test_store_arithmetic_matches_jax():
    env = calibrate.env_key("cpu", torch.float32)
    port = calibrate.CalibrationStore(env=env)
    ref = jcal.CalibrationStore(env=env)
    for regime, est, us in SAMPLES:
        assert port.observe(regime, est, us) == ref.observe(regime, est, us)
    assert port.factors() == ref.factors()
    assert port.multipliers({"edge_tile", "bsr", "dense"}) == \
        ref.multipliers({"edge_tile", "bsr", "dense"})
    assert port.generation == ref.generation
    assert port.to_json() == ref.to_json()
    assert port.observe("bsr", 0.0, 5.0) is None          # no information


def test_store_is_keyed_per_device_and_dtype(tmp_path):
    k32 = calibrate.env_key("cpu", torch.float32)
    k64 = calibrate.env_key(torch.device("cpu"), torch.float64)
    store = calibrate.CalibrationStore()
    for _ in range(2):
        store.observe("bsr", 1.0, 3.0, env=k64)
    assert store.factor("bsr", env=k64)["count"] == 2
    assert store.factor("bsr", env=k32) is None
    assert store.multipliers({"bsr"}, env=k32) == {}
    path = str(tmp_path / "calib.json")
    store.save(path)
    back = calibrate.CalibrationStore()
    assert back.load(path) == 1
    assert back.factors(env=k64) == store.factors(env=k64)
    with pytest.raises(ValueError, match="env_key"):
        back.factors()                      # no implicit environment


def test_env_fingerprint_names_torch_and_the_device():
    fp = environment_fingerprint("cpu")
    assert fp["torch"] == torch.__version__
    assert fp["device_platform"] == "cpu"
    assert {"cuda", "device_count", "git_sha", "compute_capability",
            "timestamp_utc"} <= set(fp)
    assert device_fingerprint("cpu")["compute_capability"] is None
    with pytest.raises(ValueError, match="unsupported device"):
        device_fingerprint("meta")


def test_decision_log_records_a_plan():
    from repro_torch.graphs import erdos_renyi
    from repro_torch.kernels.autotune import plan_regime
    prev = explain.set_log(explain.DecisionLog())
    try:
        plan_regime(erdos_renyi(200, 900, seed=1), cache=None,
                    calibration=None)
        rec = explain.get_log().last(kind="regime_plan")
    finally:
        explain.set_log(prev)
    assert rec.cache == "bypass" and rec.source == "model"
    assert [p.name for p in rec.pruned] == ["bsr(ts=128,td=128)",
                                            "bsr(ts=128,td=256)"]
    assert sum(c.chosen for c in rec.candidates) == 1
    assert explain.render_decision(rec)
