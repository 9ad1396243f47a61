"""The port's spans and retrace guard (``repro_torch.obs.trace``) against
the JAX package's ``repro.obs.trace``: span nesting on one clock, the
Tracer's JSONL and Chrome export, ``Span.sync`` on tensors, and the guard
counting a new input signature where ``jit`` would recompile."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.trace as jtrace
import repro_torch.obs as obs
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace


@pytest.fixture
def tracer(tmp_path):
    t = trace.Tracer(str(tmp_path / "spans.jsonl"))
    prev = trace.set_tracer(t)
    yield t
    trace.set_tracer(prev)
    t.close()


def _nest(mod):
    """The same nesting of spans on either package's tracer."""
    with mod.span("outer", tenant="a") as outer:
        with mod.span("inner") as inner:
            pass
        with mod.span("inner2"):
            pass
    return outer, inner


def test_span_nesting_matches_jax(tracer, tmp_path):
    outer, inner = _nest(trace)
    jt = jtrace.Tracer(str(tmp_path / "jax.jsonl"))
    prev = jtrace.set_tracer(jt)
    try:
        _nest(jtrace)
    finally:
        jtrace.set_tracer(prev)
        jt.close()
    assert inner.parent_id == outer.span_id and inner.depth == 1
    assert outer.parent_id is None and outer.depth == 0
    assert outer.duration_s >= inner.duration_s >= 0.0
    ours = [(r["name"], r["depth"], r.get("attrs")) for r in tracer.spans]
    theirs = [(r["name"], r["depth"], r.get("attrs")) for r in jt.spans]
    assert ours == theirs == [("inner", 1, None), ("inner2", 1, None),
                              ("outer", 0, {"tenant": "a"})]


def test_tracer_writes_jsonl_and_chrome(tracer, tmp_path):
    with trace.span("solve", spec="bucket[n≤512, m≤4096]") as sp:
        sp.sync(torch.ones(3))
    tracer.flush()
    lines = [json.loads(x) for x in
             open(tmp_path / "spans.jsonl").read().splitlines()]
    assert [r["name"] for r in lines] == ["solve"]
    rec = lines[0]
    assert rec["attrs"] == {"spec": "bucket[n≤512, m≤4096]"}
    assert rec["dur"] >= rec["dispatch_s"] >= 0.0 and rec["sync_s"] >= 0.0
    path = tracer.export_chrome(str(tmp_path / "trace.json"))
    events = json.load(open(path))["traceEvents"]
    assert {e["ph"] for e in events} == {"M", "X"}
    assert [e["name"] for e in events if e["ph"] == "X"] == ["solve"]


def test_null_tracer_measures_without_emitting():
    assert trace.get_tracer() is trace.NULL_TRACER
    with trace.span("quiet") as sp:
        pass
    assert sp.tracer is None and sp.duration_s >= 0.0
    assert obs.NULL_TRACER is trace.NULL_TRACER


def test_span_sync_returns_its_value_and_walks_containers():
    value = {"s": torch.zeros(2), "pair": (torch.ones(1), 3)}
    with trace.span("sync") as sp:
        assert sp.sync(value) is value
    assert sp.dispatch_s is not None and sp.sync_s >= 0.0
    assert len(list(trace._tensors(value))) == 2


def test_retrace_guard_counts_a_new_signature_like_jit():
    """A repeated signature counts nothing; each new one counts one, as
    the JAX guard counts jit cache growth on the same call sequence."""
    counter = obs_metrics.counter(
        "psi_retraces_total", "silent jit recompiles caught by "
        "retrace_guard", labelnames=("fn",)).labels(fn="probe")
    before = counter.value
    guard = obs.retrace_guard(lambda x, y=None: x * 2, name="probe")
    jguard = jtrace.retrace_guard(jax.jit(lambda x, y=None: x * 2),
                                  name="jax-probe")
    shapes = [(3,), (3,), (4,), (3,), (2, 2), (4,)]
    for shape in shapes:
        guard(torch.zeros(shape))
        jguard(jnp.zeros(shape))
    assert guard.retraces == jguard.retraces == 2
    assert counter.value - before == 2
    last = obs_log.recent(1, name="retrace")[0]
    assert last["fn"] == "probe" and last["level"] == "warning"
    # dtype is part of the signature; non-tensor arguments are not
    guard(torch.zeros(3, dtype=torch.float64))
    guard(torch.zeros(3), y=5)
    assert guard.retraces == 3
    assert guard.__name__ == "retrace_guard(probe)"
    assert trace.signature((torch.zeros(2, 3), [np.zeros(1)]), {}) == \
        (((2, 3), torch.float32),)


def test_fleet_loop_counts_a_second_bucket_shape():
    """The fleet guards its shared loop: a second bucket shape's first solve
    is one new signature (counted, at info level)."""
    import repro_torch.core as tc
    import repro_torch.graphs as tg
    from repro_torch.serving import BucketPolicy, TenantFleet
    fleet = TenantFleet(backend="reference", device="cpu",
                        policy=BucketPolicy((256, 512), edge_quantum=4096))
    fleet.admit("a", tg.erdos_renyi(200, 900, seed=1),
                tc.heterogeneous(200, seed=2))
    fleet.admit("b", tg.erdos_renyi(400, 1800, seed=3),
                tc.heterogeneous(400, seed=4))
    fleet.solve()
    loop, _ = fleet._loop_and_epilogue("reference")
    assert loop.retraces == 1 and loop.name == "fleet.reference.loop"
