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


# --------------------------------------------------------------------- #
# Profiler ranges and the spans inside the solver loop, the ranked read
# and the engine's build
# --------------------------------------------------------------------- #
def _user_ranges(prof) -> list:
    """(name, start_ns, end_ns) of the profile's CPU ranges that are not
    ATen operators."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if "::" not in e.name()
            and e.device_type() == torch.autograd.DeviceType.CPU]


def _psi_problem():
    import repro_torch.core as tc
    import repro_torch.graphs as tg
    g = tg.powerlaw_configuration(300, 1800, seed=3)
    return g, tc.heterogeneous(g.n, seed=4)


def _engine(backend, **kw):
    import repro_torch.core as tc
    g, act = _psi_problem()
    return tc.make_engine(backend, graph=g, activity=act, device="cpu",
                          dtype=torch.float64, **kw)


def test_span_opens_a_profiler_range_only_while_the_profiler_records():
    assert not trace.recording()
    with trace.span("probe.quiet") as quiet:
        assert quiet._range is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert trace.recording()
        with trace.span("probe.outer"):
            with trace.span("probe.inner"):
                torch.ones(4).add_(1.0)
    assert not trace.recording()
    ranges = {name: (a, b) for name, a, b in _user_ranges(prof)}
    assert "probe.quiet" not in ranges
    (oa, ob), (ia, ib) = ranges["probe.outer"], ranges["probe.inner"]
    assert oa <= ia <= ib <= ob            # nested, on the profiler's clock
    add = [(e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::add_"]
    assert add and ia <= add[0][0] <= add[0][1] <= ib


def test_hot_span_is_a_span_only_while_something_records(tracer):
    with trace.hot_span("probe.hot") as sp:
        assert isinstance(sp, trace.Span)
    assert [r["name"] for r in tracer.spans] == ["probe.hot"]
    trace.set_tracer(trace.NULL_TRACER)
    try:
        assert trace.hot_span("probe.hot") is trace.NO_SPAN
    finally:
        trace.set_tracer(tracer)


@pytest.mark.parametrize("check_every", [1, 3])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_live_tracer_records_each_body_of_the_loop(tracer, backend,
                                                   check_every):
    """One ``engine.issue`` and one ``engine.gap_read`` a loop body (every
    ``check_every`` steps), both children of the resolve's ``engine.run``."""
    eng = _engine(backend, check_every=check_every)
    tracer.spans.clear()
    res = eng.run(tol=1e-12)
    assert res.converged and res.iterations % check_every == 0
    bodies = res.iterations // check_every
    by_name: dict = {}
    for rec in tracer.spans:
        by_name.setdefault(rec["name"], []).append(rec)
    (run,) = by_name["engine.run"]
    for name in ("engine.issue", "engine.gap_read"):
        assert len(by_name[name]) == bodies
        assert {r["parent"] for r in by_name[name]} == {run["id"]}


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_quiet_loop_makes_no_span_and_reads_no_clock(monkeypatch, backend):
    """Under the null tracer with no profiler a loop body costs the test in
    ``hot_span``: no :class:`Span` is made and the span clock is not read."""
    eng = _engine(backend)
    made, reads, tests = [], [], []

    class Counted(trace.Span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(a[0])
            super().__init__(*a, **kw)

    real_now, real_hot = trace.now, trace.hot_span
    monkeypatch.setattr(trace, "Span", Counted)
    monkeypatch.setattr(trace, "now",
                        lambda: reads.append(1) or real_now())
    monkeypatch.setattr(trace, "hot_span",
                        lambda name: tests.append(name) or real_hot(name))
    s0 = eng._to_native(eng.ops.c) if backend == "cuda" else eng.ops.c
    assert not trace.recording()
    s, gap, t = eng._loop(s0, 1e-12, 10_000)
    assert t > 10 and float(gap) <= 1e-12
    assert made == [] and reads == []
    assert tests == ["engine.issue", "engine.gap_read"] * t


@pytest.mark.parametrize("backend", ["reference", "cuda", "accelerated"])
def test_results_are_bitwise_equal_with_tracing_on_and_off(tmp_path,
                                                           backend):
    eng = _engine(backend)
    quiet = eng.run(tol=1e-12)
    live = trace.Tracer(str(tmp_path / "spans.jsonl"))
    prev = trace.set_tracer(live)
    try:
        traced = eng.run(tol=1e-12)
    finally:
        trace.set_tracer(prev)
        live.close()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiled = eng.run(tol=1e-12)
    for other in (traced, profiled):
        assert torch.equal(other.psi, quiet.psi)
        assert torch.equal(other.s, quiet.s)
        assert other.gap == quiet.gap
        assert other.iterations == quiet.iterations
    names = [name for name, _, _ in _user_ranges(prof)]
    assert names.count("engine.run") == 1
    # the Aitken loop stays as it was: no per-body spans
    bodies = 0 if backend == "accelerated" else quiet.iterations
    assert names.count("engine.issue") == bodies
    assert names.count("engine.gap_read") == bodies


def _histogram_count(name):
    fam = obs_metrics.get_registry().get(name)
    return 0 if fam is None else fam.merged().count


def test_ranking_cache_records_its_copy(tracer):
    from repro_torch.core import RankingCache
    cache = RankingCache(torch.arange(5, dtype=torch.float64))
    assert cache.top_k(2)[0].tolist() == [4, 3]
    assert [r["name"] for r in tracer.spans] == ["ranking.copy"]


@pytest.mark.parametrize("backend", ["cuda", "auto", "reference"])
def test_make_engine_records_its_build(tracer, backend):
    """One ``engine.prepare`` a build (``auto``'s prepare calls ``cuda``'s
    and still opens one), the format build inside it, and each span's
    seconds in its histogram."""
    before = (_histogram_count("psi_engine_prepare_seconds"),
              _histogram_count("psi_format_build_seconds"))
    eng = _engine(backend)
    spans = list(tracer.spans)
    (prep,) = [r for r in spans if r["name"] == "engine.prepare"]
    assert prep["attrs"] == {"backend": backend} and prep["depth"] == 0
    builds = [r for r in spans if r["name"] == "format.build"]
    if backend == "reference":
        assert builds == []
    else:
        (build,) = builds
        assert build["parent"] == prep["id"]
        assert build["attrs"] == {"regime": eng.regime}
        assert prep["dur"] >= build["dur"] > 0.0
    after = (_histogram_count("psi_engine_prepare_seconds"),
             _histogram_count("psi_format_build_seconds"))
    assert after[0] - before[0] == 1
    assert after[1] - before[1] == len(builds)
    assert not getattr(eng, "_preparing")
