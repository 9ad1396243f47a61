"""The port's bounded-staleness executor (``repro_torch.asyncexec``) against
the JAX package's (``repro.asyncexec``): the counterparts of
``tests/test_async.py`` (certificate math, chunk scheduler, the ``async``
engine, the driver's fault tolerance, the staleness-injection properties),
the chunk layout and step against JAX's, the τ = 0 epoch counts against
JAX's at float64, and the two ``tests/test_stream.py`` cases that drive the
async-driver target.

The port runs with ``device="cpu"``. Tolerances: ψ within 1e-6 (L∞) of
``exact_psi`` or of the ``reference`` engine, as the JAX tests hold; chunk
layouts bitwise; a chunk step at float64 within 1e-14 relative of JAX's.
"""
import contextlib
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.asyncexec as ja
import repro.core as jc
import repro.graphs as jg
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch import obs as tobs
from repro_torch.asyncexec import (AsyncChunkScheduler, AsyncPsiDriver,
                                   ChunkedOperators, RhoEstimator,
                                   StalenessBound, certify_gap)
from repro_torch.convert import chunk_args_from_numpy
from repro_torch.core import (Activity, HostOperators, PsiService,
                              available_backends, exact_psi, heterogeneous,
                              make_engine)
from repro_torch.core.engine import ChunkExtrapolator
from repro_torch.graphs import erdos_renyi, powerlaw_configuration
from repro_torch.graphs.structure import Graph

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                          # dev-only dep
    HAVE_HYPOTHESIS = False

CPU = dict(device="cpu")


@contextlib.contextmanager
def _x64():
    """JAX at float64 for the duration, in every thread (the JAX driver
    steps its chunks on worker threads, which a thread-local switch would
    miss)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture(autouse=True)
def _fresh_sinks():
    """Fresh obs sinks for each test (they are process-global)."""
    prev = tobs.configure(registry=tobs.MetricsRegistry(),
                          tracker=tobs.ConvergenceTracker(keep=4096),
                          decisions=tobs.DecisionLog())
    yield
    tobs.restore(prev)


@pytest.fixture(scope="module")
def platform():
    g = powerlaw_configuration(400, 2400, seed=50)
    act = heterogeneous(g.n, seed=51)
    psi_true, _ = exact_psi(g, act)
    return g, act, psi_true


# --------------------------------------------------------------------- #
# Staleness model + certificate
# --------------------------------------------------------------------- #
def test_certificate_trusts_and_inflates_within_tau():
    bound = StalenessBound(tau=2)
    cert = certify_gap([1e-9] * 4, [5, 4, 5, 5], bound=bound, rho=0.5)
    assert cert.trusted and cert.spread == 1
    # ρ-inflation: one epoch of spread at ρ=0.5 doubles the certified gap
    assert cert.certified_gap == pytest.approx(4e-9 * 2.0)
    assert cert.accepts(1e-7) and not cert.accepts(1e-9)


def test_certificate_rejects_tau_violation():
    """A τ-violating assembly is rejected regardless of its magnitude."""
    cert = certify_gap([1e-16] * 4, [8, 5, 8, 8],
                       bound=StalenessBound(tau=2), rho=0.9)
    assert cert.spread == 3
    assert not cert.trusted
    assert not cert.accepts(1.0)
    assert cert.certified_gap > cert.raw_gap


def test_staleness_bound_validation():
    with pytest.raises(ValueError, match="tau"):
        StalenessBound(tau=-1)
    with pytest.raises(ValueError, match="rho"):
        StalenessBound(tau=1, rho=1.5)
    with pytest.raises(ValueError, match="tau"):
        make_engine("async", tau=-2, **CPU)


def test_rho_estimator_is_conservative():
    est = RhoEstimator(init=0.9)
    assert est.value == 0.9
    for gap in (1.0, 0.5, 0.3, 0.21):        # ratios 0.5, 0.6, 0.7
        est.update(gap)
    assert est.value == pytest.approx(0.5)
    est.update(1e-6)                         # transient collapse clamps
    assert est.value >= 0.05


def test_staleness_module_matches_jax():
    """The same certificates and ρ estimates as the JAX module (exact)."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        gaps = rng.uniform(0, 1e-6, 5)
        epochs = rng.integers(0, 6, 5)
        tau, rho = int(rng.integers(0, 4)), float(rng.uniform(0.1, 0.99))
        ours = certify_gap(gaps, epochs, bound=StalenessBound(tau), rho=rho,
                           scale=2.0)
        theirs = ja.certify_gap(gaps, epochs, bound=ja.StalenessBound(tau),
                                rho=rho, scale=2.0)
        assert ours.__dict__ == theirs.__dict__
    e_t, e_j = RhoEstimator(), ja.RhoEstimator()
    for gap in rng.uniform(0, 1, 12):
        e_t.update(gap)
        e_j.update(gap)
        assert e_t.value == e_j.value


# --------------------------------------------------------------------- #
# Chunk decomposition: layout and step against JAX; one synchronous sweep
# == one global iteration
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("chunks", [1, 3, 4])
def test_chunk_layout_and_step_match_jax(chunks):
    """Every chunk's args bitwise JAX's (the run lengths counted from JAX's
    dst ids), and one chunk step at float64 within 1e-14 relative."""
    g_t = tg.powerlaw_configuration(300, 1800, seed=3)
    g_j = jg.powerlaw_configuration(300, 1800, seed=3)
    act_t, act_j = tc.heterogeneous(300, seed=4), jc.heterogeneous(300,
                                                                   seed=4)
    ours = ChunkedOperators(HostOperators.from_graph(g_t, act_t), chunks,
                            dtype=torch.float64, **CPU)
    with _x64():
        theirs = ja.ChunkedOperators(jc.HostOperators.from_graph(g_j, act_j),
                                     chunks, dtype=jnp.float64)
        step_j = jax.jit(ja.make_chunk_step(theirs.q))
        board_j = theirs.board0
        outs_j = [step_j(a, board_j) for a in theirs.args]
        fields = [{k: np.asarray(getattr(a, k)) for k in (
            "src", "dst_local", "mu", "c", "inv_w", "start")}
            for a in theirs.args]
        outs_j = [(np.asarray(s), float(gap)) for s, gap in outs_j]
    assert (ours.q, ours.n_pad, ours.e_max) == (theirs.q, theirs.n_pad,
                                                theirs.e_max)
    from repro_torch.asyncexec import make_chunk_step
    step = make_chunk_step(ours.q)
    for k, a in enumerate(ours.args):
        conv = chunk_args_from_numpy(fields[k], q=ours.q, **CPU)
        for name in ("src", "lengths", "mu", "c", "inv_w"):
            assert torch.equal(getattr(a, name), getattr(conv, name)), name
        assert a.start == conv.start
        s_new, gap = step(a, ours.board0)
        np.testing.assert_allclose(s_new.numpy(), outs_j[k][0], rtol=1e-14,
                                   atol=0)
        assert float(gap) == pytest.approx(outs_j[k][1], rel=1e-12)


def test_sync_sweep_is_one_global_iteration(platform):
    g, act, _ = platform
    host = HostOperators.from_graph(g, act)
    chunked = ChunkedOperators(host, 4, **CPU)
    sched = AsyncChunkScheduler(chunked)
    ops = tc.build_operators(g, act, **CPU)
    new, raw = sched.sync_sweep(chunked.board0)
    s0 = ops.c
    s1 = ops.mu * ops.push(s0) + ops.c
    # host mirror accumulates in f64 before the device cast, so the chunked
    # operands can differ from the all-f32 build by an ulp
    np.testing.assert_allclose(chunked.node_order(new).numpy(), s1.numpy(),
                               rtol=1e-6, atol=1e-9)
    assert raw == pytest.approx(float(torch.abs(s1 - s0).sum()), rel=1e-4)


# --------------------------------------------------------------------- #
# Async engine: parity + straggler absorption
# --------------------------------------------------------------------- #
def test_async_backend_registered():
    assert "async" in available_backends()


@pytest.mark.parametrize("tau,chunks", [(0, 4), (1, 3), (2, 4), (3, 7)])
def test_async_converges_to_sync_fixed_point(platform, tau, chunks):
    g, act, psi_true = platform
    eng = make_engine("async", graph=g, activity=act,
                      num_chunks=chunks, tau=tau, **CPU)
    res = eng.run(tol=1e-10)
    assert res.converged
    assert np.abs(res.psi.numpy() - psi_true).max() <= 1e-6
    out = eng.last_run
    assert out.sync_sweeps >= 1              # termination was sync-verified
    # observed pipeline skew never exceeds the bound (+1 for the transient
    # where a τ-ahead chunk publishes before the floor advances)
    assert out.max_staleness <= tau + 1


@pytest.mark.parametrize("chunks,tol", [(4, 1e-9), (3, 1e-11)])
def test_tau0_epochs_equal_jax_at_f64(chunks, tol):
    """τ = 0 is the bulk-synchronous schedule: at float64 the port's driver
    takes JAX's epoch count, chunk steps and verification sweeps, and its ψ
    is within 1e-12 (L∞) of JAX's."""
    g_t = tg.powerlaw_configuration(400, 2400, seed=50)
    g_j = jg.powerlaw_configuration(400, 2400, seed=50)
    rep_t = AsyncPsiDriver(g_t, tc.heterogeneous(400, seed=51),
                           num_chunks=chunks, tau=0, dtype=torch.float64,
                           **CPU).run(tol=tol)
    with _x64():
        rep_j = ja.AsyncPsiDriver(g_j, jc.heterogeneous(400, seed=51),
                                  num_chunks=chunks, tau=0,
                                  dtype=jnp.float64).run(tol=tol)
    assert rep_t.converged and rep_j.converged
    assert rep_t.iterations == rep_j.iterations
    assert rep_t.chunks == rep_j.chunks
    assert rep_t.sync_sweeps == rep_j.sync_sweeps
    assert np.array_equal(rep_t.epochs, rep_j.epochs)
    assert np.abs(rep_t.psi - np.asarray(rep_j.psi)).max() <= 1e-12


def test_many_workers_under_fast_thread_switching(platform):
    """More worker threads than cores, switching every microsecond: the
    scheduling thread alone publishes boards and epochs, so no update is
    lost and the run lands on the reference fixed point (L∞ 1e-6)."""
    import sys
    g, act, psi_true = platform
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        eng = make_engine("async", graph=g, activity=act, num_chunks=16,
                          tau=2, **CPU)
        res = eng.run(tol=1e-10)
    finally:
        sys.setswitchinterval(prev)
    out = eng.last_run
    assert res.converged and out.sync_sweeps >= 1
    # every chunk step was published exactly once: each chunk's logged
    # epochs run 1, 2, … without a gap or a repeat, and the steps add up
    log = eng.sched.step_log
    for k in range(16):
        epochs = [e for c, e, _ in log if c == k]
        assert epochs == list(range(1, len(epochs) + 1)), k
    assert out.total_steps == len(log) + 16 * out.sync_sweeps
    assert np.abs(res.psi.numpy() - psi_true).max() <= 1e-6


def test_unsealing_sweep_keeps_each_chunks_epochs_contiguous(platform,
                                                             monkeypatch):
    """A certificate that accepts while the chunks are skewed and the true
    gap is far above tol (forced here; under heavy thread switching it
    happens on its own): the verification sweep does not seal the run and
    publishes nothing, so each chunk's logged epochs still run 1, 2, …
    (published, the sweep would move every chunk to one epoch and a chunk
    behind would skip epochs), and the run still seals at the fixed
    point."""
    import dataclasses

    from repro_torch.asyncexec import scheduler as sched_mod
    real = sched_mod.certify_gap
    forced = []

    def early(gaps, epochs, **kw):
        cert = real(gaps, epochs, **kw)
        if not forced and cert.trusted and cert.spread >= 1:
            forced.append(cert)
            return dataclasses.replace(cert, certified_gap=0.0)
        return cert

    monkeypatch.setattr(sched_mod, "certify_gap", early)
    g, act, psi_true = platform
    eng = make_engine(
        "async", graph=g, activity=act, num_chunks=4, tau=2,
        delay_hook=lambda k, e: 0.01 if k == 0 and e <= 6 else 0.0, **CPU)
    res = eng.run(tol=1e-10)
    out = eng.last_run
    assert forced and res.converged and out.sync_sweeps >= 2
    log = eng.sched.step_log
    for k in range(4):
        epochs = [e for c, e, _ in log if c == k]
        assert epochs == list(range(1, len(epochs) + 1)), k
    assert out.total_steps == len(log) + 4 * out.sync_sweeps
    assert np.abs(res.psi.numpy() - psi_true).max() <= 1e-6


def test_straggler_absorption(platform):
    """A permanently slow chunk falls behind instead of stalling every
    epoch, and the answer is still the synchronous fixed point."""
    g, act, psi_true = platform
    eng = make_engine(
        "async", graph=g, activity=act, num_chunks=4, tau=2,
        delay_hook=lambda k, e: 0.02 if k == 0 and e <= 8 else 0.0, **CPU)
    res = eng.run(tol=1e-9)
    assert res.converged
    assert np.abs(res.psi.numpy() - psi_true).max() <= 1e-6
    assert eng.last_run.max_staleness >= 1   # the pipeline actually skewed


def test_async_rejects_accelerate_and_bad_norm():
    with pytest.raises(ValueError, match="Aitken"):
        make_engine("async", accelerate=True, **CPU)
    with pytest.raises(ValueError, match="l1"):
        make_engine("async", criterion=tc.ConvergenceCriterion(norm="l2"),
                    **CPU)


def test_async_service_delta_roundtrip(platform):
    """PsiService over the async backend: warm re-solves through the O(Δ)
    patch hooks stay exact."""
    g, act, _ = platform
    svc = PsiService(g, act, tol=1e-9, backend="async",
                     engine_opts=dict(num_chunks=4, tau=2), **CPU)
    svc.scores()
    u = 9
    svc.update_activity(np.asarray([u]), lam=np.asarray([4.0]))
    lam2 = act.lam.copy()
    lam2[u] = 4.0
    psi_true, _ = exact_psi(g, Activity(lam2, act.mu))
    assert np.abs(svc.scores() - psi_true).max() <= 1e-6


def test_async_engine_patch_edges_including_regrow(platform):
    """Edge patches land in the touched chunks; overflowing a chunk's
    lane-padded e_max regrows the chunk format and stays exact."""
    g, act, _ = platform
    eng = make_engine("async", graph=g, activity=act, num_chunks=4,
                      tau=2, lane_pad=8, **CPU)
    prev = eng.run(tol=1e-9)
    e_max_before = eng.chunked.e_max
    rng = np.random.default_rng(3)
    existing = set(zip(g.src.tolist(), g.dst.tolist()))
    pairs = set()
    while len(pairs) < e_max_before + 16:    # force chunk-0 overflow
        s, d = int(rng.integers(0, g.n)), int(rng.integers(0, eng.chunked.q))
        if s != d and (s, d) not in existing:
            pairs.add((s, d))
    src = np.asarray([p[0] for p in sorted(pairs)], np.int32)
    dst = np.asarray([p[1] for p in sorted(pairs)], np.int32)
    assert eng.patch_edges(src, dst) is True
    assert eng.chunked.e_max > e_max_before
    res = eng.run(tol=1e-9, s0=prev.s)
    g2 = Graph(g.n, np.concatenate([g.src, src]),
               np.concatenate([g.dst, dst])).dedup()
    psi_true, _ = exact_psi(g2, act)
    assert np.abs(res.psi.numpy() - psi_true).max() <= 1e-6
    # an unfollow of two of the new edges: the reference engine on the
    # shrunk graph agrees
    assert eng.unpatch_edges(src[:2], dst[:2]) is True
    res = eng.run(tol=1e-9, s0=res.s)
    ref = make_engine("reference", graph=eng.graph, activity=act,
                      **CPU).run(tol=1e-9)
    assert eng.graph.m == g2.m - 2
    assert np.abs(res.psi.numpy() - ref.psi.numpy()).max() <= 1e-6


def test_midflight_patch_without_drain(platform):
    """An activity patch applied from the epoch callback (pipeline live,
    nothing drained) re-converges to the patched fixed point."""
    g, act, _ = platform
    host = HostOperators.from_graph(g, act)
    chunked = ChunkedOperators(host, 4, **CPU)
    sched = AsyncChunkScheduler(chunked, bound=StalenessBound(2))
    state = {"applied": False}

    def on_epoch(s, min_epoch):
        if min_epoch >= 2 and not state["applied"]:
            state["applied"] = True
            host.patch_activity(np.asarray([7]), lam=np.asarray([6.0]))
            s.patch_node_arrays()

    out = sched.run(tol=1e-11, epoch_callback=on_epoch)
    assert state["applied"] and out.converged
    lam2 = act.lam.copy()
    lam2[7] = 6.0
    psi_true, _ = exact_psi(g, Activity(lam2, act.mu))
    ops2 = HostOperators.from_graph(g, Activity(lam2, act.mu)).to_device(
        **CPU)
    psi = ops2.psi_epilogue(chunked.node_order(out.s)).numpy()
    assert np.abs(psi - psi_true).max() <= 1e-7


# --------------------------------------------------------------------- #
# AsyncPsiDriver: checkpoint/restart with epoch vectors, elastic rechunk,
# straggler forensics
# --------------------------------------------------------------------- #
def test_async_driver_checkpoint_restart(platform):
    g, act, psi_true = platform
    with tempfile.TemporaryDirectory() as d:
        drv = AsyncPsiDriver(g, act, num_chunks=4, tau=1, ckpt_dir=d,
                             ckpt_every=2, **CPU)
        rep = drv.run(tol=1e-7, fail_hook=lambda t: t in (3, 6))
        assert rep.restarts == 2
        assert rep.gap <= 1e-7
        assert np.abs(rep.psi - psi_true).max() <= 1e-6
        # the checkpoint carries the epoch vector (async-exact restart), in
        # the JAX package's format: its reader restores it
        from repro.ckpt import checkpoint as jckpt
        step = jckpt.latest_step(d)
        data = jckpt.restore(
            d, step, dict(s=np.zeros(drv.chunked.n_pad, np.float32),
                          epochs=np.zeros(4, np.int64), it=np.int64(0)))
        assert data["epochs"].shape == (4,)
        assert int(data["epochs"].min()) >= 1


def test_async_driver_rechunk_warm(platform):
    """Elastic re-chunk: the board carries across a chunk-count change and
    the new pipeline resumes warm."""
    g, act, _ = platform
    drv = AsyncPsiDriver(g, act, num_chunks=4, tau=2, **CPU)
    drv.run(tol=1e-3)                        # partial progress
    warm = drv.rechunk(6).run(tol=1e-8)
    cold = AsyncPsiDriver(g, act, num_chunks=6, tau=2, **CPU).run(tol=1e-8)
    assert warm.iterations < cold.iterations
    assert np.abs(warm.psi - cold.psi).max() <= 1e-6


def test_async_driver_slow_chunk_forensics(platform):
    """slow_chunk_events carry the measured duration *and* the deadline it
    exceeded — not just the chunk index."""
    g, act, _ = platform
    drv = AsyncPsiDriver(
        g, act, num_chunks=4, tau=2, deadline_factor=3.0,
        delay_hook=lambda k, e: 0.05 if k == 2 and e >= 5 else 0.0, **CPU)
    rep = drv.run(tol=1e-7)
    assert rep.chunk_durations                 # every step's duration kept
    assert rep.slow_chunk_events
    slow_2 = [e for e in rep.slow_chunk_events if e.chunk == 2]
    assert slow_2 and all(e.duration > e.deadline > 0.0 for e in slow_2)
    assert max(e.duration for e in slow_2) >= 0.05
    assert set(rep.slow_chunks) == {e.chunk for e in rep.slow_chunk_events}
    assert rep.max_staleness >= 1 and rep.tau == 2


def test_async_driver_from_engine_and_metrics(platform):
    """``from_engine`` inherits chunks, τ, dtype and device; a run sets the
    JAX package's gauges and the ``async.step`` spans time each step."""
    g, act, psi_true = platform
    tracer = tobs.Tracer()
    prev = tobs.configure(tracer=tracer)
    try:
        eng = make_engine("async", graph=g, activity=act, num_chunks=3,
                          tau=1, **CPU)
        drv = AsyncPsiDriver.from_engine(eng)
        assert (drv.num_chunks, drv.tau, drv.device) == (3, 1,
                                                          torch.device("cpu"))
        rep = drv.run(tol=1e-8)
        reg = tobs.metrics.get_registry()
        assert reg.value("psi_async_max_staleness") == rep.max_staleness
        assert reg.value("psi_async_overlap_efficiency") == pytest.approx(
            rep.overlap_efficiency)
        assert reg.get("psi_async_epoch_spread") is not None
        steps = [s for s in tracer.spans if s["name"] == "async.step"]
        assert len(steps) == len(rep.chunk_durations)
    finally:
        tobs.restore(prev)
    assert np.abs(rep.psi - psi_true).max() <= 1e-6
    with pytest.raises(ValueError, match="async scheduler"):
        AsyncPsiDriver.from_engine(make_engine("reference", **CPU))


def test_chunk_extrapolator_epoch_guard():
    """Aitken jumps only fire on same-epoch endpoint pairs."""
    def feed(spread):
        ex = ChunkExtrapolator(1e-12)
        for k in range(1, 8):                # clean geometric contraction
            s_in = np.full(4, 1.0 - 0.5 ** (k - 1))
            s_out = np.full(4, 1.0 - 0.5 ** k)
            ex.advance(s_in, s_out, gap=0.5 ** k, epoch_spread=spread)
        return ex.jumps

    assert feed(0) >= 1                      # consistent pairs extrapolate
    assert feed(1) == 0                      # mixed-epoch pairs never jump


def test_chunk_extrapolator_matches_jax():
    """The same jumps and the same extrapolated vectors as JAX's on a
    geometric sequence, torch tensors in and out."""
    from repro.core.engine import ChunkExtrapolator as JCE
    ours, theirs = ChunkExtrapolator(1e-12), JCE(1e-12)
    for k in range(1, 8):
        s_in = np.full(4, 1.0 - 0.6 ** (k - 1))
        s_out = np.full(4, 1.0 - 0.6 ** k)
        a = ours.advance(torch.as_tensor(s_in), torch.as_tensor(s_out),
                         gap=0.6 ** k)
        b = theirs.advance(s_in, s_out, gap=0.6 ** k)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert ours.jumps == theirs.jumps >= 1


# --------------------------------------------------------------------- #
# Mid-flight streaming: StreamIngestor patches land through the
# generation-guarded hooks while chunks are in flight
# --------------------------------------------------------------------- #
def _random_event_log(g, seed: int, count: int = 60):
    """Posts/reposts/follows mixed, monotone timestamps, seeded."""
    from repro_torch.stream import Follow, Post, ReplayLog, Repost
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    for _ in range(count):
        t += float(rng.random())
        kind = int(rng.integers(0, 4))
        if kind < 2:
            events.append(Post(t, int(rng.integers(0, g.n))))
        elif kind == 2:
            events.append(Repost(t, int(rng.integers(0, g.n))))
        else:
            s, d = (int(x) for x in rng.integers(0, g.n, 2))
            if s != d:
                events.append(Follow(t, s, d))
    return ReplayLog.from_events(events)


def test_stream_ingestor_pumps_midflight(platform):
    """Events pumped from the driver's epoch_hook while the pipeline is
    live reach the same fixed point as applying them all up front."""
    from repro_torch.stream import FreshnessPolicy, StreamIngestor
    g, act, _ = platform
    log = _random_event_log(g, seed=77, count=80)
    drv = AsyncPsiDriver(g, act, num_chunks=4, tau=2, **CPU)
    ing = StreamIngestor(drv, half_life=30.0,
                         policy=FreshnessPolicy(coalesce=8,
                                                resolve_every=None))
    ing.attach(log)
    pumped = {"mid": 0}

    def feed(min_epoch):
        pumped["mid"] += ing.pump(8)

    rep = drv.run(tol=1e-10, epoch_hook=feed)
    assert pumped["mid"] > 0                   # patches landed mid-flight
    if not ing.exhausted:                      # converged before the tail
        while ing.pump(64):
            pass
        rep = drv.run(tol=1e-10, warm=True)
    ref = make_engine("reference", graph=drv.host.graph(),
                      activity=drv.host.activity(), **CPU).run(tol=1e-10)
    assert np.abs(rep.psi - ref.psi.numpy()).max() <= 1e-6


# --------------------------------------------------------------------- #
# Property harness: random bounded staleness ≤ τ still reaches the sync
# fixed point; τ-violating assemblies are rejected
# --------------------------------------------------------------------- #
if HAVE_HYPOTHESIS:

    @given(st.integers(0, 9_999), st.integers(1, 3))
    @settings(max_examples=8, deadline=None)
    def test_bounded_stale_partials_reach_sync_fixed_point(seed, tau):
        g = erdos_renyi(60, 240, seed=seed % 100)
        act = heterogeneous(g.n, seed=seed % 97)
        ref = make_engine("reference", graph=g, activity=act,
                          **CPU).run(tol=1e-11)
        rng = np.random.default_rng(seed)

        def lag_hook(reader, neighbor, epochs):
            return int(rng.integers(0, tau + 1))   # random staleness ≤ τ

        eng = make_engine("async", graph=g, activity=act, num_chunks=3,
                          tau=tau, read_hook=lag_hook, **CPU)
        res = eng.run(tol=1e-11)
        assert res.converged
        assert np.abs(res.psi.numpy() - ref.psi.numpy()).max() <= 1e-6

    @given(st.integers(0, 9_999), st.integers(0, 3))
    @settings(max_examples=6, deadline=None)
    def test_midflight_interleave_matches_upfront_fixed_point(seed, tau):
        """Interleaving StreamIngestor patches with AsyncPsiDriver chunks
        at any staleness ≤ τ reaches the same fixed point as applying every
        event up front."""
        from repro_torch.stream import FreshnessPolicy, StreamIngestor
        g = erdos_renyi(48, 200, seed=seed % 37)
        act = heterogeneous(g.n, seed=seed % 29)
        log = _random_event_log(g, seed=seed, count=50)
        rng = np.random.default_rng(seed + 1)

        def lag_hook(reader, neighbor, epochs):
            return int(rng.integers(0, tau + 1))   # random staleness ≤ τ

        drv = AsyncPsiDriver(g, act, num_chunks=3, tau=tau,
                             read_hook=lag_hook, **CPU)
        ing = StreamIngestor(drv, half_life=25.0,
                             policy=FreshnessPolicy(coalesce=8,
                                                    resolve_every=None))
        ing.attach(log)
        rep = drv.run(tol=1e-11, epoch_hook=lambda e: ing.pump(8))
        if not ing.exhausted:
            while ing.pump(64):
                pass
            rep = drv.run(tol=1e-11, warm=True)
        ref = make_engine("reference", graph=drv.host.graph(),
                          activity=drv.host.activity(),
                          **CPU).run(tol=1e-11)
        assert np.abs(rep.psi - ref.psi.numpy()).max() <= 1e-6

    @given(st.integers(0, 3), st.integers(1, 6), st.integers(0, 20))
    @settings(max_examples=20, deadline=None)
    def test_certificate_rejects_any_tau_violation(tau, excess, base_epoch):
        """For every τ, any epoch assembly whose spread exceeds τ is
        rejected; any within-τ assembly is trusted and ρ-inflated."""
        bound = StalenessBound(tau=tau)
        bad = certify_gap(
            [1e-12] * 3, [base_epoch + tau + excess, base_epoch,
                          base_epoch + 1], bound=bound, rho=0.8)
        assert not bad.trusted and not bad.accepts(1.0)
        ok = certify_gap([1e-12] * 3,
                         [base_epoch + tau, base_epoch, base_epoch],
                         bound=bound, rho=0.8)
        assert ok.trusted
        assert ok.certified_gap == pytest.approx(
            3e-12 * 0.8 ** (-float(tau)))


# --------------------------------------------------------------------- #
# The async-driver target of the StreamIngestor (tests/test_stream.py's
# two cases), held against the reference engine and the JAX driver
# --------------------------------------------------------------------- #
def _cold(n):
    from repro_torch.core.activity import RATE_FLOOR
    return Activity(np.full(n, RATE_FLOOR), np.full(n, RATE_FLOOR))


def test_ingest_async_driver_between_runs_parity():
    from repro_torch.stream import (FreshnessPolicy, StreamIngestor,
                                    flash_crowd_stream)
    n, m = 150, 900
    g = powerlaw_configuration(n, m, seed=33)
    truth = heterogeneous(n, seed=34)
    horizon = 800 / float(truth.total.sum())
    log = flash_crowd_stream(g, truth, horizon, new_followers=16, churn=0.5,
                             seed=35)
    drv = AsyncPsiDriver(g, _cold(n), num_chunks=3, tau=1, **CPU)
    ing = StreamIngestor(drv, half_life=horizon / 2,
                         policy=FreshnessPolicy(coalesce=32,
                                                resolve_every=250),
                         resolve_opts=dict(tol=1e-9))
    rep = ing.ingest(log)
    assert rep.resolves >= 2
    psi_batch, _ = exact_psi(drv.host.graph(), drv.host.activity())
    assert np.abs(ing.psi() - psi_batch).max() <= 1e-6


def test_query_driven_first_resolve_updates_freshness_accounting():
    """A query the target can only answer by solving (never resolved yet)
    routes through the ingestor's resolve() so the freshness report
    describes the ranking actually served."""
    from repro_torch.stream import (FreshnessPolicy, StreamIngestor,
                                    poisson_stream)
    g = erdos_renyi(40, 160, seed=42)
    truth = heterogeneous(40, seed=43)
    drv = AsyncPsiDriver(g, _cold(40), num_chunks=3, tau=1, **CPU)
    ing = StreamIngestor(drv, half_life=20.0,
                         policy=FreshnessPolicy(coalesce=8,
                                                resolve_every=None),
                         resolve_opts=dict(tol=1e-9))
    log = poisson_stream(truth, 60 / float(truth.total.sum()), seed=44)
    ing.ingest(log, resolve_at_end=False)
    assert ing.resolves == 0
    ing.top_k(5)                               # no bounds — but never solved
    assert ing.resolves == 1
    rep = ing.freshness()
    assert rep.events_unresolved == 0 and rep.certify(max_events=0)
    before = ing.resolves
    ing.top_k(5, max_events=0)                 # already fresh: no extra run
    assert ing.resolves == before
