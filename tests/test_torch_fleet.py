"""The port's multi-tenant fleet (``repro_torch.serving``) against the JAX
package's (``repro.serving``), on the same seeded numpy inputs, at the JAX
fleet tests' sizes (300–450 nodes). The JAX ``pallas`` regime runs its
kernel in interpret mode; the port's ``cuda`` regime runs on
``device="cpu"``, so its lane-batched wrappers take their plain versions.

Tolerances: ψ within 1e-6 (absolute, ψ ~1e-3) of the JAX fleet's and of
``exact_psi`` (f32 solves to tol 1e-8; the JAX fleet's own tests hold
1e-6 against a solo solve), top-10 identical. The lane-batched plain
kernels against ``jax.vmap`` of the Pallas calls at the JAX package's f32
kernel tolerances: ``s_new`` rtol 2e-5 / atol 2e-6, the gap relative 1e-3,
the bare push rtol / atol 2e-5 (f32 sums in another order).
"""
import argparse
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.graphs as jg
import repro.kernels as jk
import repro.serving as js
import repro_torch.core as tc
import repro_torch.graphs as tg
import repro_torch.serving as ts
from repro.kernels.autotune import bucket_fingerprint as jax_bucket_key
from repro.kernels.autotune import plan_for_bucket as jax_plan_for_bucket
from repro_torch.kernels import autotune
from repro_torch.kernels.edge_spmv import edge_spmv_lanes_call
from repro_torch.kernels.formats import build_edge_tiles, pad_edge_tile_blocks
from repro_torch.kernels.ops import DeviceEdgeTiles
from repro_torch.kernels.power_step import power_step_lanes_call

# port regime ↔ JAX regime
PAIRS = [("dense", "dense"), ("reference", "reference"), ("cuda", "pallas")]
PSI_ATOL = 1e-6


def _graphs(m):
    """The JAX fleet tests' three tenants, from package ``m``."""
    return [m.powerlaw_configuration(300, 1800, seed=1),
            m.erdos_renyi(450, 2500, seed=2),
            m.clustered_blocks(256, 2000, block=64, p_in=0.9, seed=3)]


@pytest.fixture(scope="module")
def platform():
    """(port graphs, JAX graphs, activities as numpy, exact ψ per tenant)."""
    gt, gj = _graphs(tg), _graphs(jg)
    acts = [tc.heterogeneous(g.n, seed=10 + i) for i, g in enumerate(gt)]
    exact = [jc.exact_psi(g, jc.Activity(a.lam, a.mu))[0]
             for g, a in zip(gj, acts)]
    return gt, gj, acts, exact


def _policy(m, **kw):
    kw.setdefault("edge_quantum", 4096)
    return m.BucketPolicy((512,), **kw)


def _port_fleet(backend, **kw):
    kw.setdefault("policy", _policy(ts))
    return ts.TenantFleet(backend=backend, tol=1e-8, device="cpu", **kw)


def _jax_fleet(backend, **kw):
    kw.setdefault("policy", _policy(js))
    return js.TenantFleet(backend=backend, tol=1e-8, **kw)


def _admit(fleet, graphs, acts, act_mod):
    for i, (g, a) in enumerate(zip(graphs, acts)):
        fleet.admit(f"t{i}", g, act_mod.Activity(a.lam, a.mu))


def _top(psi, k=10):
    return np.argsort(-np.asarray(psi, np.float64), kind="stable")[:k]


def _assert_same(psi_port, psi_jax, psi_exact):
    assert psi_port.shape == psi_jax.shape
    assert np.abs(psi_port - psi_jax).max() <= PSI_ATOL
    assert np.abs(psi_port - psi_exact).max() <= PSI_ATOL
    assert np.array_equal(_top(psi_port), _top(psi_exact))


# --------------------------------------------------------------------- #
# Parity: every regime against the JAX fleet and exact_psi
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("port,jax_regime", PAIRS)
def test_fleet_psi_matches_jax_fleet_and_exact(platform, port, jax_regime):
    gt, gj, acts, exact = platform
    fp, fj = _port_fleet(port), _jax_fleet(jax_regime)
    _admit(fp, gt, acts, tc)
    _admit(fj, gj, acts, jc)
    assert fp.solve() == fj.solve() == len(gt)
    for i in range(len(gt)):
        _assert_same(fp.psi(f"t{i}"), fj.psi(f"t{i}"), exact[i])
        st = fp.stats(f"t{i}")
        assert st["converged"] and st["staleness"] == 0
        want = fj.stats(f"t{i}")["spec"]
        assert (st["spec"].n_pad, st["spec"].e_pad) == (want.n_pad,
                                                        want.e_pad)
    assert fp.occupancy()[fp.spec_of("t0")]["regime"] == port


@pytest.mark.parametrize("port", [p for p, _ in PAIRS])
def test_clean_tenant_bitstable_under_neighbour_resolves(platform, port):
    gt, _, acts, _ = platform
    fleet = _port_fleet(port)
    _admit(fleet, gt, acts, tc)
    fleet.solve()
    frozen = {t: fleet.psi(t).copy() for t in ("t0", "t2")}
    for round_ in range(2):
        fleet.patch_activity("t1", np.asarray([5 + round_]),
                             lam=np.asarray([4.0 + round_]))
        assert fleet.solve() == 1
        for t, before in frozen.items():
            assert np.array_equal(before, fleet.psi(t))
    assert fleet.stats("t1")["iterations"] > 0


@pytest.mark.parametrize("port,jax_regime", PAIRS)
def test_patch_activity_parity(platform, port, jax_regime):
    gt, gj, acts, _ = platform
    fp, fj = _port_fleet(port), _jax_fleet(jax_regime)
    _admit(fp, gt, acts, tc)
    _admit(fj, gj, acts, jc)
    fp.solve()
    fj.solve()
    cold = fp.stats("t1")["iterations"]
    for f in (fp, fj):
        f.patch_activity("t1", np.asarray([7]), lam=np.asarray([6.0]))
    lam2 = acts[1].lam.copy()
    lam2[7] = 6.0
    psi_true, _ = jc.exact_psi(gj[1], jc.Activity(lam2, acts[1].mu))
    _assert_same(fp.psi("t1"), fj.psi("t1"), psi_true)
    assert fp.stats("t1")["iterations"] < cold          # warm restart


@pytest.mark.parametrize("port,jax_regime", PAIRS)
def test_patch_edges_parity(platform, port, jax_regime):
    gt, gj, acts, _ = platform
    fp, fj = _port_fleet(port), _jax_fleet(jax_regime)
    fp.admit("t0", gt[0], acts[0])
    fj.admit("t0", gj[0], jc.Activity(acts[0].lam, acts[0].mu))
    fp.solve()
    fj.solve()
    src = np.asarray([0, 1, 2], np.int32)
    dst = np.asarray([50, 60, 70], np.int32)
    for f in (fp, fj):
        f.patch_edges("t0", src, dst)
    g2 = jg.Graph(gj[0].n, np.concatenate([gj[0].src, src]),
                  np.concatenate([gj[0].dst, dst])).dedup()
    psi_true, _ = jc.exact_psi(g2, jc.Activity(acts[0].lam, acts[0].mu))
    _assert_same(fp.psi("t0"), fj.psi("t0"), psi_true)
    assert fp.stats("t0")["rebuckets"] == 0


def _new_edges(g, count, n, seed):
    rng = np.random.default_rng(seed)
    have = set(zip(g.src.tolist(), g.dst.tolist()))
    ns, nd = [], []
    while len(ns) < count:
        s_, d_ = (int(x) for x in rng.integers(0, n, 2))
        if s_ != d_ and (s_, d_) not in have:
            have.add((s_, d_))
            ns.append(s_)
            nd.append(d_)
    return np.asarray(ns, np.int32), np.asarray(nd, np.int32)


@pytest.mark.parametrize("port,jax_regime", PAIRS)
def test_warm_start_survives_rebucket(port, jax_regime):
    gt, gj = tg.erdos_renyi(200, 900, seed=5), jg.erdos_renyi(200, 900,
                                                             seed=5)
    act = tc.heterogeneous(200, seed=6)
    fleets = [ts.TenantFleet(backend=port, tol=1e-8, device="cpu",
                             policy=ts.BucketPolicy((256,),
                                                    edge_quantum=1024)),
              js.TenantFleet(backend=jax_regime, tol=1e-8,
                             policy=js.BucketPolicy((256,),
                                                    edge_quantum=1024))]
    fleets[0].admit("a", gt, act)
    fleets[1].admit("a", gj, jc.Activity(act.lam, act.mu))
    for f in fleets:
        f.solve()
    cold = fleets[0].stats("a")["iterations"]
    assert fleets[0].spec_of("a") == ts.BucketSpec(256, 1024)
    ns, nd = _new_edges(gt, 200, 200, 0)           # m past e_pad = 1024
    for f in fleets:
        f.patch_edges("a", ns, nd)
    st = fleets[0].stats("a")
    assert st["rebuckets"] == 1 and st["spec"] == ts.BucketSpec(256, 2048)
    g2 = jg.Graph(200, np.concatenate([gj.src, ns]),
                  np.concatenate([gj.dst, nd])).dedup()
    psi_true, _ = jc.exact_psi(g2, jc.Activity(act.lam, act.mu))
    _assert_same(fleets[0].psi("a"), fleets[1].psi("a"), psi_true)
    assert fleets[0].stats("a")["iterations"] < cold


def test_block_growth_escalation_preserves_lanes():
    """Edge growth past the cuda regime's block capacity (not its edge
    capacity) restacks the bucket: the clean co-tenant comes back bitwise,
    the grown tenant warm and equal to the JAX fleet's and exact ψ."""
    ga, gb = tg.erdos_renyi(200, 2000, seed=8), tg.erdos_renyi(220, 2000,
                                                               seed=9)
    act_a, act_b = tc.heterogeneous(200, seed=10), tc.heterogeneous(220,
                                                                    seed=11)
    kw = dict(tol=1e-8, tile=256, e1=8, e2=128)
    fp = ts.TenantFleet(backend="cuda", device="cpu",
                        policy=ts.BucketPolicy((256,), edge_quantum=8192),
                        **kw)
    fj = js.TenantFleet(backend="pallas",
                        policy=js.BucketPolicy((256,), edge_quantum=8192),
                        **kw)
    for f, m, graphs in ((fp, tc, (ga, gb)),
                         (fj, jc, (jg.erdos_renyi(200, 2000, seed=8),
                                   jg.erdos_renyi(220, 2000, seed=9)))):
        f.admit("a", graphs[0], m.Activity(act_a.lam, act_a.mu))
        f.admit("b", graphs[1], m.Activity(act_b.lam, act_b.mu))
        f.solve()
    cold = fp.stats("a")["iterations"]
    psi_b = fp.psi("b").copy()
    bucket = fp._buckets[fp.spec_of("a")]
    nb_before = bucket.nb
    ns, nd = _new_edges(ga, nb_before * 1024 - ga.m + 64, 200, 1)
    for f in (fp, fj):
        f.patch_edges("a", ns, nd)
    assert fp.stats("a")["rebuckets"] == 0          # same bucket, more blocks
    fp.solve()
    assert bucket.nb > nb_before
    g2 = jg.Graph(200, np.concatenate([ga.src, ns]),
                  np.concatenate([ga.dst, nd])).dedup()
    psi_true, _ = jc.exact_psi(g2, jc.Activity(act_a.lam, act_a.mu))
    _assert_same(fp.psi("a"), fj.psi("a"), psi_true)
    assert fp.stats("a")["iterations"] < cold        # warm state survived
    assert np.array_equal(psi_b, fp.psi("b"))         # clean lane untouched


@pytest.mark.parametrize("port", [p for p, _ in PAIRS])
def test_invalidate_keeps_pending_patches(platform, port):
    gt, gj, acts, _ = platform
    fleet = _port_fleet(port)
    fleet.admit("a", gt[0], acts[0])
    fleet.solve()
    fleet.patch_activity("a", np.asarray([7]), lam=np.asarray([6.0]))
    fleet.invalidate()
    fleet.solve()
    lam2 = acts[0].lam.copy()
    lam2[7] = 6.0
    psi_true, _ = jc.exact_psi(gj[0], jc.Activity(lam2, acts[0].mu))
    assert np.abs(fleet.psi("a") - psi_true).max() <= PSI_ATOL


def test_admit_with_warm_s0_and_lifecycle(platform):
    gt, _, acts, exact = platform
    res = tc.make_engine("reference", graph=gt[0], activity=acts[0],
                         device="cpu").run(tol=1e-8)
    fleet = _port_fleet("reference")
    fleet.admit("warm", gt[0], acts[0], s0=res.s)
    fleet.admit("cold", gt[0], acts[0])
    fleet.solve()
    assert fleet.stats("warm")["iterations"] < \
        fleet.stats("cold")["iterations"]
    with pytest.raises(ValueError, match="already admitted"):
        fleet.admit("cold", gt[0], acts[0])
    psi = fleet.evict("warm")
    assert psi.shape == (gt[0].n,) and fleet.tenant_ids == ("cold",)
    with pytest.raises(KeyError, match="unknown tenant"):
        fleet.psi("warm")
    assert np.abs(fleet.psi("cold") - exact[0]).max() <= PSI_ATOL


def test_fleet_backends_and_device():
    with pytest.raises(ValueError, match="unknown fleet backend"):
        ts.TenantFleet(backend="bsr", device="cpu")
    with pytest.raises(ValueError, match="l1"):
        ts.TenantFleet(backend="cuda", norm="l2", device="cpu")
    assert ts.TenantFleet(backend="pallas", device="cpu").backend == "cuda"
    # auto: dense up to dense_max_n, then reference on the CPU
    fleet = ts.TenantFleet(device="cpu", dense_max_n=256)
    assert fleet._regime_for(ts.BucketSpec(256, 1024)) == "dense"
    assert fleet._regime_for(ts.BucketSpec(512, 1024)) == "reference"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ts.TenantFleet()                      # device="cuda" by default
    else:
        assert ts.TenantFleet()._regime_for(
            ts.BucketSpec(4096, 16384)) == "cuda"


# --------------------------------------------------------------------- #
# The batched loop, the bucket policy and the bucket plan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("check_every", [1, 3])
def test_batched_loop_counts_match_solo_loop(platform, check_every):
    """Every lane's count equals the solo engine's on its own graph, at
    the same check_every (f64, so no count sits on a rounding tie)."""
    gt, _, acts, _ = platform
    fleet = ts.TenantFleet(backend="reference", tol=1e-10, device="cpu",
                           dtype=torch.float64, check_every=check_every,
                           policy=_policy(ts))
    _admit(fleet, gt, acts, tc)
    fleet.solve()
    for i, (g, a) in enumerate(zip(gt, acts)):
        solo = tc.make_engine("reference", graph=g.dedup(), activity=a,
                              device="cpu", dtype=torch.float64,
                              check_every=check_every).run(tol=1e-10)
        t = fleet.stats(f"t{i}")["iterations"]
        assert t == solo.iterations and t % check_every == 0


def test_batched_loop_freezes_converged_lane():
    """A lane frozen at its count does not move by a bit while its
    neighbour keeps stepping; an inactive lane never moves (f64: an f32
    lane lands on an exact fixed point, where a frozen and a stepped lane
    agree anyway)."""
    g_fast = tg.erdos_renyi(200, 600, seed=4)
    g_slow = tg.powerlaw_configuration(200, 1600, seed=5)
    act = tc.heterogeneous(200, seed=6)
    fleet = ts.TenantFleet(backend="reference", tol=1e-10, device="cpu",
                           dtype=torch.float64,
                           policy=ts.BucketPolicy((256,), edge_quantum=2048))
    fleet.admit("fast", g_fast, act)
    fleet.admit("slow", g_slow, act)
    fleet.solve()
    t = [fleet.stats(k)["iterations"] for k in ("fast", "slow")]
    assert t[0] != t[1]
    bucket = fleet._buckets[fleet.spec_of("fast")]
    loop = tc.make_batched_loop(tc.make_lane_reference_step("l1"))
    s0 = fleet._cold_state(bucket)
    tol = torch.tensor(1e-10, dtype=torch.float64)
    on = torch.ones(2, dtype=torch.bool)
    short = loop(bucket.args, s0, bucket.scale, tol, min(t), on)
    full = loop(bucket.args, s0, bucket.scale, tol, 10_000, on)
    lane = int(np.argmin(t))
    assert torch.equal(short[0][lane], full[0][lane])
    assert not torch.equal(short[0][1 - lane], full[0][1 - lane])
    assert full[2].tolist() == t
    off = loop(bucket.args, s0, bucket.scale, tol, 10_000,
               torch.tensor([True, False]))
    assert torch.equal(off[0][1], s0[1]) and int(off[2][1]) == 0


def test_bucket_policy_matches_jax():
    pairs = [(ts.BucketPolicy(), js.BucketPolicy()),
             (ts.BucketPolicy((256, 1024), edge_quantum=1024,
                              edge_growth=1.5, lane_quantum=4),
              js.BucketPolicy((256, 1024), edge_quantum=1024,
                              edge_growth=1.5, lane_quantum=4)),
             (ts.BucketPolicy.from_spec("512, 2048"),
              js.BucketPolicy.from_spec("512, 2048"))]
    grid = [(n, m) for n in (1, 200, 256, 257, 1024, 5000, 70_000, 300_000)
            for m in (0, 1, 1000, 1025, 16_385, 817_035, 3_000_000)]
    for p, q in pairs:
        for n, m in grid:
            a, b = p.bucket_for(n, m), q.bucket_for(n, m)
            assert (a.n_pad, a.e_pad) == (b.n_pad, b.e_pad)
            assert p.needs_rebucket(a, n, m + 5000) == \
                q.needs_rebucket(b, n, m + 5000)
        for count in (0, 1, 3, 5, 9):
            assert p.lanes_padded(count) == q.lanes_padded(count)
        tenants = [(200, 900), (250, 1000)]
        spec = p.bucket_for(250, 1000)
        assert p.occupancy(spec, tenants) == q.occupancy(
            js.BucketSpec(spec.n_pad, spec.e_pad), tenants)
    with pytest.raises(ValueError, match="ascending"):
        ts.BucketPolicy((512, 256))


@pytest.mark.parametrize("gname", ["powerlaw", "er", "clustered"])
@pytest.mark.parametrize("n_pad,e_pad", [(512, 4096), (1024, 16384),
                                         (4096, 16384)])
def test_plan_for_bucket_matches_jax(gname, n_pad, e_pad):
    make = {"powerlaw": lambda m: m.powerlaw_configuration(300, 1800, seed=1),
            "er": lambda m: m.erdos_renyi(450, 2500, seed=2),
            "clustered": lambda m: m.clustered_blocks(256, 2000, block=64,
                                                      p_in=0.9, seed=3)}
    got = autotune.plan_for_bucket(make[gname](tg), n_pad=n_pad,
                                   e_pad=e_pad, device="cpu", cache=None,
                                   calibration=None)
    want = jax_plan_for_bucket(make[gname](jg), n_pad=n_pad, e_pad=e_pad,
                               cache=None, calibration=None)
    assert got.label() == want.label() and got.params() == want.params()
    assert got.est_bytes == want.est_bytes and got.source == want.source
    extra = (False, tuple(autotune.EDGE_TILE_CANDIDATES))
    assert autotune.bucket_fingerprint(n_pad, e_pad, extra=extra) == \
        jax_bucket_key(n_pad, e_pad, extra=extra)


def test_bucket_plan_shared_across_tenants(platform):
    gt, _, acts, _ = platform
    cache = autotune.PlanCache()
    fleet = _port_fleet("cuda", plan_cache=cache)
    _admit(fleet, gt, acts, tc)
    fleet.solve()
    assert cache.misses == 1                  # one plan for the one bucket
    fleet.patch_activity("t0", np.asarray([1]), lam=np.asarray([2.0]))
    fleet.solve()
    assert cache.misses == 1                  # patches never re-plan


# --------------------------------------------------------------------- #
# The frontier and the single-tenant view
# --------------------------------------------------------------------- #
def test_frontier_scores_batch_and_global_top_k(platform):
    gt, gj, acts, _ = platform
    fp, fj = _port_fleet("dense"), _jax_fleet("dense")
    _admit(fp, gt, acts, tc)
    _admit(fj, gj, acts, jc)
    ids = ["t0", "t1", "t0", "t2"]
    users = np.asarray([3, 4, 5, 6])
    got = fp.frontier.scores_batch(ids, users)
    np.testing.assert_allclose(got, [fp.psi(t)[u] for t, u in zip(ids,
                                                                   users)],
                               rtol=0, atol=0)
    np.testing.assert_allclose(got, fj.frontier.scores_batch(ids, users),
                               rtol=0, atol=PSI_ATOL)
    with pytest.raises(ValueError, match="align"):
        fp.frontier.scores_batch(["t0"], np.asarray([1, 2]))
    top = fp.frontier.global_top_k(5)
    assert [(t, u) for t, u, _ in top] == \
        [(t, u) for t, u, _ in fj.frontier.global_top_k(5)]
    scores = [s for _, _, s in top]
    assert scores == sorted(scores, reverse=True)
    assert fp.frontier.staleness("t0") == 0
    fp.patch_activity("t0", np.asarray([1]), lam=np.asarray([2.0]))
    assert fp.frontier.staleness("t0") == 1 and fp.frontier.epoch("t0") == 1
    idx, _ = fp.frontier.top_k("t0", 3)
    assert fp.frontier.staleness("t0") == 0
    assert fp.frontier.rank_of("t0", idx[:1])[0] == 0


def test_psi_service_from_fleet_view(platform):
    gt, gj, acts, exact = platform
    fleet = _port_fleet("cuda")
    _admit(fleet, gt, acts, tc)
    view = tc.PsiService.from_fleet(fleet, "t2")
    assert view.backend == "fleet[cuda]"
    assert np.abs(view.scores() - exact[2]).max() <= PSI_ATOL
    view.update_activity(np.asarray([4]), lam=np.asarray([5.0]))
    assert view.stale
    lam2 = acts[2].lam.copy()
    lam2[4] = 5.0
    psi_true, _ = jc.exact_psi(gj[2], jc.Activity(lam2, acts[2].mu))
    assert np.abs(view.scores() - psi_true).max() <= PSI_ATOL
    assert view.last_iterations() > 0 and view.graph.n == gt[2].n


# --------------------------------------------------------------------- #
# The lane-batched plain kernels against jax.vmap of the Pallas calls
# --------------------------------------------------------------------- #
def _lane_inputs(tile):
    """Three tenants' formats on one bucket (n_pad 512, sentinel n_pad),
    padded to one block count, and seeded f32 vectors; one lane is all
    padding."""
    n_pad, e1, e2 = 512, 8, 128
    graphs = [(m.powerlaw_configuration(300, 1800, seed=1),
               m.erdos_renyi(450, 2500, seed=2)) for m in (tg, jg)]
    empty = np.empty(0, np.int32)
    fmts = [[build(mod.Graph(n_pad, *g.edges_by_dst), tile=tile, e1=e1,
                   e2=e2) for g in gs]
            + [build(mod.Graph(n_pad, empty, empty), tile=tile, e1=e1,
                     e2=e2)]
            for build, mod, gs in ((build_edge_tiles, tg, graphs[0]),
                                   (jk.build_edge_tiles, jg, graphs[1]))]
    nb = max(f.num_blocks for f in fmts[0])
    port = [pad_edge_tile_blocks(f, nb) for f in fmts[0]]
    jaxf = [jk.formats.pad_edge_tile_blocks(f, nb) for f in fmts[1]]
    rng = np.random.default_rng(tile)
    s, mu, c, inv_w = (rng.uniform(size=(3, n_pad)).astype(np.float32)
                       for _ in range(4))
    for v in (s, mu, c, inv_w):
        v[2] = 0.0
    return port, jaxf, s, mu, c, inv_w


def _jax_lanes(fmts):
    """The JAX formats stacked along a lane axis, as the JAX fleet does."""
    dev = [jk.DeviceEdgeTiles.from_format(f) for f in fmts]
    data = {k: jnp.stack([getattr(d, k) for d in dev])
            for k in ("src_idx", "dst_local", "block_tile", "block_first",
                      "block_last")}
    return dev[0], data


@pytest.mark.parametrize("tile", [128, 256])
def test_power_step_lanes_plain_matches_vmapped_pallas(tile):
    from repro.kernels.power_step import power_step_call
    port, jaxf, s, mu, c, inv_w = _lane_inputs(tile)
    fmt = DeviceEdgeTiles.stack(port, "cpu")
    s_pre = fmt.pad_gather_source(torch.as_tensor(s * inv_w))
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks,
            *(fmt.pad_node_vector(torch.as_tensor(v)) for v in (mu, c, s)))
    s_new, gap = power_step_lanes_call(*args, n=fmt.n, tile=tile)
    ref, data = _jax_lanes(jaxf)
    pad = ref.n_gather - s.shape[1]
    s_pre_j = jnp.pad(jnp.asarray(s * inv_w), ((0, 0), (0, pad)))[:, None]

    def one(sp, si, dl, bt, bf, bl, m, cc, so):
        return power_step_call(sp, si, dl, bt, bf, bl, m, cc, so, tile=tile,
                               e1=ref.e1, e2=ref.e2,
                               num_tiles=ref.num_tiles, interpret=True)

    vec = [jnp.asarray(v)[:, None] for v in (mu, c, s)]
    s_j, gap_j = jax.vmap(one)(s_pre_j, data["src_idx"], data["dst_local"],
                               data["block_tile"], data["block_first"],
                               data["block_last"], *vec)
    np.testing.assert_allclose(s_new.numpy(), np.asarray(s_j), rtol=2e-5,
                               atol=2e-6)
    gap_j = np.asarray(gap_j).reshape(-1)
    np.testing.assert_allclose(gap.numpy()[:2], gap_j[:2], rtol=1e-3)
    assert float(gap[2]) == 0.0 and not s_new[2].any()


@pytest.mark.parametrize("tile", [128, 256])
def test_edge_spmv_lanes_plain_matches_vmapped_pallas(tile):
    from repro.kernels.edge_spmv import edge_spmv_call
    port, jaxf, s, _, _, inv_w = _lane_inputs(tile)
    fmt = DeviceEdgeTiles.stack(port, "cpu")
    out = edge_spmv_lanes_call(
        fmt.pad_gather_source(torch.as_tensor(s * inv_w)), fmt.src_idx,
        fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
        fmt.tile_num_blocks, n=fmt.n, tile=tile)
    ref, data = _jax_lanes(jaxf)
    pad = ref.n_gather - s.shape[1]
    s_pre_j = jnp.pad(jnp.asarray(s * inv_w), ((0, 0), (0, pad)))[:, None]

    def one(sp, si, dl, bt, bf):
        return edge_spmv_call(sp, si, dl, bt, bf, None, tile=tile,
                              e1=ref.e1, e2=ref.e2, num_tiles=ref.num_tiles,
                              interpret=True)

    out_j = jax.vmap(one)(s_pre_j, data["src_idx"], data["dst_local"],
                          data["block_tile"], data["block_first"])
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=2e-5,
                               atol=2e-5)
    assert not out[2].any()


def test_lane_wrappers_reject_unstacked_or_oversized_lanes():
    """The lane kernels' shape check (it runs before a CUDA launch): every
    tensor needs the same leading lane axis, and the lanes' tiles and
    blocks must fit 32-bit indices."""
    from repro_torch.kernels.edge_spmv import check_lanes
    ok = dict(s_pre=torch.zeros(2, 1, 9), src_idx=torch.zeros(2, 3, 1, 32),
              tile_first_block=torch.zeros(2, 4))
    check_lanes("k", 2, **ok)
    with pytest.raises(ValueError, match="leading \\[2\\] lane axis"):
        check_lanes("k", 2, **{**ok, "s_pre": torch.zeros(3, 1, 9)})
    with pytest.raises(ValueError, match="contiguous"):
        check_lanes("k", 2, **{**ok, "tile_first_block":
                               torch.zeros(4, 2).t()})
    with pytest.raises(ValueError, match="65535 lanes"):     # no memory
        check_lanes("k", 2, **{**ok, "tile_first_block":
                               torch.empty(2, 2 ** 30, device="meta")})


# --------------------------------------------------------------------- #
# serve --tenants
# --------------------------------------------------------------------- #
def _fleet_top(text: str) -> list[str]:
    line = next(ln for ln in text.splitlines() if "fleet-wide top-" in ln)
    return [item.split("@")[0] for item in line.split(": ", 1)[1].split(", ")]


def test_serve_tenants_prints_the_jax_clis_fleet_top():
    from repro.launch.serve import _serve_fleet
    from repro_torch.launch.serve import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--arch", "psi-score", "--tenants", "4", "--device", "cpu"])
    port = out.getvalue()
    args = argparse.Namespace(bucket_sizes=None, backend=None,
                              accelerate=False, check_every=1,
                              microbench=False, tenants=4, requests=4,
                              batch=4, top_k=3)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _serve_fleet(args)
    top = _fleet_top(port)
    assert len(top) == 3 and top == _fleet_top(out.getvalue())
    assert "regime=dense" in port and "regime=reference" in port
    with pytest.raises(SystemExit, match="accelerate"):
        main(["--arch", "psi-score", "--tenants", "2", "--device", "cpu",
              "--accelerate"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solo_cuda_psi_equals_one_tenant_fleet_lane(dtype):
    """The solo ``cuda`` engine's ``edge_tile`` ψ epilogue is the fleet's
    (``edge_spmv``, then · 1/n rounded once): a one-tenant fleet lane and a
    solo engine at the lane's plan give s, the gap, the count and ψ bit for
    bit, on the CPU's plain versions as on the card
    (``tests/test_torch_cuda.py``)."""
    g = tg.powerlaw_configuration(3000, 20000, seed=4)
    act = tc.heterogeneous(g.n, seed=5)
    fleet = ts.TenantFleet(backend="cuda", tol=1e-8, device="cpu",
                           dtype=dtype)
    fleet.admit("t", g, act)
    fleet.solve()
    assert fleet.occupancy()[fleet.spec_of("t")]["regime"] == "cuda"
    plan = fleet._buckets[fleet.spec_of("t")].plan
    eng = tc.make_engine("cuda", graph=g, activity=act, device="cpu",
                         dtype=dtype, tile=plan.tile, e1=plan.e1, e2=plan.e2)
    res = eng.run(tol=1e-8)
    st = fleet.stats("t")
    assert res.iterations == st["iterations"] and res.gap == st["gap"]
    assert np.array_equal(res.s.numpy(), fleet.series("t"))
    assert np.array_equal(res.psi.numpy(), fleet.psi("t"))
    assert torch.equal(eng.epilogue(res.s), res.psi)
