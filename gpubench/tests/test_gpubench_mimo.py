"""The ``mimo.decode`` cell at a CPU size: whole runs, the control, faults
in the timed path (of every row, and of one session or one step), the
entry's request and rewind, its byte and FLOP counts against a hand count,
and each new reader."""
import dataclasses
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench import devtrace, harness, lmspans
from gpubench.tests.tiny import REPO, tiny_root

CPU = torch.device("cpu")
CELL = "mimo.decode"
SEED = 2**31 + 77
#: the configuration's widths cut to the port's reduced MiMo (every key of
#: the published config kept; experts held 4 of a 16-wide router)
TINY = dict(hidden_size=64, num_attention_heads=8, head_dim=24,
            v_head_dim=16, num_key_value_heads=2, swa_num_key_value_heads=4,
            sliding_window=8, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=4, num_experts_per_tok=4, vocab_size=256)


def mimo_root(tmp, dtype="float32"):
    root = tiny_root(tmp)
    path = root / "gpubench" / "configs" / "mimo-v2-flash-ep16.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY, dtype=dtype)
    cfg["cut"]["router_outputs"] = 16
    cfg["inputs"].update(sessions=3, history_min=20, history_max=60,
                         turn_tokens=4)
    path.write_text(json.dumps(cfg))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return mimo_root(tmp_path_factory.mktemp("mimo"))


def _run(root, **kw):
    return harness.run_cell(harness.Bench(root, CELL), SEED, 0.2,
                            kw.pop("trace", False), CPU, **kw)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct_and_reports_the_cells_metrics(root, trace):
    result = _run(root, trace=trace)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["check"]) == {"logits_rel", "logits_linf_rel",
                                    "route_gap"}
    names = set(result["metrics"])
    if trace:
        # no peaks and no device trace on the CPU: the roofline, MFU and
        # idle readers stay silent
        assert names == {"decode_step_ms", "full_attn_ms", "window_attn_ms",
                         "moe_ms", "prefill_s"}
    else:
        assert names == {"rank_ms", "rank_p95_ms", "setup_s"}


def test_the_control_in_the_programs_place_is_not_correct(root):
    result = _run(root, control=True)
    assert result["correct"] is False
    assert all(c["value"] > c["limit"] for c in result["check"].values())


def _no_sink(monkeypatch):
    from repro_torch.models.transformer import hybrid
    extra = hybrid._attn_extra
    monkeypatch.setattr(hybrid, "_attn_extra",
                        lambda *a: dict(extra(*a), sink=None))


def _rings_not_restored(monkeypatch):
    """The rewind takes the positions back but leaves the rings as the
    turn left them."""
    from repro_torch.models.transformer import hybrid
    monkeypatch.setattr(hybrid, "rewind",
                        lambda cache, snap, steps: cache["t"].copy_(snap["t"]))


def _full_theta(monkeypatch):
    """The window layers' RoPE θ on the full layers too."""
    from repro_torch.models.transformer import hybrid
    qkv = hybrid._qkv

    def wrong(h, ap, a, kind, positions, cfg):
        return qkv(h, ap, a, dataclasses.replace(kind, rope_theta=1e4),
                   positions, cfg)

    monkeypatch.setattr(hybrid, "_qkv", wrong)


@pytest.mark.parametrize("fault", [_no_sink, _rings_not_restored,
                                   _full_theta])
def test_a_fault_in_the_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(root)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["check"].values())


def _one_session_ring(monkeypatch, inputs):
    """The rewind restores one kept session's ring one slot short: the
    slot of the turn's last position keeps what the turn wrote."""
    from repro_torch.models.transformer import hybrid
    rewind, r = hybrid.rewind, int(inputs["kept"][1])

    def wrong(cache, snap, steps):
        left = {}
        for name, ring in snap["rings"].items():
            slot = int(snap["t"][r] + steps - 1) % ring["pos"].shape[1]
            left[name] = (slot, cache[name]["k"][:, r, :, slot].clone(),
                          cache[name]["v"][:, r, :, slot].clone(),
                          cache[name]["pos"][r, slot].clone())
        rewind(cache, snap, steps)
        for name, (slot, k, v, pos) in left.items():
            cache[name]["k"][:, r, :, slot] = k
            cache[name]["v"][:, r, :, slot] = v
            cache[name]["pos"][r, slot] = pos
        return cache

    monkeypatch.setattr(hybrid, "rewind", wrong)


def _last_step_behind(monkeypatch, inputs):
    """Each turn's last step decodes at its predecessor's position."""
    from repro_torch.models.transformer import hybrid
    make, turn = hybrid.make_decode_step, int(inputs["turn"])

    def wrong(cfg):
        decode, calls = make(cfg), itertools.count(1)

        def step(params, cache, token, routes=None):
            if next(calls) % turn == 0:
                cache["t"].sub_(1)
            return decode(params, cache, token, routes)

        return step

    monkeypatch.setattr(hybrid, "make_decode_step", wrong)


def _row_errors(bench, inputs):
    """Each kept row's relative L2 error in the second request (the first
    after a rewind), against the reference."""
    system = bench.entry.build(bench.cfg, bench.traffic, inputs, CPU)
    for _ in range(2):
        served = bench.entry.complete(system, bench.entry.request(
            system, bench.cfg, bench.traffic, None, harness.Phases()))
    ref = bench.entry.reference(bench.cfg, inputs, CPU,
                                harness.precision(bench.cfg["reference"]))
    return bench.entry.rows(served, ref)["rel"].ravel()


@pytest.mark.parametrize("fault", [_one_session_ring, _last_step_behind])
def test_a_fault_in_one_session_or_one_step_is_not_correct(root, monkeypatch,
                                                            fault):
    """A fault that reaches half of the kept rows or fewer (one session's
    steps from the first it reaches, or one step of each session): the
    other rows stay within the limit, the worst row does not, and the run
    is not correct."""
    bench = harness.Bench(root, CELL)
    inputs = bench.gen.generate(bench.cfg["inputs"], SEED, CPU)
    fault(monkeypatch, inputs)
    rel = _row_errors(bench, inputs)
    limit = bench.cfg["limits"]["logits_rel"]
    assert np.count_nonzero(rel <= limit) >= rel.size / 2
    assert rel.max() > limit
    result = _run(root)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["check"].values())


def test_the_judge_leaves_out_only_rows_sent_to_another_held_expert(root):
    """Two sessions × two steps, two routed layers over 4 experts, top 2,
    expert 0 held. A row whose token a layer sent to another held expert
    at a near tie of the reference's scores is left out of the logits'
    worst; a near tie among experts held elsewhere, or none, leaves the
    row in; the gap is read at a token's first departing layer."""
    entry = harness.Bench(root, CELL).entry
    want = np.ones((2, 2, 8))
    # layer 0 picks {0, 1}, expert 2 0.0005 behind 1; layer 1 picks
    # {1, 0}, expert 2 0.0005 behind 0
    select = np.tile([[0.9, 0.5, 0.4995, 0.1], [0.5, 0.9, 0.4995, 0.1]],
                     (2, 2, 1, 1))
    same = np.tile([[0, 1], [1, 0]], (2, 2, 1, 1))
    ref = [dict(logits=want[i], pick=same[i], select=select[i], held=(0, 1))
           for i in range(2)]
    bad = want.copy()
    bad[1, 0] *= 1.5                          # one row off by half
    elsewhere = same.copy()
    elsewhere[1, 0, 0] = [0, 2]               # 1 ↔ 2, neither held here
    held = same.copy()
    held[1, 0, 1] = [1, 2]                    # 0 ↔ 2: the held expert
    first = same.copy()
    first[0, 1] = [[0, 2], [1, 3]]            # near at layer 0, then far

    def judge(logits, routes):
        return entry.numbers(entry.Served(tokens=None, logits=logits,
                                          routes=routes), ref, None, None)

    assert judge(want, same) == dict(logits_rel=0.0, logits_linf_rel=0.0,
                                     route_gap=0.0)
    assert judge(bad, same)["logits_rel"] == pytest.approx(0.5)
    got = judge(bad, elsewhere)
    assert got["logits_rel"] == pytest.approx(0.5)
    assert got["route_gap"] == pytest.approx(0.00025)
    got = judge(bad, held)
    assert got["logits_rel"] == 0.0
    assert got["route_gap"] == pytest.approx(0.00025)
    assert judge(want, first)["route_gap"] == pytest.approx(0.00025)
    far = same.copy()
    far[0, 1, 0] = [0, 3]                     # 0.2 apart at layer 0
    assert judge(want, far)["route_gap"] == pytest.approx(0.2)
    everywhere = same.copy()
    everywhere[..., 1, :] = [1, 2]
    assert judge(want, everywhere)["logits_rel"] == float("inf")
    assert judge(want[:, :1], same)["logits_rel"] == float("inf")


def test_requests_are_the_same_work_after_the_rewind(root):
    bench = harness.Bench(root, CELL)
    inputs = bench.gen.generate(bench.cfg["inputs"], SEED, CPU)
    system = bench.entry.build(bench.cfg, bench.traffic, inputs, CPU)
    t0 = system.cache["t"].clone()
    ring = system.cache["window"]["k"].clone()
    phase = harness.Phases()
    a = bench.entry.complete(system, bench.entry.request(
        system, bench.cfg, bench.traffic, None, phase))
    assert torch.equal(system.cache["t"], t0)
    assert torch.equal(system.cache["window"]["k"], ring)
    b = bench.entry.complete(system, bench.entry.request(
        system, bench.cfg, bench.traffic, None, phase))
    assert a.tokens.shape == (4, 3) and np.array_equal(a.tokens, b.tokens)
    assert a.logits.shape == (2, 4, 256)
    assert np.array_equal(a.logits, b.logits)
    assert inputs["kept"][0] == int(np.argmax(inputs["lengths"]))
    assert [r[0] for r in phase.records] == ["decode", "decode"]


def test_work_bytes_and_flops_against_a_hand_count(root):
    bench = harness.Bench(root, CELL)
    spec = bench.gen.spec_of(bench.cfg)
    inputs = dict(spec=spec, held=(0, 4), lengths=[10, 3], turn=2)
    work = bench.entry.work_bytes(bench.cfg, inputs)
    # weights a step, in bf16 elements: full attention 25,600 + window
    # 30,720 (+ 8 f32 sinks = 16) + 2 norms of 64 a layer; dense FFN
    # 18,432; routed 4 held × 6,144 + router 1,024 (+ 16 f32 bias = 32);
    # head 16,384, final norm 64, the batch's 2 embedding rows 128
    weights = 2 * (25600 + 128) + 5 * (30720 + 16 + 128) + 18432 + \
        6 * (24576 + 1024 + 32) + 16384 + 64 + 128
    # keys and values: full slots 160 B (2 heads × 40 × 2), contexts
    # 11, 12, 4, 5 read + 4 written, 2 layers; window slots 320 B, contexts
    # 8, 8, 4, 5 + 4 written, 5 layers
    kv = 2 * 36 * 160 + 5 * 29 * 320
    assert work["request"] == 2 * 2 * weights + kv == 1_636_224
    # FLOPs a token: projections 2 × 204,800, dense 2 × 18,432, routers
    # 6 × 2 × 1,024, head 2 × 16,384, one expected held expert a token
    # (4 × 4/16) 6 × 2 × 6,144; attention 2 × 8 × 40 a key: 64 full, 125
    # window
    token = 409600 + 36864 + 12288 + 32768 + 73728
    assert work["request_flops"] == 4 * token + 640 * (64 + 125) \
        == 2_381_952


def _span(i, name, dur, parent=None):
    return dict(name=name, id=i, parent=parent, dur=dur)


@pytest.fixture
def registry(monkeypatch):
    """A fresh metrics registry of the program for the test."""
    from repro_torch.obs import metrics
    fresh = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_REGISTRY", fresh)
    return fresh


def test_each_new_reader_reads_what_it_names(root, registry):
    bench = harness.Bench(root, CELL)
    ms = 1_000_000
    trace = devtrace.DeviceTrace(window_s=0.02, ops=[
        ("gemm", 0, 4 * ms), ("softmax", 3 * ms, 9 * ms)], phases=[])
    run = harness.Run(latencies=[0.5, 1.5], work=dict(
        request=3.35e9, request_flops=9.89e11), trace=trace,
        peaks=dict(hbm_bytes_per_s=3.35e12, bf16_flops=989e12))
    prefill = registry.histogram("lm_prefill_seconds")
    prefill.observe(1.25)
    prefill.observe(0.5)
    run.program_spans = [
        _span(1, "lm.decode_step", 0.010), _span(2, "lm.attn.full", 0.002, 1),
        _span(3, "lm.attn.full", 0.003, 1), _span(4, "lm.moe", 0.001, 1),
        _span(5, "lm.decode_step", 0.030), _span(6, "lm.attn.full", 0.004, 5),
        _span(7, "lm.attn.window", 0.001, 5), _span(8, "lm.moe", 0.003, 5),
        _span(9, "lm.attn.full", 0.5)]               # outside any step
    read = {name: bench.readers[name].read(run) for name in bench.readers}
    assert read["decode_step_ms"] == pytest.approx(20.0)
    assert read["full_attn_ms"] == pytest.approx(4.5)     # 5 and 4
    assert read["window_attn_ms"] == pytest.approx(0.5)   # 0 and 1
    assert read["moe_ms"] == pytest.approx(2.0)
    # 2 requests of 1 ms of bytes and 1 ms of FLOPs at peak over 2 s
    assert read["decode_hbm_roofline"] == pytest.approx(0.1)
    assert read["decode_mfu"] == pytest.approx(0.1)
    # busy 9 ms of a 20 ms window
    assert read["decode_idle_pct"] == pytest.approx(55.0)
    assert read["prefill_s"] == pytest.approx(1.75)
    registry.reset()
    empty = harness.Run()
    assert all(bench.readers[n].read(empty) is None for n in (
        "decode_step_ms", "full_attn_ms", "window_attn_ms", "moe_ms",
        "decode_hbm_roofline", "decode_mfu", "decode_idle_pct",
        "prefill_s"))
    assert lmspans.per_step_ms(empty, "lm.moe") is None


def test_the_command_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(REPO / "gpubench" / "run.py"), "--workload",
         CELL, "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
