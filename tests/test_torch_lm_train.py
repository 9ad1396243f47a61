"""The port's LM trainer, checkpoints and CLIs against the JAX package's.

The JAX trainer runs as it is, through ``repro.launch.train.main`` in a
subprocess on one core (so that an abort inside XLA fails one test, not
the test worker), with ``jax.make_mesh`` patched to build Auto axes (under
jax 0.9 the trainer's own ``jax.make_mesh((n, 1), ...)`` makes Explicit
axes, which the JAX model's sharding constraints reject). Tolerances: the
accumulated AdamW and Adafactor steps' losses rel ≤ 1e-4 and parameters
rel L2 ≤ 1e-4 a leaf (f32); the trainers' losses, printed to 4 decimals,
rel ≤ 1e-4; checkpoints bit for bit.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import train as joptim
from repro.ckpt import checkpoint as jckpt
from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jtf
from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.models import transformer as tf
from repro_torch.train import optim


SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
# the subprocesses compute on one core each, beside the other test workers
ONE_CORE = dict(OMP_NUM_THREADS="1", XLA_FLAGS=(
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"))
_JAX_TRAIN = (
    "import functools, sys, jax\n"
    "from jax.sharding import AxisType\n"
    "jax.make_mesh = functools.partial(jax.make_mesh,\n"
    "                                  axis_types=(AxisType.Auto,) * 2)\n"
    "from repro.launch import train\n"
    "sys.argv = ['train', *sys.argv[1:]]\n"
    "train.main()\n")


@pytest.fixture
def auto_mesh():
    """A (1, 1) mesh with Auto axes, for the JAX model functions."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _jax_train(*argv) -> list[float]:
    """The JAX trainer's printed losses (``python -m repro.launch.train``
    with ``argv``, its mesh made with Auto axes)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **ONE_CORE)
    out = subprocess.run([sys.executable, "-c", _JAX_TRAIN, *argv], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return [float(m) for m in
            re.findall(r"\] step \d+ loss (\S+)", out.stdout)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch,opt", [("tinyllama-1.1b", "adamw"),
                                      ("tinyllama-1.1b", "adafactor"),
                                      ("mixtral-8x7b", "adamw"),
                                      ("nemotron-4-340b", "adafactor")])
def test_accumulated_train_steps_match_jax(arch, opt, auto_mesh):
    """5 steps with ``accum_steps=2`` on one batch: losses and the final
    parameters against JAX's ``make_train_step``."""
    jcfg = dataclasses.replace(j_get_arch(arch).config(reduced=True),
                               accum_steps=2)
    tcfg = dataclasses.replace(get_arch(arch).config(reduced=True),
                               accum_steps=2)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jopt = getattr(joptim, opt)(joptim.cosine_schedule(3e-3, 5, 1))
    topt = getattr(optim, opt)(optim.cosine_schedule(3e-3, 5, 1))
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(jtf.make_train_step(jcfg, auto_mesh, jopt))
    tstep = tf.make_train_step(tcfg, topt)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 17))
    jb = dict(tokens=jnp.asarray(toks[:, :-1]),
              labels=jnp.asarray(toks[:, 1:]))
    tb = dict(tokens=torch.from_numpy(toks[:, :-1]),
              labels=torch.from_numpy(toks[:, 1:]))
    jl, tl = [], []
    for _ in range(5):
        jp, jstate, loss = jstep(jp, jstate, jb)
        jl.append(float(loss))
        tp, tstate, loss = tstep(tp, tstate, tb)
        tl.append(float(loss))
    assert _rel(tl, jl) <= 1e-4
    assert tl[-1] < tl[0]
    # rel L2 a leaf: Adam's normalised step turns the rounding of a
    # near-zero gradient into a whole step, so no elementwise bound holds
    for a, b in zip(jax.tree_util.tree_leaves(jp), optim.tree_leaves(tp)):
        a, b = np.asarray(a, np.float64), b.detach().numpy()
        assert np.linalg.norm(b - a) <= 1e-4 * np.linalg.norm(a)
    assert tstate["step"] == int(jstate["step"]) == 5


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_reduced_trainer_matches_jax_trainer_losses(arch):
    """``train --arch <lm> --steps 5`` of both packages from the JAX
    trainer's init (``PRNGKey(0)``), the same TokenPipeline batches and
    schedule."""
    want = _jax_train("--arch", arch, "--steps", "5")
    cfg = j_get_arch(arch).config(reduced=True)
    tree = jax.tree.map(np.asarray, jtf.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    got = train.train_lm(arch, 5, "cpu", log=lambda s: None,
                         params=lm_params_from_numpy(tree, device="cpu"))
    assert len(want) == len(got["losses"]) == 5
    assert _rel(got["losses"], want) <= 1e-4


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX trainer checkpoint at step 3 (``dict(p=params, o=adamw
    state)``), resumed by the port's trainer: JAX's losses at steps 3, 4."""
    want = _jax_train("--arch", "tinyllama-1.1b", "--steps", "5",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "3")
    assert checkpoint.latest_step(str(tmp_path)) == 3
    lines = []
    got = train.train_lm("tinyllama-1.1b", 5, "cpu", ckpt_dir=str(tmp_path),
                         resume=True, log=lines.append)
    assert lines[0] == "[train] resumed at step 3"
    assert _rel(got["losses"], want[3:]) <= 1e-4
    assert got["state"]["step"] == 5


def test_port_checkpoint_resumes_in_the_jax_trainer(tmp_path):
    """The port's trainer saves at step 3; the JAX trainer resumes from it
    and gives the port's losses at steps 3, 4."""
    got = train.train_lm("mixtral-8x7b", 5, "cpu", ckpt_dir=str(tmp_path),
                         ckpt_every=3, log=lambda s: None)
    jcfg = j_get_arch("mixtral-8x7b").config(reduced=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = joptim.adamw(joptim.constant_schedule(1.0)).init(jp)
    data = jckpt.load_arrays(str(tmp_path), 3)
    assert set(data) == set(jckpt._flatten(dict(p=jp, o=jstate)))
    assert int(data["o/step"]) == 3
    want = _jax_train("--arch", "mixtral-8x7b", "--steps", "5",
                      "--ckpt-dir", str(tmp_path), "--resume")
    assert len(want) == 2
    assert _rel(want, got["losses"][3:]) <= 1e-4


def test_bf16_checkpoints_round_trip_and_cross_bit_for_bit(tmp_path):
    """The port saves a bfloat16 leaf as the JAX package does (``|V2``,
    the same bits) and restores it as bfloat16; a JAX-written bfloat16
    leaf restores in the port bit for bit, and the port's in JAX."""
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").config(reduced=True),
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    tp = tf.init_params(cfg, 0, device="cpu")
    state = optim.adamw(optim.constant_schedule(1e-3)).init(tp)
    tree = dict(p=tp, o=state)
    checkpoint.save(str(tmp_path / "t"), 1, tree)
    back = checkpoint.restore(str(tmp_path / "t"), 1, tree)
    for a, b in zip(optim.tree_leaves(tp), optim.tree_leaves(back["p"])):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.detach().view(torch.int16), b.view(torch.int16))
    assert back["o"]["master"]["embed"].dtype == np.float32
    flat = checkpoint.load_arrays(str(tmp_path / "t"), 1)
    assert flat["p/embed"].dtype == torch.bfloat16
    # the JAX package reads the port's bf16 leaves ...
    jtree = jckpt.restore(str(tmp_path / "t"), 1, dict(p=optim.tree_map(
        lambda x: np.zeros(tuple(x.shape)), tp)))
    for a, b in zip(optim.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jtree["p"])):
        assert b.dtype == np.dtype("V2")
        np.testing.assert_array_equal(
            b.view(jnp.bfloat16).view(np.int16),
            a.detach().view(torch.int16).numpy())
    # ... and the port reads the JAX package's
    jcfg = dataclasses.replace(j_get_arch("tinyllama-1.1b").config(
        reduced=True), dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    jckpt.save(str(tmp_path / "j"), 2, dict(p=jp))
    got = checkpoint.restore(str(tmp_path / "j"), 2, dict(p=tp))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    optim.tree_leaves(got["p"])):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                      b.view(torch.int16).numpy())


def test_lm_cli_on_cpu_and_refusals(capsys):
    out = train.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps",
                      "3", "--device", "cpu"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["tokens"] == 8 * 64
    assert capsys.readouterr().out.count("[train] step") == 3
    run = serve.main(["--arch", "mixtral-8x7b", "--requests", "1",
                      "--device", "cpu"])
    assert len(run["tokens"]) == 1 and run["tokens"][0].shape == (4, 8)
    assert len(run["prefill_ms"]) == len(run["decode_ms"]) == 1
    assert capsys.readouterr().out.startswith("[serve] req 0: generated")
    for argv, match in (
            (["--arch", "tinyllama-1.1b", "--shape", "prefill_32k"],
             "serve it"),
            (["--arch", "tinyllama-1.1b", "--shape", "molecule"],
             "no shape"),
            (["--arch", "mixtral-8x7b", "--batch", "6", "--shape",
              "train_4k"], "microbatches")):
        with pytest.raises(SystemExit, match=match):
            train.main([*argv, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--arch", "tinyllama-1.1b", "--requests", "1"])


def test_lm_cell_cuts_and_serve_shape_sizes():
    cfg, batch, seq, cuts = train.lm_cell("tinyllama-1.1b", "train_4k")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (22, 2048, 32000)
    assert (batch, seq) == (8, 4096)
    assert cuts == ["global batch 256 -> 8"]
    assert train.lm_cell("yi-9b")[1:] == (8, 64, [])
    prefill = tf.make_prefill(get_arch("mixtral-8x7b").config(reduced=True),
                              max_len=16 + 8)
    cfg = get_arch("mixtral-8x7b").config(reduced=True)
    tp = tf.init_params(cfg, 0, device="cpu")
    cache, logits = prefill(tp, torch.zeros(2, 16, dtype=torch.long))
    assert cache["k"].shape[2] == 24 and logits.shape == (2, cfg.vocab)


@pytest.mark.parametrize("shape,metric", [
    ("prefill_32k", r"\(prefill [\d.]+ ms, \d+ tokens/s\)"),
    ("decode_32k",
     r"\(decode [\d.]+ ms a token, \d+ tokens/s at context 40\)")])
def test_serve_shape_branch_on_a_patched_cell(shape, metric, monkeypatch,
                                              capsys):
    """``serve --shape``'s branch, with the registry entry patched to the
    reduced config and a 40-token cell: the cut is printed, each request
    prints the cell's metric, the greedy tokens equal the argmax of the
    port's forward over the prompt and the tokens before each, and one more
    decode step fits the cache."""
    import repro_torch.configs as configs
    entry = get_arch("tinyllama-1.1b")
    spec = entry.shape(shape)
    small = dataclasses.replace(spec, params=dict(spec.params, seq_len=40))
    monkeypatch.setattr(configs, "get_arch", lambda a: type(
        "Cell", (), dict(family="lm", shape=lambda self, n: small,
                         config=lambda self, reduced=False:
                         entry.config(reduced=True)))())
    run = serve.main(["--arch", "tinyllama-1.1b", "--shape", shape,
                      "--gen-len", "4", "--requests", "1", "--device",
                      "cpu"])
    cut, req = capsys.readouterr().out.splitlines()
    assert cut == (f"[serve] {run['cfg'].name} at {shape}: batch 1 x prompt "
                   f"40 + 4 generated; cut: global batch "
                   f"{spec.params['global_batch']} -> 1")
    assert re.search(r"^\[serve\] req 0: generated \(1, 4\) in [\d.]+s "
                     + metric + "; sample=", req), req
    gen = run["tokens"][0]
    cache, cfg = run["cache"], run["cfg"]
    assert cache["k"].shape[2] == 44 and cache["t"] == 43
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 40))
    seq = torch.from_numpy(np.concatenate([toks, gen[:, :3]], 1))
    with torch.no_grad():
        full = tf.forward(run["params"], seq, cfg)
    np.testing.assert_array_equal(full[:, 39:].argmax(-1).numpy(), gen)
    cache, lg = tf.make_decode_step(cfg)(run["params"], cache,
                                         torch.from_numpy(gen[:, 3]))
    assert cache["t"] == 44 and bool(torch.isfinite(lg).all())
