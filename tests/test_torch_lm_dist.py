"""The sharded LM family on 8 gloo ranks, against the port's one-device path
and the JAX package's functions under an Auto ``(2, 4)`` mesh.

Eight spawned ranks (``file://`` rendezvous in a temporary directory) run
the five reduced configs at float64 (parameters, activations, and the
logits: each rank and the one-device reference set ``model.LOGITS_DTYPE``)
on a ``(2, 4)`` ``("data", "model")`` mesh and a ``(2, 2, 2)`` ``("pod",
"data", "model")`` mesh, plus TinyLlama with FSDP off on ``(2, 4)``: the
reduced configs have 2 KV heads, fewer than 4 model ranks, so on ``(2, 4)``
each KV head's columns lie on 2 ranks. The MoE configs' capacity factor is
cut to 0.5 so that every MoE layer drops tokens. Each rank holds its shards
(``shard_params``) and its share of the batch (``shard_batch``):

* against the port's ``mesh=None`` path within 1e-10 (absolute, every value
  of order 1), run on each data rank's rows alone (a shard's MoE capacity
  counts its own tokens, so a sharded MoE drops what each shard drops): the
  logits, the loss, every gradient assembled to full shape, the prefill's
  and two decode steps' logits; two ``adamw`` steps of
  2 accumulated microbatches with the clip active, within 2e-7 (the
  optimizer's masters are float32 and the clip's float32 norm is summed in
  another order across shards, which moves a master by up to a float32
  ulp), and two ``adafactor`` steps of Nemotron (factored by each leaf's
  global shape, its means over the whole leaf) alike;
* against the JAX package at x64 in a subprocess with 8 forced host
  devices (the same parameters, an Auto ``(2, 4)`` mesh): the JAX model
  rounds its logits to float32 (``astype(jnp.float32)``) and sums the loss
  there, so the logits, loss and gradients agree to float32 rounding
  (rel 1e-6), not to 1e-10; each rank's MoE dropped-assignment counts,
  layer by layer, equal those JAX's ``shard_map`` computes on the same
  device (read with a ``jax.debug.callback`` on its ``bincount``);
* every rank's shard shape of each ``param_specs`` and ``cache_specs`` leaf
  on both meshes, and of each ``DistributedPsi`` array shared with the JAX
  layout, equals ``NamedSharding(mesh, spec).shard_shape(shape)``; so does
  rank 0's (of a fake 8-rank group) shard of every batch array of a GNN
  cell of each shape kind (``full_graph``, ``minibatch``, ``molecule``),
  against JAX's ``build_gnn_cell`` in the same subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.models.transformer import model as TM
from repro_torch.train.optim import (adafactor, adamw, constant_schedule,
                                     tree_leaves, tree_map)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("tinyllama-1.1b", "yi-9b", "nemotron-4-340b", "mixtral-8x22b",
         "mixtral-8x7b")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CASES = [(m, a, True) for m in MESHES for a in ARCHS] + \
    [("2x4", "tinyllama-1.1b", False)]
B, S, PROMPT, ACCUM, LR = 8, 16, 12, 2, 1e-3
TOL, ADAM_TOL, JAX_RTOL = 1e-10, 2e-7, 1e-6
ADAFACTOR_ARCH = "nemotron-4-340b"     # its full config's optimizer

_COMMON = """
import dataclasses
import numpy as np
ARCHS = %r
B, S, PROMPT = %d, %d, %d
# a GNN cell of each shape kind, and the batch arrays whose shards compare
GNN_CELLS = (("pna", "full_graph_sm"), ("graphsage-reddit", "minibatch_lg"),
             ("nequip", "molecule"))
GNN_FIELDS = ("x", "src", "dst", "pos", "node_mask", "graph_ids", "labels",
              "seed_mask")


def data(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (B, S))
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[rng.random((B, S)) < 0.1] = -1
    return tokens, labels
""" % (ARCHS, B, S, PROMPT)

_RANK_SCRIPT = _COMMON + """
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
CASES, MESHES, ACCUM, LR, ADAFACTOR_ARCH = %r, %r, %d, %r, %r


def cfg_for(arch, fsdp):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).config(reduced=True)
    kw = dict(dtype=torch.float64, param_dtype=torch.float64, fsdp=fsdp)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    return dataclasses.replace(cfg, **kw)


def rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.models.transformer import model
    model.LOGITS_DTYPE = torch.float64
    dist.init_process_group("gloo", init_method="file://" + tmp + "/pg",
                            rank=rank, world_size=world)
    from repro_torch.core.activity import heterogeneous
    from repro_torch.core.distributed import DistributedPsi
    from repro_torch.graphs import erdos_renyi
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.optim import (adafactor, adamw, constant_schedule,
                                         tree_leaves)
    arrays, res = {}, {}
    for mname, arch, fsdp in CASES:
        shape, axes = MESHES[mname]
        mesh = make_mesh(tuple(shape), tuple(axes), device="cpu")
        tag = "%%s/%%s/%%d/" %% (mname, arch, fsdp)
        res[tag] = dict(row=mesh.row, col=mesh.col)
        cfg = cfg_for(arch, fsdp)
        full = T.init_params(cfg, 0, device="cpu")
        tok, lab = (torch.as_tensor(x) for x in data(cfg.vocab))
        batch = dict(tokens=T.shard_batch(tok, mesh),
                     labels=T.shard_batch(lab, mesh))
        p = T.shard_params(full, cfg, mesh)
        drops = []
        with torch.no_grad():
            arrays[tag + "logits"] = T.forward(
                p, batch["tokens"], cfg, mesh, moe_drops=drops).numpy()
        if drops:
            arrays[tag + "drops"] = torch.stack(drops).numpy()
        loss, grads = T.loss_and_grads(p, batch, cfg, mesh)
        res[tag]["loss"] = float(loss)
        for i, g in enumerate(tree_leaves(grads)):
            arrays[tag + "grad%%d" %% i] = g.numpy()
        # two adamw steps of ACCUM microbatches, the clip active
        cfg_a = dataclasses.replace(cfg, accum_steps=ACCUM)
        p2 = T.shard_params(full, cfg, mesh)
        opt = adamw(constant_schedule(LR))
        state = opt.init(p2)
        step = T.make_train_step(cfg_a, opt, mesh)
        mb = dict(tokens=T.shard_batch(tok, mesh, ACCUM),
                  labels=T.shard_batch(lab, mesh, ACCUM))
        for _ in range(2):
            p2, state, _ = step(p2, state, mb)
        for i, x in enumerate(tree_leaves(p2)):
            arrays[tag + "adam%%d" %% i] = x.detach().numpy()
        if arch == ADAFACTOR_ARCH:     # two adafactor steps, whole-leaf means
            p3 = T.shard_params(full, cfg, mesh)
            opt = adafactor(constant_schedule(LR))
            state = opt.init(p3, T.param_layout(cfg, mesh))
            step = T.make_train_step(cfg, opt, mesh)
            for _ in range(2):
                p3, state, _ = step(p3, state, batch)
            for i, x in enumerate(tree_leaves(p3)):
                arrays[tag + "adafactor%%d" %% i] = x.detach().numpy()
        # prefill and two decode steps
        prefill = T.make_prefill(cfg, mesh, max_len=S)
        decode = T.make_decode_step(cfg, mesh)
        cache, lg = prefill(p, batch["tokens"][:, :PROMPT])
        arrays[tag + "prefill"] = lg.numpy()
        for j in range(2):
            cache, lg = decode(p, cache, batch["tokens"][:, PROMPT + j])
            arrays[tag + "decode%%d" %% j] = lg.numpy()
        res[tag]["params"] = [list(x.shape) for x in tree_leaves(p)]
        res[tag]["cache"] = {k: list(v.shape) for k, v in T.init_cache(
            cfg, B, S, device="cpu", mesh=mesh).items() if k != "t"}
        if arch == ARCHS[0] and fsdp:
            g = erdos_renyi(200, 1200, seed=1)
            psi = DistributedPsi.from_graph(g, heterogeneous(g.n, seed=4),
                                            mesh)
            res[tag]["psi"] = {k: list(v[0]) for k, v in
                               psi.local_specs().items()}
            res[tag]["psi_block"] = {k: list(getattr(psi.arrays, k).shape)
                                     for k in psi.local_specs()}
        mesh.close()
    np.savez(tmp + "/rank%%d.npz" %% rank, **arrays)
    with open(tmp + "/rank%%d.json" %% rank, "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(8, sys.argv[1]), nprocs=8, join=True)
""" % (CASES, MESHES, ACCUM, LR, ADAFACTOR_ARCH)

_JAX_SCRIPT = _COMMON + """
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs.registry import get_arch
from repro.core.distributed import DistributedPsi
from repro.graphs.generators import erdos_renyi
from repro.graphs.partition import partition_2d
from repro.models.transformer import model as M

tmp = sys.argv[1]
meshes = {"2x4": jax.make_mesh((2, 4), ("data", "model"),
                               axis_types=(AxisType.Auto,) * 2),
          "2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                                 axis_types=(AxisType.Auto,) * 3)}
mesh = meshes["2x4"]
DROPS = {}


class _Jnp:
    # the model module's jnp with a bincount that reports each device's
    # dropped assignments (counts past the local capacity) as it runs
    def __getattr__(self, name):
        return getattr(jnp, name)

    def bincount(self, x, length):
        counts = jnp.bincount(x, length=length)
        jax.debug.callback(_record, counts, x.shape[0],
                           jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"))
        return counts


CUR = {}


def _record(counts, kt, row, col):
    cfg = CUR["cfg"]
    K, E = cfg.moe.top_k, cfg.moe.n_experts
    cap = max(8, int(K * (kt // K) / E * cfg.moe.capacity_factor))
    DROPS.setdefault((int(row), int(col)), []).append(
        np.maximum(np.asarray(counts) - cap, 0).tolist())


M.jnp = _Jnp()
out, shapes = {}, {}
for arch in ARCHS:
    cfg = get_arch(arch).config(reduced=True)
    kw = dict(dtype=jnp.float64, param_dtype=jnp.float64)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    cfg = dataclasses.replace(cfg, **kw)
    CUR["cfg"] = cfg
    with np.load(tmp + "/params_%s.npz" % arch) as z:
        flat = {k: z[k] for k in z.files}
    params = dict(embed=flat["embed"], lm_head=flat["lm_head"],
                  final_norm=flat["final_norm"],
                  layers={k[7:]: v for k, v in flat.items()
                          if k.startswith("layers/")})
    specs = M.param_specs(cfg, mesh)
    params = jax.tree.map(lambda x, s: jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, s)), params, specs)
    tokens, labels = data(cfg.vocab)
    bsh = NamedSharding(mesh, P("data", None))
    tok = jax.device_put(jnp.asarray(tokens), bsh)
    lab = jax.device_put(jnp.asarray(labels), bsh)
    DROPS.clear()
    logits = jax.jit(lambda p, t: M.forward(p, t, cfg, mesh))(params, tok)
    jax.effects_barrier()
    if cfg.moe:
        shapes[arch + "/drops"] = {"%d,%d" % k: v[:cfg.n_layers]
                                   for k, v in DROPS.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: M.loss_fn(p, dict(tokens=tok, labels=lab), cfg, mesh)))(
        params)
    prefill = jax.jit(M.make_prefill(cfg, mesh, max_len=S))
    decode = jax.jit(M.make_decode_step(cfg, mesh))
    cache, lg = prefill(params, tok[:, :PROMPT])
    out[arch + "/prefill"] = np.asarray(lg)
    # at x64 the step's slot index must be int64 like its literal zeros
    cache = dict(cache, t=cache["t"].astype(jnp.int64))
    for j in range(2):
        cache, lg = decode(params, cache, tok[:, PROMPT + j])
        out[arch + "/decode%d" % j] = np.asarray(lg)
    out[arch + "/logits"] = np.asarray(logits)
    out[arch + "/loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[arch + "/grad%d" % i] = np.asarray(g)
    for mname, m in meshes.items():
        sp = M.param_specs(cfg, m)
        pshape = jax.eval_shape(lambda k: M.init_params(cfg, k),
                                jax.random.PRNGKey(0))
        shapes["%s/%s/params" % (mname, arch)] = [
            list(NamedSharding(m, s).shard_shape(x.shape)) for s, x in zip(
                jax.tree.leaves(sp, is_leaf=lambda s: isinstance(s, P)),
                jax.tree.leaves(pshape))]
        cs = M.cache_specs(cfg, m)
        cshape = jax.eval_shape(lambda: M.init_cache(cfg, B, S))
        shapes["%s/%s/cache" % (mname, arch)] = {
            k: list(NamedSharding(m, cs[k]).shard_shape(cshape[k].shape))
            for k in ("k", "v", "pos")}
g = erdos_renyi(200, 1200, seed=1)
for mname, m in meshes.items():
    part = partition_2d(g, 4 if mname == "2x2x2" else 2, m.shape["model"])
    psi = DistributedPsi(part, m)
    ins, sh = psi.input_specs(), psi.shardings()
    shapes[mname + "/psi"] = {k: list(sh[k].shard_shape(ins[k].shape))
                              for k in ins}
from repro.launch import specs as jspecs
for mname, m in meshes.items():
    for arch, sname in GNN_CELLS:
        entry = get_arch(arch)
        spec = next(s for s in entry.shapes if s.name == sname)
        cell = jspecs.build_gnn_cell(entry, spec, m)
        structs, shard = cell.args[2], cell.in_shardings[2]
        shapes["%s/%s/%s/gnn" % (mname, arch, sname)] = {
            f: list(getattr(shard, f).shard_shape(getattr(structs, f).shape))
            for f in GNN_FIELDS if getattr(structs, f) is not None}
np.savez(tmp + "/jax.npz", **out)
with open(tmp + "/jax.json", "w") as fh:
    json.dump(shapes, fh)
"""


def _cfg(arch, fsdp=True):
    cfg = get_arch(arch).config(reduced=True)
    kw = dict(dtype=torch.float64, param_dtype=torch.float64, fsdp=fsdp)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(autouse=True)
def _f64_logits(monkeypatch):
    """The one-device reference keeps its logits float64, as the ranks do."""
    monkeypatch.setattr(TM, "LOGITS_DTYPE", torch.float64)


def _data(vocab):
    ns = {}
    exec(_COMMON, ns)
    return (torch.as_tensor(x) for x in ns["data"](vocab))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX subprocess beside the 8 gloo ranks (each single threaded);
    → (JAX arrays, JAX shapes, per-rank (results, arrays))."""
    tmp = str(tmp_path_factory.mktemp("lm8"))
    for arch in ARCHS:
        full = T.init_params(_cfg(arch), 0, device="cpu")
        flat = {k: full[k].detach().numpy() for k in
                ("embed", "lm_head", "final_norm")}
        flat.update({"layers/" + k: v.detach().numpy()
                     for k, v in full["layers"].items()})
        np.savez(os.path.join(tmp, f"params_{arch}.npz"), **flat)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false",
               OMP_NUM_THREADS="1")
    jpath, rpath = (os.path.join(tmp, f) for f in ("jax_lm.py",
                                                   "torch_ranks.py"))
    with open(jpath, "w") as fh:
        fh.write(textwrap.dedent(_JAX_SCRIPT))
    with open(rpath, "w") as fh:
        fh.write(textwrap.dedent(_RANK_SCRIPT))
    jproc = subprocess.Popen([sys.executable, jpath, tmp], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        rproc = subprocess.run([sys.executable, rpath, tmp], env=env,
                               capture_output=True, text=True, timeout=900)
        _, jerr = jproc.communicate(timeout=900)
    finally:
        jproc.kill()
    assert rproc.returncode == 0, rproc.stderr[-4000:]
    assert jproc.returncode == 0, jerr[-4000:]
    per_rank = []
    for r in range(8):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            res = json.load(fh)
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            per_rank.append((res, {k: z[k] for k in z.files}))
    with np.load(os.path.join(tmp, "jax.npz")) as z:
        jarr = {k: z[k] for k in z.files}
    with open(os.path.join(tmp, "jax.json")) as fh:
        jshapes = json.load(fh)
    return jarr, jshapes, per_rank


def _tag(mname, arch, fsdp):
    return f"{mname}/{arch}/{int(fsdp)}/"


def _assemble(per_rank, tag, key, spec):
    """The full array of ``key`` laid out by ``spec`` (axes "dp" / "model"
    / None a dimension) from every rank's block; replicated blocks must
    agree bit for bit."""
    blocks = {}
    for res, arr in per_rank:
        idx = tuple(res[tag]["row"] if a == "dp" else
                    res[tag]["col"] if a == "model" else 0 for a in spec)
        x = arr[tag + key]
        if idx in blocks:
            assert np.array_equal(blocks[idx], x), (tag, key)
        blocks[idx] = x

    def build(prefix, dim):
        if dim == len(spec):
            return blocks[prefix]
        n = max(k[dim] for k in blocks) + 1
        return np.concatenate([build(prefix + (i,), dim + 1)
                               for i in range(n)], axis=dim)

    return build((), 0)


def _shard_loss(params, tok, lab, cfg, d):
    """The mean cross-entropy of a batch split into ``d`` row shards, each
    shard forwarded on its own (the MoE capacity is a shard's), on one
    device."""
    count = torch.clamp((lab >= 0).sum().double(), min=1.0)
    total = 0.0
    for t, l in zip(tok.chunk(d), lab.chunk(d)):
        logits = T.forward(params, t, cfg)
        gold = torch.gather(logits, -1, l.clamp(min=0)[..., None])[..., 0]
        ce = torch.logsumexp(logits, dim=-1) - gold
        total = total + torch.sum(ce * (l >= 0)) / count
    return total


def _reference(arch, fsdp, d):
    """What ``d`` data ranks compute, from the one-device path: every
    function of a shard of rows run on that shard alone."""
    cfg = _cfg(arch, fsdp)
    full = T.init_params(cfg, 0, device="cpu")
    tok, lab = _data(cfg.vocab)
    out = {}
    with torch.no_grad():
        out["logits"] = torch.cat([T.forward(full, t, cfg)
                                   for t in tok.chunk(d)]).numpy()
    leaves = tree_leaves(full)
    loss = _shard_loss(full, tok, lab, cfg, d)
    out["loss"] = float(loss.detach())
    out["grads"] = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    opt = adamw(constant_schedule(LR))
    state = opt.init(full)
    for _ in range(2):
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for t, l in zip(tok.chunk(ACCUM), lab.chunk(ACCUM)):
            g = torch.autograd.grad(_shard_loss(full, t, l, cfg, d), leaves)
            for ga, gi in zip(grads, g):
                ga.add_(gi.float())
        by_id = {id(p): g / ACCUM for p, g in zip(leaves, grads)}
        full, state = opt.apply(tree_map(lambda p: by_id[id(p)], full),
                                state, full)
    out["adam"] = [x.detach().numpy() for x in tree_leaves(full)]
    if arch == ADAFACTOR_ARCH:
        full = T.init_params(cfg, 0, device="cpu")
        leaves = tree_leaves(full)
        opt = adafactor(constant_schedule(LR))
        state = opt.init(full)
        for _ in range(2):
            g = torch.autograd.grad(_shard_loss(full, tok, lab, cfg, d),
                                    leaves)
            by_id = {id(p): gi for p, gi in zip(leaves, g)}
            full, state = opt.apply(tree_map(lambda p: by_id[id(p)], full),
                                    state, full)
        out["adafactor"] = [x.detach().numpy() for x in tree_leaves(full)]
    full = T.init_params(cfg, 0, device="cpu")
    prefill = T.make_prefill(cfg, max_len=S)
    decode = T.make_decode_step(cfg)
    outs = {"prefill": [], "decode0": [], "decode1": []}
    for t in tok.chunk(d):
        cache, lg = prefill(full, t[:, :PROMPT])
        outs["prefill"].append(lg)
        for j in range(2):
            cache, lg = decode(full, cache, t[:, PROMPT + j])
            outs[f"decode{j}"].append(lg)
    out.update({k: torch.cat(v).numpy() for k, v in outs.items()})
    return cfg, out


@pytest.mark.parametrize("mname,arch,fsdp", CASES)
def test_gloo8_sharded_lm_equals_one_device(ranks, mname, arch, fsdp):
    _, _, per_rank = ranks
    tag = _tag(mname, arch, fsdp)
    cfg, ref = _reference(arch, fsdp, 4 if mname == "2x2x2" else 2)
    rows_vocab = ("dp", None, "model")
    np.testing.assert_allclose(
        _assemble(per_rank, tag, "logits", rows_vocab), ref["logits"],
        rtol=0, atol=TOL)
    for res, _ in per_rank:
        assert abs(res[tag]["loss"] - ref["loss"]) <= TOL
    specs = tree_leaves(T.param_specs(cfg))
    for i, (spec, want) in enumerate(zip(specs, ref["grads"])):
        got = _assemble(per_rank, tag, f"grad{i}", spec)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"gradient leaf {i} {spec}")
    for i, (spec, want) in enumerate(zip(specs, ref["adam"])):
        got = _assemble(per_rank, tag, f"adam{i}", spec)
        np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_TOL,
                                   err_msg=f"adamw leaf {i} {spec}")
    for i, (spec, want) in enumerate(zip(specs, ref.get("adafactor", []))):
        got = _assemble(per_rank, tag, f"adafactor{i}", spec)
        np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_TOL,
                                   err_msg=f"adafactor leaf {i} {spec}")
    for key in ("prefill", "decode0", "decode1"):
        np.testing.assert_allclose(
            _assemble(per_rank, tag, key, ("dp", "model")), ref[key],
            rtol=0, atol=TOL, err_msg=key)
    if cfg.moe:
        assert all(arr[tag + "drops"].sum() > 0 for _, arr in per_rank)


@pytest.mark.parametrize("arch", ARCHS)
def test_gloo8_sharded_lm_matches_jax(ranks, arch):
    jarr, jshapes, per_rank = ranks
    tag = _tag("2x4", arch, True)
    cfg = _cfg(arch)

    def close(got, want, what):
        scale = max(1.0, float(np.max(np.abs(want))))
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_RTOL * scale,
                                   err_msg=what)

    close(_assemble(per_rank, tag, "logits", ("dp", None, "model")),
          jarr[arch + "/logits"], "logits")
    close(per_rank[0][0][tag]["loss"], jarr[arch + "/loss"], "loss")
    for i, spec in enumerate(tree_leaves(T.param_specs(cfg))):
        close(_assemble(per_rank, tag, f"grad{i}", spec),
              jarr[arch + f"/grad{i}"], f"gradient leaf {i}")
    for key in ("prefill", "decode0", "decode1"):
        close(_assemble(per_rank, tag, key, ("dp", "model")),
              jarr[f"{arch}/{key}"], key)
    if cfg.moe:
        jd = jshapes[arch + "/drops"]
        for res, arr in per_rank:
            where = "%d,%d" % (res[tag]["row"], res[tag]["col"])
            assert arr[tag + "drops"].tolist() == jd[where], where


@pytest.mark.parametrize("mname", list(MESHES))
def test_gloo8_shard_shapes_equal_jax(ranks, mname):
    _, jshapes, per_rank = ranks
    for arch in ARCHS:
        tag = _tag(mname, arch, True)
        for res, _ in per_rank:
            assert res[tag]["params"] == \
                jshapes[f"{mname}/{arch}/params"], arch
            assert res[tag]["cache"] == jshapes[f"{mname}/{arch}/cache"]
    tag = _tag(mname, ARCHS[0], True)
    for res, _ in per_rank:
        psi = res[tag]["psi"]
        for k, want in jshapes[mname + "/psi"].items():
            if k in psi:              # the port reads lengths, not dst_local
                split = len(want) - len(psi[k])
                assert want == [1] * split + psi[k], k
                assert res[tag]["psi_block"][k] == psi[k], k


@pytest.mark.parametrize("mname", list(MESHES))
def test_gnn_cell_shard_shapes_equal_jax(ranks, mname):
    """Rank 0's GNN batch arrays (traced on FakeTensors, as rank 0 of a
    fake 8-rank group) have JAX's ``NamedSharding.shard_shape``: nodes and
    edges split over the src group, graph labels whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    _, jshapes, _ = ranks
    ns = {}
    exec(_COMMON, ns)
    shape, axes = MESHES[mname]
    dryrun.start_fake_world(8)
    try:
        mesh = make_mesh(tuple(shape), tuple(axes), device="cpu")
        for arch, sname in ns["GNN_CELLS"]:
            entry = get_arch(arch)
            cell = specs.build_gnn_cell(entry, entry.shape(sname), mesh)
            with FakeTensorMode(allow_non_fake_inputs=True):
                batch = cell.make_args(torch.device("cpu"))[2]
            got = {f: list(getattr(batch, f).shape)
                   for f in ns["GNN_FIELDS"] if getattr(batch, f) is not None}
            assert got == jshapes[f"{mname}/{arch}/{sname}/gnn"], arch
            assert batch.split is not None and batch.split.nodes \
                and batch.split.edges
        mesh.close()
    finally:
        torch.distributed.destroy_process_group()
