"""The PyTorch port stands alone: it never loads jax or the JAX package."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

SLICE_MODULES = [
    "repro_torch", "repro_torch.device", "repro_torch.convert",
    "repro_torch.graphs", "repro_torch.graphs.structure",
    "repro_torch.graphs.generators", "repro_torch.graphs.datasets",
    "repro_torch.core", "repro_torch.core.activity",
    "repro_torch.core.operators", "repro_torch.core.power_psi",
    "repro_torch.core.engine", "repro_torch.core.incremental",
    "repro_torch.core.accelerated",
    "repro_torch.kernels", "repro_torch.kernels.formats",
    "repro_torch.kernels.ref", "repro_torch.kernels._build",
    "repro_torch.kernels.power_step", "repro_torch.kernels.bsr_spmv",
    "repro_torch.kernels.edge_spmv", "repro_torch.kernels.autotune",
    "repro_torch.kernels.ops", "repro_torch.launch",
    "repro_torch.launch.serve",
    "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.log",
    "repro_torch.obs.convergence", "repro_torch.obs.explain",
    "repro_torch.obs.calibrate", "repro_torch.obs.env",
    "repro_torch.graphs.sampler", "repro_torch.kernels.seg_mm",
    "repro_torch.models", "repro_torch.models.gnn",
    "repro_torch.models.gnn.common", "repro_torch.models.gnn.sage",
    "repro_torch.train", "repro_torch.train.optim",
    "repro_torch.configs", "repro_torch.configs.registry",
    "repro_torch.configs.graphsage_reddit", "repro_torch.configs.psi_score",
    "repro_torch.launch.specs", "repro_torch.launch.train",
    "repro_torch.obs.trace", "repro_torch.serving",
    "repro_torch.serving.bucket", "repro_torch.serving.fleet",
    "repro_torch.serving.frontier",
    "repro_torch.core.exact", "repro_torch.core.pagerank",
    "repro_torch.core.power_nf",
    "repro_torch.localpush", "repro_torch.localpush.push",
    "repro_torch.localpush.warm", "repro_torch.localpush.topk",
    "repro_torch.localpush.engine", "repro_torch.localpush.check",
]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_slice_module_list_covers_the_package():
    found = set()
    for path in PORT.rglob("*.py"):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        found.add(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    assert found == set(SLICE_MODULES)


def test_no_file_names_jax_or_repro_in_an_import():
    """AST scan, so lazy imports inside functions are caught too. The
    card-only tests and the port's examples are scanned as well: the card's
    machine has no jax."""
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "ab_edge_tile.py",
        ROOT / "tests" / "test_torch_cuda.py",
        ROOT / "tests" / "test_torch_edge_layouts.py",
        *sorted((ROOT / "examples").glob("torch_*.py"))]
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names
                          if _forbidden(n)]
    assert not offenders, offenders


def test_localpush_entry_point_registers_push_without_jax():
    """``repro_torch.localpush`` first (the import order that would cycle
    through a bottom-of-file registration in the engine module), then the
    registry: the push backend is found and no jax module is loaded."""
    code = (
        "import sys\n"
        "import repro_torch.localpush as lp\n"
        "from repro_torch.core import available_backends, make_engine\n"
        "assert 'push' in available_backends()\n"
        "assert type(make_engine('push', device='cpu')) is lp.PushEngine\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
