"""What a run may load and what the reference may import; the command
without a card, and in a tree without the program."""
import ast
import json
import os
import subprocess
import sys
import types

import pytest

from gpubench import harness
from gpubench.tests.tiny import REPO, tiny_root

BENCH = REPO / "gpubench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_names_are_compared_whole(monkeypatch):
    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    assert set(harness.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("x"))
    assert {"repro", "jaxlib"} <= set(harness.forbidden_modules())


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "torch", "numpy"}, (path, tops)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.update(extra)
    return env


def test_a_cpu_run_loads_no_jax_nor_the_jax_package(tmp_path):
    root = tiny_root(tmp_path)
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import sys, json\n"
        f"sys.path[0:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n"
        "from pathlib import Path\nimport torch\n"
        "from gpubench import harness\n"
        f"bench = harness.Bench(Path({str(root)!r}), 'g500s22.cold')\n"
        "r = harness.run_cell(bench, 2**31 + 3, 0.2, True,"
        " torch.device('cpu'))\n"
        "print(json.dumps([r['correct'], sorted({m.split('.')[0] for m in"
        " sys.modules})]))\n")
    out = subprocess.run([sys.executable, str(probe)], capture_output=True,
                         text=True, env=_env(), timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True and "repro_torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN)


def test_the_command_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "g500s22.cold", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=_env(CUDA_VISIBLE_DEVICES=""),
        cwd=REPO, timeout=240)
    assert out.returncode != 0 and out.stdout == ""


def test_a_tree_without_the_program_prints_no_result(tmp_path):
    tiny_root(tmp_path)                  # BENCHMARK.json and gpubench/ only
    probe = tmp_path / "probe.py"        # run.py past its look for a card
    probe.write_text(
        "import sys\nfrom pathlib import Path\n"
        "sys.path[0] = str(Path(__file__).parent)\n"
        "from gpubench import harness\n"
        "args = harness.parse_args(['--workload', 'g500s22.cold', '--seed',"
        " '1', '--seconds', '1'])\n"
        "sys.exit(harness.main(Path(__file__).parent, args, 'cpu', 0.0))\n")
    out = subprocess.run(
        [sys.executable, str(probe)], capture_output=True, text=True,
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=""), timeout=240)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr


@pytest.mark.cuda
def test_every_cell_on_the_card_at_a_small_size(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for workload in (w["name"] for w in spec["workloads"]):
        bench = harness.Bench(root, workload)
        result = harness.run_cell(bench, 11, 0.5, True,
                                  torch.device("cuda", 0))
        assert result["correct"] is True
        assert result["device"]["platform"] == "gpu"
        assert result["device"]["busy_s"] > 0
        control = harness.run_cell(bench, 11, 0.5, False,
                                   torch.device("cuda", 0), control=True)
        assert control["correct"] is False
