"""A copy of the benchmark's tree with its configurations cut to a size the
CPU runs in a second, for the tests: every file as it is, only the sizes in
``configs/`` changed."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

#: the sizes a test run holds (scale 10: 1,024 users before the drop)
SIZES = {"psi-g500-s22": {"scale": 10}}


def tiny_root(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and gpubench/ with small configs."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "gpubench", tmp / "gpubench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, sizes in SIZES.items():
        path = tmp / "gpubench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["inputs"].update(sizes)
        path.write_text(json.dumps(cfg, indent=1))
    return tmp
