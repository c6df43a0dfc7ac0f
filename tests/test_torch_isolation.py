"""corda_tpu_torch imports neither jax nor the corda_tpu package.

Two checks: an AST scan of every module of the port and of
chip_smoke.py, and a subprocess that imports every module (and
chip_smoke.py) with `jax` and `corda_tpu` blocked on sys.meta_path.
The CUDA sources hold no Python, but they are in the package too: the
scan checks that every csrc file is one the port's build knows.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "corda_tpu_torch"
BANNED = {"jax", "jaxlib", "corda_tpu"}


def _modules():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_ast_scan_finds_no_banned_import():
    """No `import jax`, `from jax...`, `import corda_tpu` or `from
    corda_tpu...` anywhere in the port or chip_smoke.py (corda_tpu_torch
    is allowed); the ed25519 module and the notary's host layers
    (node/notary.py, node/services.py, core/transactions.py,
    finance/cash.py) are among those scanned, and csrc holds only the
    two kernel sources and their headers (the one-thread field256.cuh,
    the group-cooperative field256_group.cuh, the point tables of
    group_points.cuh). The Cash contract's wire name,
    "corda_tpu.finance.Cash", is a string, not an import."""
    offenders = []
    files = _modules()
    assert len(files) >= 40
    for must in ("crypto/eddsa.py", "node/notary.py", "node/services.py",
                 "core/transactions.py", "finance/cash.py"):
        assert PKG / must in files
    assert sorted(p.name for p in (PKG / "csrc").iterdir()) == [
        "ed_ladder.cu", "field256.cuh", "field256_group.cuh", "group_points.cuh", "wei_ladder.cu"
    ]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in BANNED:
                    offenders.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert offenders == []


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "corda_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import corda_tpu_torch
names = [m.name for m in pkgutil.walk_packages(corda_tpu_torch.__path__, "corda_tpu_torch.")]
names.append("chip_smoke")
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "corda_tpu")]
assert not bad, bad
print(len(names))
"""


def test_imports_with_jax_and_reference_blocked():
    """Every module of the port imports in a fresh interpreter where
    importing jax or corda_tpu raises."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 40
