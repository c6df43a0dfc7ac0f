"""Nothing reachable from port_bench/run.py imports jax or the JAX
package (corda_tpu), top-level names compared whole, so corda_tpu_torch
passes and corda_tpu does not; and the yardstick (the reference, the
generator, the comparison, the count) imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from port_bench import spec

BANNED = {"jax", "jaxlib", "flax", "corda_tpu"}
YARDSTICK = ("ec_ref.py", "traffic.py", "check.py", "imad.py", "devtrace.py", "loop.py",
             "spec.py", "result.py")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _harness_files():
    return sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def test_top_level_names_are_compared_whole():
    assert "corda_tpu_torch".split(".")[0] not in BANNED
    assert "corda_tpu.crypto".split(".")[0] in BANNED


def test_no_harness_file_imports_jax_or_the_jax_package():
    offenders = [(p.name, name) for p in _harness_files() for name in _imports(p)
                 if name.split(".")[0] in BANNED]
    assert offenders == []


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    names = {n.split(".")[0] for n in _imports(spec.HERE / name)}
    assert "corda_tpu_torch" not in names
    if name != "loop.py":           # the loop opens torch.profiler spans in a traced run
        assert "torch" not in names


_PROBE = r"""
import sys, time, dataclasses
sys.path.insert(0, sys.argv[1])
from port_bench import run, spec, sut, check
cell = spec.cell("mixed3.call1024")
cell = dataclasses.replace(cell, traffic={**cell.traffic, "rows_per_call": 6, "distinct_rows": 12,
                                          "call_layouts": 1, "in_flight": 1})
sut.verifier("cpu", (8,))
reqs = sut.requests([])
run.run_cell("mixed3.call1024", 1, 0.05, True, device="cpu", cell=cell,
             make_verifier=lambda k: check.ReferenceVerifier(), t_start=time.perf_counter())
import corda_tpu_torch.crypto.batch_verifier
print("banned:" + ",".join(run.banned_modules()))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """In a fresh process: the harness, the program's verifier module and
    a traced run leave no banned module in sys.modules."""
    p = subprocess.run([sys.executable, "-c", _PROBE, str(spec.ROOT)], capture_output=True,
                       text=True, timeout=300, cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "banned:"
