"""corda_tpu_torch imports neither jax nor the corda_tpu package.

Two checks: an AST scan of every module of the port and of
chip_smoke.py, and a subprocess that imports every module (and
chip_smoke.py) with `jax` and `corda_tpu` blocked on sys.meta_path, then
builds the native library, round-trips a transaction through it, runs
one sandboxed attachment contract, whose source imports the platform API
by the reference's module names, and runs a two-node payment through
MockNetwork whose flow is restored from its checkpoint by the
`corda_tpu.`-path class tag. The CUDA and C++ sources hold no
Python, but they are in the package too: the scan checks that every
csrc and native file is one the port's builds know.
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
    group_points.cuh), native holds its build, loader and the one C++
    source, and the modules of the codec and sandbox slice (the native
    loader, sphincs, the sandbox, the determinism audit, commercial
    paper, obligation) and of the flow slice (the state machine, the core
    flows, the fabric, the scheduler, the CorDapp services, MockNetwork,
    the test flows, the trade flows) and of the pool slice (the verifier
    pool and worker, the wire ingest, deadline shedding) are scanned.
    The Cash contract's
    wire name, "corda_tpu.finance.Cash", the sandbox's platform module
    names and the flows' class tags are strings, not imports."""
    offenders = []
    files = _modules()
    assert len(files) >= 59
    for must in ("crypto/eddsa.py", "node/notary.py", "node/services.py",
                 "core/transactions.py", "finance/cash.py", "native/__init__.py",
                 "native/build.py", "crypto/sphincs.py", "core/sandbox.py",
                 "experimental/determinism.py", "finance/commercial_paper.py",
                 "finance/obligation.py", "flows/statemachine.py", "flows/core_flows.py",
                 "node/messaging.py", "node/scheduler.py", "node/cordapp.py",
                 "testing/mock_network.py", "testing/flows.py", "finance/trade_flows.py",
                 "node/verifier.py", "node/ingest.py", "node/qos.py"):
        assert PKG / must in files
    assert sorted(p.name for p in (PKG / "csrc").iterdir()) == [
        "ed_ladder.cu", "field256.cuh", "field256_group.cuh", "group_points.cuh", "wei_ladder.cu"
    ]
    assert sorted(p.name for p in (PKG / "native").iterdir() if p.name != "__pycache__") == [
        "__init__.py", "build.py", "cts_hash.cpp"
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
from corda_tpu_torch.core import serialization as ser
from corda_tpu_torch.core.contracts import StateRef
from corda_tpu_torch.crypto.hashes import SecureHash
ref = StateRef(SecureHash.sha256(b"x"), 1)
assert ser.decode(ser.encode(ref)) == ref and ser.encode(ref) == ser.encode_py(ref)
from types import SimpleNamespace as NS
from corda_tpu_torch.core.contracts import ContractViolation
from corda_tpu_torch.core.sandbox import contract_from_attachments, make_contract_attachment
from corda_tpu_torch.testing.notary_fixture import MAGIC_CONTRACT, MAGIC_SOURCE
att = make_contract_attachment(MAGIC_CONTRACT, "MagicContract", MAGIC_SOURCE)
contract = contract_from_attachments(MAGIC_CONTRACT, [att])
big = NS(contract=MAGIC_CONTRACT, data=NS(amount=NS(quantity=60)))
contract.verify(NS(outputs=[NS(contract=MAGIC_CONTRACT, data=NS(amount=NS(quantity=50)))]))
try:
    contract.verify(NS(outputs=[big]))
    raise SystemExit("the sandboxed contract let 60 through")
except ContractViolation as e:
    assert "cap of 50" in str(e)
import random
from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
from corda_tpu_torch.flows.statemachine import StateMachineManager
from corda_tpu_torch.testing import MockNetwork
net = MockNetwork(seed=3, batch_verifier=CpuBatchVerifier())
notary = net.create_notary(validating=True)
alice, bob = net.create_node("Alice"), net.create_node("Bob")
alice.run_flow(CashIssueFlow(100, "USD", alice.party, notary.party))
alice.start_flow(CashPaymentFlow(30, "USD", bob.party))
(_, record), = alice.services.checkpoint_storage.all()
assert ser.decode(record)[1] == "corda_tpu.finance.cash.CashPaymentFlow"
alice.smm.stop()
alice.smm = StateMachineManager(alice.services, alice.messaging, rng=random.Random(1))
assert alice.smm.restore_checkpoints() == 1
restored, = alice.smm.flows.values()
net.run()
assert restored.result_or_throw().id in bob.services.validated_transactions
assert sum(s.state.data.amount.quantity for s in bob.vault.unconsumed_states(CashState)) == 30
from corda_tpu_torch.node.verifier import (
    OutOfProcessTransactionVerifierService, VerifierWorker, request_ingest_pipeline)
pay = restored.result_or_throw()
pool = OutOfProcessTransactionVerifierService(alice.messaging)
worker = VerifierWorker(net.fabric.endpoint("worker-1"), "Alice",
                        batch_verifier=CpuBatchVerifier(), ingest=request_ingest_pipeline(shards=2))
net.run()
fut = pool.verify(alice.services.resolve_transaction(pay.wtx), pay)
net.run()
assert worker.drain() == 1
net.run()
fut.result()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "corda_tpu")]
assert not bad, bad
print(len(names))
"""


def test_imports_with_jax_and_reference_blocked():
    """Every module of the port imports in a fresh interpreter where
    importing jax or corda_tpu raises; there the native codec builds and
    round-trips, a sandboxed attachment contract loads (its
    `from corda_tpu.finance.cash import ...` served by the port) and
    passes and rejects as it should, and a payment between two nodes,
    checkpointed while it awaits the validating notary, is restored by a
    fresh state machine from its `corda_tpu.finance.cash` class tag and
    completes, and a verifier worker with the ingest pipeline verifies
    that payment for the pool."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 59
