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
csrc and native file is one the port's builds know. A third check runs
the node CLI (`python -m corda_tpu_torch.node`) and the verifier
worker process (`python -m corda_tpu_torch.node.verifier --cpu`) with
the same block, and reads their `sys.modules` once they serve; the
worker runs once more with `--profile-hz`, its sampling profiler on,
and must write its folded stacks. A fourth check runs the three CLIs of
the gateway slice with the same block: the doorman (`python -m
corda_tpu_torch.node.registration`), a node registering with it
(`python -m corda_tpu_torch.node --initial-registration`) and the
remote shell (`python -m corda_tpu_torch.client.shell`, its input at an
end), and reads their `sys.modules` as they exit.
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
    pool and worker, the wire ingest, deadline shedding) and of the node
    slice (the TCP fabric, config, the network map, RPC, node boot and
    its CLI, the health plane, tracing, X.509 and legal names,
    cordform, the dev TLS identities) and of the driver slice (the
    multi-process Driver, the load test, the ledger fuzzer, the demos,
    the client plumbing) and of the telemetry slice (the perf, device
    and wire planes) and of the serving-planes slice (QoS, the
    transaction story, the commit-log state store) and of the
    cross-member slice (distributed uniqueness, raft, the lock factory,
    the sanitizer and its crash-schedule explorer) and of the gateway
    slice (the JSON mapping, the shell, the web gateway, the progress
    renderer, the cash web API, the web explorer, the replacement flows,
    the doorman) are scanned.
    The Cash contract's
    wire name, "corda_tpu.finance.Cash", the sandbox's platform module
    names and the flows' class tags are strings, not imports."""
    offenders = []
    files = _modules()
    assert len(files) >= 97
    for must in ("crypto/eddsa.py", "node/notary.py", "node/services.py",
                 "core/transactions.py", "finance/cash.py", "native/__init__.py",
                 "native/build.py", "crypto/sphincs.py", "core/sandbox.py",
                 "experimental/determinism.py", "finance/commercial_paper.py",
                 "finance/obligation.py", "flows/statemachine.py", "flows/core_flows.py",
                 "node/messaging.py", "node/scheduler.py", "node/cordapp.py",
                 "testing/mock_network.py", "testing/flows.py", "finance/trade_flows.py",
                 "node/verifier.py", "node/ingest.py", "node/qos.py",
                 "node/fabric.py", "node/config.py", "node/network_map.py", "node/rpc.py",
                 "node/node.py", "node/__main__.py", "utils/health.py", "utils/tracing.py",
                 "utils/x509.py", "utils/legal_name.py", "testing/cordform.py",
                 "testing/dev_tls.py", "testing/driver.py", "testing/loadtest.py",
                 "testing/generators.py", "samples/__init__.py", "samples/notary_demo.py",
                 "samples/trader_demo.py", "samples/bank_of_corda_demo.py",
                 "samples/attachment_demo.py", "client/__init__.py", "client/common.py",
                 "utils/perf.py", "utils/device_telemetry.py", "utils/wire_telemetry.py",
                 "utils/txstory.py", "node/statestore.py", "node/persistence.py",
                 "node/distributed_uniqueness.py", "node/raft.py", "utils/locks.py",
                 "testing/sanitizer.py", "client/json_support.py", "client/shell.py",
                 "client/webserver.py", "utils/progress_render.py", "finance/web.py",
                 "tools/__init__.py", "tools/web_explorer.py", "flows/replacement.py",
                 "node/registration.py"):
        assert PKG / must in files
    assert sorted(p.name for p in (PKG / "csrc").iterdir()) == [
        "ed_ends.cu", "ed_ladder.cu", "field256.cuh", "field256_group.cuh", "group_points.cuh",
        "wei_ends.cu", "wei_ladder.cu",
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
from corda_tpu_torch.client.common import find_flow_class
assert find_flow_class("CashPaymentFlow") == "corda_tpu.finance.cash.CashPaymentFlow"
assert find_flow_class("NoOpFlow") == "corda_tpu.testing.flows.NoOpFlow"
assert find_flow_class("ShareAttachmentFlow") == "corda_tpu.samples.attachment_demo.ShareAttachmentFlow"
from corda_tpu_torch.samples import notary_demo
signers, _ = notary_demo.run("single", n_txs=1, batch_verifier=CpuBatchVerifier())
assert [len(s) for s in signers] == [1]
from corda_tpu_torch.utils import device_telemetry, perf, wire_telemetry
perf_plane = perf.PerfPlane()
device_plane = device_telemetry.DevicePlane(
    perf=perf_plane, sampler=device_telemetry.DeviceSampler(lambda: []))
wire_plane = wire_telemetry.WirePlane()
wire_plane.attach_fabric(alice.messaging)
alice.messaging.send("isolation.t", b"frame", "Bob")
net.run()
for plane in (perf_plane, device_plane, wire_plane):
    plane.tick()
assert wire_plane.fabric.totals()["frames_out"] == 1
assert "kernels" in perf_plane.snapshot() and device_plane.capacity()["resources"]
import tempfile
from corda_tpu_torch.node.persistence import NodeDatabase, NotaryIntentJournal, TxStoryIndex
from corda_tpu_torch.node.qos import NotaryQos
from corda_tpu_torch.node.statestore import ShardedCommitLogUniquenessProvider
from corda_tpu_torch.utils.txstory import TxStory
with tempfile.TemporaryDirectory() as tmp:
    db = NodeDatabase(tmp + "/n.db")
    story = TxStory(index=TxStoryIndex(db))
    qos = NotaryQos()
    qos.txstory = story
    qos.admit_tx(pay.id)
    story.close(str(pay.id), "committed")
    story.tick()
    assert story.index.row_count == 2 and qos.snapshot()["admitted"] == 1
    journal = NotaryIntentJournal(db)
    seq = journal.append(pay, alice.party, None)
    assert journal.unresolved()[0][1].id == pay.id
    journal.mark_resolved(seq)
    assert journal.flush_resolved() == 1
    store = ShardedCommitLogUniquenessProvider(tmp + "/store", 2)
    store.commit(list(pay.wtx.inputs), pay.id, alice.party)
    store.close()
    store = ShardedCommitLogUniquenessProvider(tmp + "/store", 2)
    assert set(store.committed) == set(pay.wtx.inputs)
    store.close()
    db.close()
from corda_tpu_torch.node.distributed_uniqueness import DistributedUniquenessProvider
from corda_tpu_torch.node.persistence import XShardCoordinatorJournal, XShardReservationJournal
from corda_tpu_torch.testing.sanitizer import ConcurrencySanitizer, CrashScheduleExplorer
from corda_tpu_torch.utils import locks
assert DistributedUniquenessProvider and XShardCoordinatorJournal and XShardReservationJournal
report = CrashScheduleExplorer().explore(reorder_seeds=1,
                                         boundary_filter=lambda op: op == "coord.decide_commit")
assert report.results and not report.violations
with ConcurrencySanitizer() as san:
    lk = locks.make_lock("Isolation.lock")
    with lk:
        pass
assert san.lock_stats()["Isolation.lock"]["acquisitions"] == 1
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
    completes, a verifier worker with the ingest pipeline verifies
    that payment for the pool, `find_flow_class` resolves flows by the
    reference's tags and the notary demo runs."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 84


_SERVING_PROCESS = r"""
import os, signal, sys, threading, time
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "corda_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
which, argv = sys.argv[1], sys.argv[2:]

imported = threading.Event()

def check():
    # the signal waits for the imports (seconds on a loaded host: a signal
    # that lands in torch's import is a KeyboardInterrupt there, not a stop)
    imported.wait()
    time.sleep(4)      # serving: the node pumps, the worker announced itself
    banned = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "corda_tpu"))
    print("SERVING", "torch" in sys.modules, banned, flush=True)
    os.kill(os.getpid(), signal.SIGTERM if which == "node" else signal.SIGINT)

threading.Thread(target=check, daemon=True).start()
if which == "node":
    from corda_tpu_torch.node.__main__ import main
    imported.set()
    sys.exit(main(argv))
from corda_tpu_torch.node.verifier import main
imported.set()
main(argv)
"""


def test_cli_node_and_worker_process_load_neither_jax_nor_the_reference(tmp_path):
    """`python -m corda_tpu_torch.node` and the verifier worker, each
    serving for a few seconds with importing jax or corda_tpu blocked:
    neither module is in its sys.modules, and each exits 0."""
    from corda_tpu_torch.node.config import NodeConfig, write_config

    toml = tmp_path / "node.toml"
    write_config(NodeConfig(name="Solo", base_dir=str(tmp_path / "solo")), str(toml))
    runs = {
        "node": ["--config", str(toml), "--print-port"],
        "worker": ["--name", "w0", "--node", "Solo", "--node-port", "1", "--cpu",
                   "--db", str(tmp_path / "w0.db")],
    }
    for which, argv in runs.items():
        out = subprocess.run([sys.executable, "-c", _SERVING_PROCESS, which, *argv],
                             cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        serving, = [line for line in out.stdout.splitlines() if line.startswith("SERVING")]
        assert serving == "SERVING True []", which


def test_profiled_worker_process_loads_neither_jax_nor_the_reference(tmp_path):
    """The verifier worker with `--profile-hz 19 --profile-out f` (the
    perf plane's sampling profiler over its threads), serving with
    importing jax or corda_tpu blocked: neither is in its sys.modules,
    it exits 0 and f holds its folded stacks."""
    folded = tmp_path / "w0.folded"
    argv = ["--name", "w0", "--node", "Solo", "--node-port", "1", "--cpu",
            "--db", str(tmp_path / "w0.db"), "--profile-hz", "19", "--profile-out", str(folded)]
    out = subprocess.run([sys.executable, "-c", _SERVING_PROCESS, "worker", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    serving, = [line for line in out.stdout.splitlines() if line.startswith("SERVING")]
    assert serving == "SERVING True []"
    stacks = folded.read_text().splitlines()
    assert stacks and all(line.rsplit(" ", 1)[1].isdigit() for line in stacks)


_CLI_PROCESS = r"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "corda_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
module, argv = sys.argv[1], sys.argv[2:]
try:
    rc = importlib.import_module(module).main(argv)
finally:
    banned = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "corda_tpu"))
    print("LOADED", banned, flush=True)
sys.exit(rc)
"""


def _cli(module: str, *argv: str, **kw):
    return subprocess.Popen([sys.executable, "-c", _CLI_PROCESS, module, *argv], cwd=ROOT,
                            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


def _loaded(out: str) -> str:
    line, = [x for x in out.splitlines() if x.startswith("LOADED")]
    return line


def test_doorman_registration_and_shell_clis_load_neither_jax_nor_the_reference(tmp_path):
    """The doorman CLI serving, a node CLI registering with it over HTTP
    (`--initial-registration`, which stores certificates/tls.pem and
    exits 0) and the remote shell CLI (its input at an end, so it exits
    0 at once), each with importing jax or corda_tpu blocked: neither
    is in its sys.modules."""
    import signal

    from corda_tpu_torch.node.config import NodeConfig, write_config

    doorman = _cli("corda_tpu_torch.node.registration", "--port", "0",
                   "--data-dir", str(tmp_path / "dm"))
    try:
        url = doorman.stdout.readline().strip()
        assert url.startswith("DOORMAN_URL=http://"), doorman.stderr.read()
        toml = tmp_path / "node.toml"
        write_config(NodeConfig(name="Solo", base_dir=str(tmp_path / "solo"),
                                registration_server=url.split("=", 1)[1]), str(toml))
        node = _cli("corda_tpu_torch.node.__main__", "--config", str(toml),
                    "--initial-registration")
        out, err = node.communicate(timeout=120)
        assert node.returncode == 0, err
        assert _loaded(out) == "LOADED []"
        assert (tmp_path / "solo" / "certificates" / "tls.pem").exists()
    finally:
        doorman.send_signal(signal.SIGINT)
        out, err = doorman.communicate(timeout=60)
    assert doorman.returncode == 0, err
    assert _loaded(out) == "LOADED []"
    shell = _cli("corda_tpu_torch.client.shell", "--host", "127.0.0.1", "--port", "1",
                 "--node", "Solo", "--fingerprint", "00" * 32, "--user", "u",
                 "--password", "p")
    out, err = shell.communicate(timeout=120)
    assert shell.returncode == 0, err
    assert "corda_tpu_torch shell" in out and _loaded(out) == "LOADED []"
