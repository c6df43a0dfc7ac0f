"""The operator tools (tools/models.py, explorer.py, graphs.py,
package.py, api_scanner.py) in the port, held against the reference.

- Every case of the reference's tests/test_tools.py runs on the port
  with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module): the monitor model tracking the
  vault, transactions and flows over RPC and stopping when closed, the
  explorer's render and its traffic simulation, the transaction graph,
  and the zipapp (its entries read as corda_tpu_torch/, and the built
  .pyz runs the port's node CLI). Source changes, SUBS: the RPC
  network's MockNetwork gets a CpuBatchVerifier (the port's default is
  the card), and the zipapp's entry paths read corda_tpu_torch/.
- Both cases of the reference's tests/test_api_scanner.py run on the
  port's scanner, against its own surface file, api-current-torch.txt.
- The same seeded network in both packages: ExplorerSimulation(seed=5)
  gives an equal step log, the explorer equal panes, and graphs equal
  dot text over the same transactions.
- The zipapp embeds the CUDA sources, and a node run from it cannot
  build its kernels: the build raises KernelBuildError naming the
  archive.
"""

from __future__ import annotations

import importlib
import zipfile

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
SUBS = (
    ("    net = MockNetwork(seed=91)\n",
     "    from corda_tpu.crypto.batch_verifier import CpuBatchVerifier\n\n"
     "    net = MockNetwork(seed=91, batch_verifier=CpuBatchVerifier())\n"),
    # the zipapp's entries are paths, which the import rewrite leaves alone
    ('"corda_tpu/node/__main__.py"', '"corda_tpu_torch/node/__main__.py"'),
    ('"corda_tpu/crypto/ecdsa.py"', '"corda_tpu_torch/crypto/ecdsa.py"'),
    ('"corda_tpu/native/cts_hash.cpp"', '"corda_tpu_torch/native/cts_hash.cpp"'),
)


def tools_port_module():
    return port_test_module("test_tools", subs=SUBS)


@pytest.mark.parametrize("name,case",
                         port_cases("test_tools", {}) + port_cases("test_api_scanner", {}))
def test_reference_case_on_the_port(name, case, tmp_path):
    mod = tools_port_module() if name == "test_tools" else port_test_module(name)
    run_port_case(mod, case, tmp_path)


def test_case_count():
    assert [len(port_cases(n, {})) for n in ("test_tools", "test_api_scanner")] == [4, 2]


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def _rpc_net(prefix: str):
    """The reference's rpc_net fixture, on a CPU verifier."""
    net = _m(prefix, "testing.mock_network").MockNetwork(
        seed=91, batch_verifier=_m(prefix, "crypto.batch_verifier").CpuBatchVerifier())
    rpclib = _m(prefix, "node.rpc")
    notary = net.create_notary("Notary")
    alice, bob = net.create_node("Alice"), net.create_node("Bob")
    users = rpclib.RPCUserService(rpclib.RpcUser("ex", "pw", ("ALL",)))
    rpclib.RPCServer(rpclib.CordaRPCOpsImpl(alice.services, alice.smm), alice.messaging, users)
    client = rpclib.RPCClient(net.fabric.endpoint("console"), "Alice", "ex", "pw")
    ops = _m(prefix, "tools.models").PumpedOps(client, lambda: net.run(), timeout=60)
    return net, ops, alice, bob, notary


def _explore(prefix: str) -> dict:
    net, ops, alice, bob, notary = _rpc_net(prefix)
    explorer_mod = _m(prefix, "tools.explorer")
    sim = explorer_mod.ExplorerSimulation(ops, currencies=("USD", "GBP"), seed=5)
    log = [sim.step() for _ in range(8)]
    net.run()
    explorer = explorer_mod.Explorer(ops)
    try:
        panes = explorer.render()
        balances = explorer.model.vault.balances()
    finally:
        explorer.close()
        sim.close()
    stxs = ops.verified_transactions_snapshot()
    dot = _m(prefix, "tools.graphs").transactions_to_dot(stxs, title="port-vs-reference")
    return {"log": log, "panes": panes, "balances": balances, "dot": dot,
            "ids": sorted(str(s.id) for s in stxs)}


def test_explorer_simulation_and_graph_equal_the_references():
    ref, port = (_explore(p) for p in PACKAGES)
    assert port["log"] == ref["log"]
    assert port["ids"] == ref["ids"]
    assert port["dot"] == ref["dot"]
    assert port == ref
    assert any(line.startswith("issue") for line in ref["log"])
    assert any(line.startswith("pay") for line in ref["log"])
    assert ref["dot"].count("->") >= 1 and ref["balances"]


def test_zipapp_embeds_the_kernel_sources_and_cannot_build_them(tmp_path, monkeypatch):
    """The .pyz carries csrc/*.cu and *.cuh; a package run from it finds
    its csrc/ inside the archive, where nvcc cannot read, so the build
    raises KernelBuildError naming the archive (no CPU verification in
    its place)."""
    from corda_tpu_torch.crypto import build
    from corda_tpu_torch.tools.package import build_zipapp

    out = tmp_path / "corda.pyz"
    build_zipapp(str(out), entry="node")
    with zipfile.ZipFile(out) as zf:
        names = set(zf.namelist())
    cu = {f"corda_tpu_torch/csrc/{p.name}" for p in build.CSRC_DIR.iterdir()
          if p.suffix in (".cu", ".cuh")}
    assert {"corda_tpu_torch/csrc/wei_ladder.cu", "corda_tpu_torch/csrc/ed_ladder.cu"} <= cu <= names
    assert "corda_tpu_torch/native/cts_hash.cpp" in names
    monkeypatch.setattr(build, "CSRC_DIR", out / "corda_tpu_torch" / "csrc")
    with pytest.raises(build.KernelBuildError, match="inside the archive .*corda.pyz"):
        build.build_all(["wei_ladder"])
