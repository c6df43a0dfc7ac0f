"""The load test's command stream and model (testing/loadtest.py) and the
Driver's node.toml (testing/driver.py) in the port, held against the
reference without starting a process.

A stub driver answers `identity_of`, `rpc`, `start_flow`, `wait` and the
vault query, so CrossCashLoadTest.run, _commands and _apply run as they
are in each package: for the reference's test_driver seeds 9 (2 nodes,
12 commands) and 10 (2 nodes, 10 commands, a kill and restart at 0.5),
the reference soak's seed 31 (2 nodes, 16 commands, a traffic node and
the notary restarted at 0.35 and 0.65) and chip_smoke phase 12a's shape
(seed 31, 3 nodes, 24 commands, the same restarts) the flows started
(kind, node, amount, peer), the restarts' victims and the model must be
equal. The node.toml both Drivers write for the same arguments is
byte-equal apart from `verifier_backend`: the port's default is "tpu",
the card (divergence D8), the reference's "cpu"; with "cpu" passed, the
port's file equals the reference's default byte for byte.
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
SOAK = ((0.35, None), (0.65, "Hub"))
STREAMS = {
    "cross-cash": (9, ("Alice", "Bob"), 12, ()),
    "kill-and-restart": (10, ("Alice", "Bob"), 10, ((0.5, None),)),
    "soak": (31, ("Alice", "Bob"), 16, SOAK),
    "phase-12a": (cs.LOAD_SEED, ("Alice", "Bob", "Carol"), cs.LOAD_COUNT, SOAK),
}


class StubDriver:
    """What CrossCashLoadTest asks of a Driver, answered in memory: every
    flow started is recorded and resolves at once; vault queries find
    nothing."""

    def __init__(self):
        self.started = []

    def identity_of(self, node):
        return f"party:{node.name}"

    def rpc(self, node):
        def start_flow(logic):
            self.started.append((node.name, type(logic).__name__, dict(vars(logic))))
            return SimpleNamespace(result=None)

        return SimpleNamespace(start_flow=start_flow,
                               vault_query_by=lambda *a: SimpleNamespace(states=[]))

    def wait(self, fut, timeout=None):
        return fut


def command_stream(prefix: str, seed: int, names, count: int, disruptions) -> dict:
    """Run `prefix`'s CrossCashLoadTest against StubDriver; returns the
    flows started, the restarts' victims and the model."""
    lt_mod = importlib.import_module(f"{prefix}.testing.loadtest")
    d = StubDriver()
    victims = []

    def restart(drv, handle):
        victims.append(handle.name)
        return SimpleNamespace(name=handle.name)

    lt = lt_mod.CrossCashLoadTest(d, [SimpleNamespace(name=n) for n in names], "party:Hub",
                                  seed=seed)
    result = lt.run(count=count, disruptions=tuple(
        lt_mod.Disruption(f"restart {k}", at, restart,
                          target=SimpleNamespace(name=t) if t else None)
        for k, (at, t) in enumerate(disruptions)))
    assert (result.submitted, result.succeeded, result.failed) == (count, count, 0)
    return {"started": d.started, "victims": victims, "expected": result.expected}


@pytest.mark.parametrize("shape", sorted(STREAMS))
def test_command_stream_and_model_equal_the_reference(shape):
    ref, port = (command_stream(p, *STREAMS[shape]) for p in PACKAGES)
    assert port == ref
    kinds = {name for _, name, _ in port["started"]}
    assert kinds == {"CashIssueFlow", "CashPaymentFlow"}
    assert len(port["victims"]) == len(STREAMS[shape][3])
    assert sum(port["expected"].values()) == sum(
        kw["quantity"] for _, name, kw in port["started"] if name == "CashIssueFlow")


def _toml(prefix: str, base: Path, monkeypatch, **kw) -> dict:
    """The node.toml files `prefix`'s Driver writes for a validating Hub
    (the map host) and a p256 Alice, with process spawning stubbed."""
    drv = importlib.import_module(f"{prefix}.testing.driver")

    def spawn(self, cfg, conf_path, timeout):
        handle = drv.NodeHandle(cfg.name, cfg, None, 10_002 + len(self.nodes), b"\x07" * 32, "")
        self.nodes[cfg.name] = handle
        self.map_host = self.map_host or handle
        return handle

    monkeypatch.setattr(drv.Driver, "_spawn", spawn)
    with drv.driver(str(base)) as d:
        d.start_node("Hub", notary="validating", **kw)
        d.start_node("Alice", scheme="secp256r1", **kw)
    return {n: (base / f"{n}.toml").read_text().replace(str(base), "<base>")
            for n in ("Hub", "Alice")}


def test_driver_toml_equal_but_the_backend(tmp_path, monkeypatch):
    ref = _toml("corda_tpu", tmp_path / "ref", monkeypatch)
    port = _toml("corda_tpu_torch", tmp_path / "port", monkeypatch)
    for name, text in ref.items():
        assert 'verifier_backend = "cpu"' in text
        assert 'verifier_backend = "tpu"' in port[name]
        assert port[name].replace('verifier_backend = "tpu"', 'verifier_backend = "cpu"') == text
    assert _toml("corda_tpu_torch", tmp_path / "cpu", monkeypatch, verifier_backend="cpu") == ref
