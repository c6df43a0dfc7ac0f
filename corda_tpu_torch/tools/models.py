"""Reactive client-side models over RPC feeds.

Reference: client/jfx/ (~2,500 LoC of JavaFX bindings, SURVEY.md §2.9)
— `NodeMonitorModel` opens every feed on connect; `NetworkIdentityModel`,
`ContractStateModel` (cash states + derived balances),
`StateMachineDataModel`, `TransactionDataModel` maintain observable
collections GUIs bind to. Here the models are toolkit-neutral: each
keeps a plain-python collection current from a DataFeed and re-emits
deltas on its own Observable, so any frontend (the terminal explorer,
tests, a web page) can bind.

Works against either an `RPCClient` proxy or a direct
`CordaRPCOpsImpl` — both expose the same ops surface; RpcFuture
results are unwrapped transparently.

Port of corda_tpu/tools/models.py over the port's RPC proxy and vault
queries.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Optional

from ..node.services import Observable
from ..node.vault_query import QueryCriteria, VaultQueryCriteria


def _unwrap(value):
    """RPCClient returns RpcFuture; CordaRPCOpsImpl returns values."""
    return value.get() if hasattr(value, "get") and hasattr(value, "done") else value


class PumpedOps:
    """Adapt an RPCClient whose fabric needs manual pumping so every
    call blocks to resolution and returns plain values — the models and
    tools then work identically against a live connection or a direct
    CordaRPCOpsImpl."""

    def __init__(self, client, pump: Callable[[], None], timeout: float = 90.0):
        self._client = client
        self._pump = pump
        self._timeout = timeout

    def __getattr__(self, attr):
        from ..client.common import wait_rpc

        target = getattr(self._client, attr)

        def call(*a, **kw):
            return wait_rpc(target(*a, **kw), self._pump, self._timeout)

        return call


class NetworkIdentityModel:
    """Known parties, kept current from the network-map feed
    (client/jfx NetworkIdentityModel)."""

    def __init__(self, ops):
        self.nodes: dict[str, Any] = {}     # legal name -> NodeInfo
        self.changes = Observable()
        feed = _unwrap(ops.network_map_feed())
        for info in feed.snapshot:
            self.nodes[info.legal_identity.name] = info
        self._dispose = feed.dispose

        def on_change(change) -> None:   # MapChange(kind, info)
            name = change.info.legal_identity.name
            if change.kind == "removed":
                self.nodes.pop(name, None)
            else:
                self.nodes[name] = change.info
            self.changes.emit(change)

        self._unsub = feed.updates.subscribe(on_change)

    @property
    def parties(self) -> list:
        return [info.legal_identity for info in self.nodes.values()]

    def close(self) -> None:
        self._unsub()
        if self._dispose:
            self._dispose()


class ContractStateModel:
    """Unconsumed states of one contract-state class + derived cash
    balances (client/jfx ContractStateModel)."""

    def __init__(self, ops, criteria: Optional[QueryCriteria] = None):
        self.states: dict = {}        # StateRef -> StateAndRef
        self.changes = Observable()
        feed = _unwrap(ops.vault_track_by(criteria or VaultQueryCriteria()))
        for sar in feed.snapshot.states:
            self.states[sar.ref] = sar
        self._dispose = feed.dispose

        def on_update(update) -> None:
            for sar in update.consumed:
                self.states.pop(sar.ref, None)
            for sar in update.produced:
                self.states[sar.ref] = sar
            self.changes.emit(update)

        self._unsub = feed.updates.subscribe(on_update)

    def balances(self) -> dict[str, int]:
        """Sum Amount-bearing states by token product (cash balances
        pane). States without an `amount` are skipped."""
        out: dict[str, int] = defaultdict(int)
        for sar in self.states.values():
            amount = getattr(sar.state.data, "amount", None)
            if amount is not None:
                token = amount.token
                product = getattr(token, "product", token)
                out[str(product)] += amount.quantity
        return dict(out)

    def close(self) -> None:
        self._unsub()
        if self._dispose:
            self._dispose()


class TransactionDataModel:
    """Verified transactions in arrival order
    (client/jfx TransactionDataModel over verifiedTransactions feed)."""

    def __init__(self, ops):
        self.transactions: list = []
        self._seen: set = set()
        self.changes = Observable()
        feed = _unwrap(ops.verified_transactions_feed())
        for stx in feed.snapshot:
            self._add(stx)
        self._dispose = feed.dispose
        self._unsub = feed.updates.subscribe(self._add)

    def _add(self, stx) -> None:
        if stx.id not in self._seen:
            self._seen.add(stx.id)
            self.transactions.append(stx)
            self.changes.emit(stx)

    def close(self) -> None:
        self._unsub()
        if self._dispose:
            self._dispose()


class StateMachineDataModel:
    """In-flight and finished flows (client/jfx StateMachineDataModel
    over stateMachinesFeed)."""

    def __init__(self, ops):
        self.in_flight: dict = {}
        self.finished: list = []
        self.changes = Observable()
        feed = _unwrap(ops.state_machines_feed())
        for info in feed.snapshot:
            self.in_flight[info.flow_id] = info
        self._dispose = feed.dispose

        def on_update(update) -> None:
            if update.kind == "removed":
                info = self.in_flight.pop(update.info.flow_id, None)
                self.finished.append(info or update.info)
            else:
                self.in_flight[update.info.flow_id] = update.info
            self.changes.emit(update)

        self._unsub = feed.updates.subscribe(on_update)

    def close(self) -> None:
        self._unsub()
        if self._dispose:
            self._dispose()


class NodeMonitorModel:
    """Open every model against one connection (client/jfx
    NodeMonitorModel.register)."""

    def __init__(self, ops):
        self.ops = ops
        self.identity = _unwrap(ops.node_identity())
        self.network = NetworkIdentityModel(ops)
        self.vault = ContractStateModel(ops)
        self.transactions = TransactionDataModel(ops)
        self.state_machines = StateMachineDataModel(ops)

    def close(self) -> None:
        for m in (
            self.network, self.vault, self.transactions,
            self.state_machines,
        ):
            m.close()
