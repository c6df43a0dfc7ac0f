"""MockNetwork: N in-process nodes over the manually-pumped fabric.

Port of corda_tpu/testing/mock_network.py: `MockNode` and `MockNetwork`
with `create_node`, `create_notary(validating=, batching=, shards=)`,
`run` and the directory sync. Every node's keys, key management and
state machine draw their seeds from one `random.Random(seed)` in the
reference's order, so a seeded network makes the reference's frames.

The signature path runs on the card by default: `batch_verifier=None`
builds a `CudaBatchVerifier()` on "cuda", which raises where there is
no card (the reference defaults to its CpuBatchVerifier; ROADMAP Queue
3 records the divergence). Tests pass `CpuBatchVerifier()` or
`CudaBatchVerifier(device="cpu", ...)`. Not ported: persistence
(`db_dir=` and `restart_node` raise NotImplementedError) and the Raft
and BFT notary clusters.

Reference: test-utils/.../testing/node/MockNode.kt:58 — N AbstractNode
instances in one JVM over an InMemoryMessagingNetwork with deterministic
manual delivery, deterministic identities from seeds
(TestConstants.kt entropyToKeyPair), in-memory persistence, and an
InMemoryTransactionVerifierService. `run()` loops until quiescent
(MockNode runNetwork).

"""

from __future__ import annotations

import random
from typing import Optional

from ..core.identity import Party
from ..crypto import schemes
from ..crypto.batch_verifier import BatchSignatureVerifier, CudaBatchVerifier
from ..flows.api import FlowLogic
from ..flows.statemachine import FlowStateMachine, StateMachineManager
from ..node import messaging as msglib
from ..node.cordapp import install_cordapp_services
from ..node.notary import (
    BatchingNotaryService,
    InMemoryUniquenessProvider,
    ShardedUniquenessProvider,
    SimpleNotaryService,
    ValidatingNotaryService,
)
from ..node.scheduler import NodeSchedulerService
from ..node.services import (
    IdentityService,
    KeyManagementService,
    NodeInfo,
    NetworkMapCache,
    SERVICE_NOTARY,
    SERVICE_NOTARY_VALIDATING,
    ServiceHub,
    TestClock,
)


_NO_PERSISTENCE = (
    "persistent MockNetwork nodes (db_dir=, restart_node) are not ported to "
    "corda_tpu_torch: ROADMAP Queue 1 #6 (persistence)"
)


class MockNode:
    """One in-process node: ServiceHub + SMM + fabric endpoint."""

    def __init__(
        self,
        network: "MockNetwork",
        name: str,
        *,
        notary: Optional[str] = None,     # None | "simple" | "validating"
        scheme_id: int = schemes.DEFAULT_SCHEME,
        keypair: Optional[schemes.KeyPair] = None,
        notary_shards: int = 1,           # batching: sharded commit plane
    ):
        self.network = network
        self.name = name
        self.scheme_id = scheme_id
        seed = network.rng.getrandbits(256)
        self.keypair = keypair or schemes.generate_keypair(scheme_id, seed=seed)
        self.party = Party(name, self.keypair.public)
        self.notary_kind = notary
        advertised: tuple[str, ...] = ()
        if notary == "simple":
            advertised = (SERVICE_NOTARY,)
        elif notary in ("validating", "batching"):
            advertised = (SERVICE_NOTARY_VALIDATING,)
        elif notary is not None:
            raise ValueError(f"unknown notary type {notary!r}")
        self.info = NodeInfo(name, self.party, advertised)
        kms_rng = random.Random(network.rng.getrandbits(64))
        self.services = ServiceHub(
            my_info=self.info,
            key_management=KeyManagementService(self.keypair, rng=kms_rng),
            identity=IdentityService(self.party),
            network_map_cache=NetworkMapCache(),
            clock=network.clock,
            batch_verifier=network.batch_verifier,
        )
        install_cordapp_services(self.services)
        self.messaging = network.fabric.endpoint(name)
        self.smm = StateMachineManager(
            self.services,
            self.messaging,
            rng=random.Random(network.rng.getrandbits(64)),
        )
        if notary == "simple":
            self.services.notary_service = SimpleNotaryService(
                self.services, InMemoryUniquenessProvider()
            )
        elif notary == "validating":
            self.services.notary_service = ValidatingNotaryService(
                self.services, InMemoryUniquenessProvider()
            )
        elif notary == "batching":
            if notary_shards > 1:
                self.services.notary_service = BatchingNotaryService(
                    self.services,
                    ShardedUniquenessProvider(notary_shards),
                    shards=notary_shards,
                )
            else:
                self.services.notary_service = BatchingNotaryService(
                    self.services, InMemoryUniquenessProvider()
                )
        self.scheduler = NodeSchedulerService(
            self.services, self.smm.start_flow
        )
        # extra per-pump tick hooks; each returns a
        # count of actions so run() can detect quiescence
        self.ticks: list = []
        if notary == "batching":
            # the pump tick IS the batch deadline: requests that arrived
            # during one delivery round share one SPI dispatch
            self.ticks.append(self.services.notary_service.tick)

    # -- conveniences -------------------------------------------------------

    def start_flow(self, logic: FlowLogic) -> FlowStateMachine:
        return self.smm.start_flow(logic)

    def run_flow(self, logic: FlowLogic):
        """start + pump the whole network + return the result."""
        fsm = self.start_flow(logic)
        self.network.run()
        return fsm.result_or_throw()

    @property
    def vault(self):
        return self.services.vault

    def __repr__(self) -> str:
        return f"<MockNode {self.name}>"


class MockNetwork:
    """Deterministic multi-node harness (MockNode.kt:58)."""

    def __init__(
        self,
        seed: int = 42,
        batch_verifier: Optional[BatchSignatureVerifier] = None,
        shuffle_delivery: bool = False,
        db_dir: Optional[str] = None,
        faults: Optional[msglib.FabricFaults] = None,
    ):
        """`batch_verifier`: None builds a CudaBatchVerifier on the card
        (raises where there is none). `faults`: an optional
        FabricFaults plane (messaging.py) — the chaos-injection seam.
        It shares this network's TestClock so slow-link delays advance
        in simulated time; run() then treats blocked/delayed frames as
        quiescent instead of livelocking on them. `db_dir` (persistent
        nodes) is not ported and raises NotImplementedError."""
        if db_dir is not None:
            raise NotImplementedError(_NO_PERSISTENCE)
        self.rng = random.Random(seed)
        self.clock = TestClock()
        if faults is not None and faults._clock is None:
            faults._clock = self.clock
        self.faults = faults
        self.fabric = msglib.InMemoryMessagingNetwork(
            clock=self.clock, faults=faults
        )
        self.batch_verifier = batch_verifier or CudaBatchVerifier()
        self.nodes: list[MockNode] = []
        self._shuffle_seed = (
            self.rng.getrandbits(32) if shuffle_delivery else None
        )

    def create_node(self, name: Optional[str] = None, **kw) -> MockNode:
        node = MockNode(
            self, name or f"Node{len(self.nodes)}", **kw
        )
        self.nodes.append(node)
        self._sync_directories()
        return node

    def create_notary(
        self,
        name: str = "Notary",
        validating: bool = False,
        batching: bool = False,
        shards: int = 1,
    ):
        """`shards` > 1 (batching only) builds the sharded commit
        plane: per-shard flush pipelines over a partitioned in-memory
        uniqueness provider (node/notary.py)."""
        kind = (
            "batching" if batching
            else "validating" if validating
            else "simple"
        )
        return self.create_node(name, notary=kind, notary_shards=shards)

    def restart_node(self, node: MockNode) -> MockNode:
        """Kill a node and boot a replacement from its database: needs
        persistence, which is not ported."""
        raise NotImplementedError(_NO_PERSISTENCE)

    def _sync_directories(self) -> None:
        """Every node learns every node (the reference's network-map
        registration round, instant here)."""
        for node in self.nodes:
            for other in self.nodes:
                node.services.network_map_cache.add_node(other.info)
                node.services.identity.register(other.party)

    def run(self, pump_limit: int = 100_000) -> int:
        """Deliver messages until quiescent; returns count delivered."""
        rng = (
            random.Random(self._shuffle_seed)
            if self._shuffle_seed is not None
            else None
        )
        total = 0
        rounds = 0
        while True:
            while True:
                got = self.fabric.pump(1, rng)
                if not got:
                    break   # drained, or frames blocked/delayed by faults
                total += got
                if total > pump_limit:
                    raise RuntimeError("network did not quiesce (livelock?)")
            # quiescent on messages: fire any due scheduled activities
            # (the reference's scheduler thread wakes on its own; in
            # Ring 3 the pump is the only driver, so ticks interleave
            # deterministically with delivery)
            actions = sum(n.scheduler.tick() for n in self.nodes)
            actions += sum(t() for n in self.nodes for t in n.ticks)
            actions += sum(n.smm.tick() for n in self.nodes)
            if not actions and not self.fabric.deliverable:
                return total
            rounds += 1
            if rounds > pump_limit:
                # scheduled flows that keep producing immediately-due
                # activities without any messaging never quiesce either
                raise RuntimeError("scheduler did not quiesce (livelock?)")
