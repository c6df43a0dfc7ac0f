"""MockNetwork: N in-process nodes over the manually-pumped fabric.

Port of corda_tpu/testing/mock_network.py: `MockNode` and `MockNetwork`
with `create_node`, `create_notary(validating=, batching=, shards=)`,
persistent nodes (`db_dir=`: one sqlite database per node, through
node/persistence.py) and `restart_node`, the Raft and BFT notary
clusters (`create_raft_notary_cluster`, `create_bft_notary_cluster`,
`elect`, each member's `rebuild_cluster_member`), `run` and the
directory sync. Every node's keys, key management and state machine
draw their seeds from one `random.Random(seed)` in the reference's
order, so a seeded network makes the reference's frames and database
rows.

The signature path runs on the card by default: `batch_verifier=None`
builds a `CudaBatchVerifier()` on "cuda", which raises where there is
no card (the reference defaults to its CpuBatchVerifier; ROADMAP Queue
3 records the divergence). Restarted nodes and cluster members share
the network's verifier. Tests pass `CpuBatchVerifier()` or
`CudaBatchVerifier(device="cpu", ...)`.

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
from ..crypto.composite import CompositeKey
from ..crypto.batch_verifier import BatchSignatureVerifier, CudaBatchVerifier
from ..flows.api import FlowLogic
from ..flows.statemachine import FlowStateMachine, StateMachineManager
from ..node import messaging as msglib
from ..node.bft import BftReplica, BFTNotaryService
from ..node.cordapp import install_cordapp_services
from ..node.notary import (
    BatchingNotaryService,
    InMemoryUniquenessProvider,
    ShardedUniquenessProvider,
    SimpleNotaryService,
    ValidatingNotaryService,
)
from ..node.persistence import PersistentServiceHub, PersistentUniquenessProvider
from ..node.raft import LEADER, RaftNode, RaftUniquenessProvider
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
        if network.db_dir is not None:
            self.services = PersistentServiceHub.open(
                f"{network.db_dir}/{name}.db",
                self.info,
                IdentityService(self.party),
                self.keypair,
                network_map_cache=NetworkMapCache(),
                clock=network.clock,
                batch_verifier=network.batch_verifier,
                rng=kms_rng,
            )
            uniqueness = lambda: PersistentUniquenessProvider(  # noqa: E731
                self.services.db
            )
        else:
            self.services = ServiceHub(
                my_info=self.info,
                key_management=KeyManagementService(self.keypair, rng=kms_rng),
                identity=IdentityService(self.party),
                network_map_cache=NetworkMapCache(),
                clock=network.clock,
                batch_verifier=network.batch_verifier,
            )
            uniqueness = InMemoryUniquenessProvider
        install_cordapp_services(self.services)
        self.messaging = network.fabric.endpoint(name)
        self.smm = StateMachineManager(
            self.services,
            self.messaging,
            rng=random.Random(network.rng.getrandbits(64)),
        )
        if notary == "simple":
            self.services.notary_service = SimpleNotaryService(
                self.services, uniqueness()
            )
        elif notary == "validating":
            self.services.notary_service = ValidatingNotaryService(
                self.services, uniqueness()
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
                    self.services, uniqueness()
                )
        self.scheduler = NodeSchedulerService(
            self.services, self.smm.start_flow
        )
        # extra per-pump tick hooks (raft timers etc.); each returns a
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
        quiescent instead of livelocking on them. `db_dir`: a directory
        for one sqlite database per node (`<db_dir>/<name>.db`), which
        `restart_node` reopens."""
        self.db_dir = db_dir
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

    def create_raft_notary_cluster(
        self,
        n: int = 3,
        name: str = "RaftNotary",
        validating: bool = False,
        scheme_id: int = schemes.DEFAULT_SCHEME,
        tracer_factory=None,
        metrics_factory=None,
    ):
        """n MockNodes forming one Raft notary cluster behind a shared
        service identity (reference: notary-demo Raft cluster,
        RaftUniquenessProvider.kt). Returns (service_party, members).
        Elect a leader before notarising: run() + advance_clock loops
        (`elect`). `scheme_id` picks the member/service signature
        scheme. `tracer_factory(member_name)` / `metrics_factory(
        member_name)` optionally hand each member its OWN tracer /
        metric registry — consensus-phase spans and Raft.Phase.* timers
        land per member, the shape cross-node trace assembly tests
        against (None keeps the bare protocol)."""
        shared_kp = schemes.generate_keypair(
            scheme_id, seed=self.rng.getrandbits(256)
        )
        service_party = Party(name, shared_kp.public)
        member_names = [f"{name}-{i}" for i in range(n)]
        members = []
        for mname in member_names:
            node = self.create_node(mname, scheme_id=scheme_id)
            node.services.key_management.register_keypair(shared_kp)
            node.info = NodeInfo(
                mname,
                node.party,
                (SERVICE_NOTARY_VALIDATING,) if validating else (SERVICE_NOTARY,),
                cluster_identity=service_party,
            )
            node.services.my_info = node.info

            def factory(apply_fn, _node=node, _mname=mname, **raft_kw):
                raft = RaftNode(
                    _mname,
                    member_names,
                    _node.messaging,
                    apply_fn,
                    self.clock,
                    db=getattr(_node.services, "db", None),
                    rng=random.Random(self.rng.getrandbits(32)),
                    tracer=(
                        tracer_factory(_mname) if tracer_factory else None
                    ),
                    metrics=(
                        metrics_factory(_mname) if metrics_factory else None
                    ),
                    **raft_kw,
                )
                _node.raft = raft
                _node.ticks.append(raft.tick)
                return raft

            def rebuild(_node=node, _factory=factory):
                """Kill/restart seam: discard the
                member's raft state machine and provider, build fresh
                ones over the SAME fabric endpoint (dedupe set and
                journal survive, like a real node restarting over its
                database), and let the cluster's own state transfer —
                AppendEntries replay / InstallSnapshot — restore the
                committed map. The previous raft instance must be
                stop()ped first (handler removal)."""
                provider = RaftUniquenessProvider(_factory)
                cls = (
                    ValidatingNotaryService if validating
                    else SimpleNotaryService
                )
                _node.services.notary_service = cls(
                    _node.services, provider, service_identity=service_party
                )
                return _node.services.notary_service

            node.rebuild_cluster_member = rebuild
            rebuild()
            members.append(node)
        self._sync_directories()
        return service_party, members

    def create_bft_notary_cluster(
        self,
        n: int = 4,
        name: str = "BFTNotary",
        scheme_id: int = schemes.DEFAULT_SCHEME,
        tracer_factory=None,
        metrics_factory=None,
    ):
        """3f+1 MockNodes forming a BFT notary cluster. The service
        identity is a CompositeKey(threshold=f+1) over the member keys
        (reference: BFTNonValidatingNotaryService.kt:29 + the cluster
        composite identity in BFTSMaRt.kt). Returns (party, members).
        `scheme_id` picks the member scheme."""
        member_names = [f"{name}-{i}" for i in range(n)]
        members = [
            self.create_node(m, scheme_id=scheme_id) for m in member_names
        ]
        f = (n - 1) // 3
        composite = CompositeKey.build(
            [m.party.owning_key for m in members], threshold=f + 1
        )
        service_party = Party(name, composite)
        member_keys = {m.name: m.party.owning_key for m in members}
        for node in members:
            node.info = NodeInfo(
                node.name,
                node.party,
                (SERVICE_NOTARY,),
                cluster_identity=service_party,
            )
            node.services.my_info = node.info

            def rebuild(_node=node):
                """Kill/restart seam: a FRESH replica
                over the same endpoint — empty uniqueness map, exec_seq
                1 — restored by the cluster's own catch-up/state-
                transfer machinery (CatchUpRequest -> _restore). The
                previous replica must be stop()ped first."""
                replica = BftReplica(
                    _node.name,
                    member_names,
                    _node.messaging,
                    lambda cmd, ts: (None, None),   # rewired by the service
                    self.clock,
                    cluster=name,
                    rng=random.Random(self.rng.getrandbits(32)),
                    tracer=(
                        tracer_factory(_node.name)
                        if tracer_factory else None
                    ),
                    metrics=(
                        metrics_factory(_node.name)
                        if metrics_factory else None
                    ),
                )
                _node.bft = replica
                _node.ticks.append(replica.tick)
                _node.services.notary_service = BFTNotaryService(
                    _node.services,
                    replica,
                    service_party,
                    member_keys=member_keys,
                )
                return _node.services.notary_service

            node.rebuild_cluster_member = rebuild
            rebuild()
        self._sync_directories()
        return service_party, members

    def elect(self, members, max_rounds: int = 300):
        """Advance time until the cluster settles on a leader."""
        for _ in range(max_rounds):
            self.clock.advance(20_000)
            self.run()
            leaders = [m for m in members if m.raft.role == LEADER]
            if len(leaders) == 1 and all(
                m.raft.leader == leaders[0].raft.name
                for m in members
                if m is not leaders[0]
            ):
                return leaders[0]
        raise AssertionError("raft notary cluster failed to elect")

    def restart_node(self, node: MockNode) -> MockNode:
        """Kill a node and boot a replacement from its database — the
        reference's crash-recovery test move (StateMachineManager
        restoreFibersFromCheckpoints, MockNode restart). Requires
        db_dir. The new node re-registers, restores checkpoints, and
        resumes flows on the next pump. The replacement reuses the same
        fabric endpoint object, so the receiver-side dedupe set and id
        counter survive — the in-memory stand-in for the durable
        fabric's persisted dedupe table."""
        if self.db_dir is None:
            raise RuntimeError("restart_node requires MockNetwork(db_dir=...)")
        node.scheduler.stop()
        node.smm.stop()
        node.services.db.close()
        node.messaging.running = False
        self.nodes.remove(node)
        replacement = MockNode(
            self,
            node.name,
            notary=node.notary_kind,
            scheme_id=node.scheme_id,
            keypair=node.keypair,
        )
        self.nodes.append(replacement)
        self._sync_directories()
        replacement.messaging.running = True
        replacement.smm.restore_checkpoints()
        return replacement

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
