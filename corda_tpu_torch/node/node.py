"""Node assembly & lifecycle: the real node over the DCN fabric.

Port of corda_tpu/node/node.py: `Node` with the reference's boot
order, identity, boot counter and TLS persistence (certificates/tls.pem
first), network map, RPC server, the health plane (`HealthMonitor`,
`ClusterHealth`, `IncidentRecorder`, `ClusterTraces`), every notary
kind the port has (simple, validating, batching over the legacy or
partitioned PersistentUniquenessProvider, raft, raft-validating, bft)
and `verifier_type = "out_of_process"`. With `verifier_backend = "tpu"`
and no `batch_verifier` the node verifies through `default_verifier()`,
a CudaBatchVerifier on the card, built at first use: a node without a
card boots, discovers and answers RPC, and its first signature check
raises the device error. "cpu" builds CpuBatchVerifier.

The notary's serving-path planes are built as the reference builds
them: the QoS plane (`qos_enabled`, node/qos.py), the intent WAL
(`notary_intent_wal`, replayed at boot), the commit-log state store
(`notary_state_store = "commitlog"`, node/statestore.py, with the
one-way sqlite migration at boot and compaction on the pump) and the
transaction story (`txstory_enabled`, utils/txstory.py, with its
`txstory_index` spill group-committed on the pump). So are the perf,
device and wire planes (utils/perf.py, utils/device_telemetry.py,
utils/wire_telemetry.py), ticked on the pump; the device plane samples
the card on a node that verifies on it, and no device on a node that
verifies on the CPU. `unported_planes` is `()`: the node builds every
plane its config asks for. `notary_cluster_shards > 0` builds the
batching notary over a DistributedUniquenessProvider
(node/distributed_uniqueness.py): the state-ref space partitioned
across `cluster_peers`, its coordinator and reservation journals on the
node database, recovered at boot and ticked on the pump. `web_port >= 0`
binds the web gateway (client/webserver.py, with the ledger explorer of
tools/web_explorer.py mounted) before the NodeInfo freezes, advertises
its port through the network map and serves once boot is done.

Reference: `AbstractNode.start()` boot ordering (node/.../internal/
AbstractNode.kt:163-222 — database, services, messaging, notary, SMM,
scheduler, network-map registration) and `Node` (Node.kt:125-344 —
embedded broker, RPC server start, the message pump `run()` loop);
CLI entry `NodeStartup` (NodeStartup.kt:44-99).

The "broker" is the node's own durable fabric endpoint (fabric.py) —
there is no separate broker process; signature verification drains
into the batch SPI (in-process or via the out-of-process verifier
pool, NodeConfiguration.verifierType); the pump loop is the single
server thread every service runs on (AffinityExecutor.kt role).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Optional

from ..crypto import schemes
from ..crypto.batch_verifier import BatchSignatureVerifier
from ..flows.statemachine import StateMachineManager
from . import network_map as nm
from . import rpc as rpclib
from .config import NodeConfig
from .cordapp import port_module_name
from .fabric import FabricEndpoint, PeerAddress, TlsIdentity
from .notary import (
    InMemoryUniquenessProvider,
    BatchingNotaryService,
    SimpleNotaryService,
    ValidatingNotaryService,
)
from .persistence import (
    NodeDatabase,
    PersistentKVStore,
    PersistentServiceHub,
    PersistentUniquenessProvider,
)
from .scheduler import NodeSchedulerService
from .services import (
    Clock,
    IdentityService,
    NodeInfo,
    SERVICE_NETWORK_MAP,
    SERVICE_NOTARY,
    SERVICE_NOTARY_VALIDATING,
)


class Node:
    """One production node process (reference: Node.kt).

    Lifecycle: `Node(config).start()` boots everything and registers
    with the network map; `run()` enters the pump loop (blocks);
    `stop()` shuts down. `rpc_client(...)` builds a loopback client for
    embedded use (tests, the shell).
    """

    def __init__(
        self,
        config: NodeConfig,
        clock: Optional[Clock] = None,
        batch_verifier: Optional[BatchSignatureVerifier] = None,
    ):
        self.config = config
        # CorDapps first: their import registers states/commands with
        # the canonical codec (decoding a peer's transaction needs the
        # classes) and @initiated_by responders with the flow registry
        # (reference: CorDapp scan before SMM start, AbstractNode.kt:427)
        import importlib

        for module in config.cordapps:
            importlib.import_module(port_module_name(module))
        os.makedirs(config.base_dir, exist_ok=True)
        self.db = NodeDatabase(os.path.join(config.base_dir, "node.db"))

        # persistent boot counter: per-boot RNG streams (flow/session
        # ids, fresh confidential keys) must NEVER repeat across
        # restarts — a restarted dev node that re-seeded identically
        # would mint the exact session ids of its previous life, and
        # peers silently route them into old, ended sessions (found by
        # the notary kill-restart soak: the post-restart notarisation
        # hung forever with no error anywhere)
        from .persistence import PersistentKVStore

        _meta = PersistentKVStore(self.db, "node_meta")
        _prev = _meta.get(b"boot_count")
        self.boot_count = (
            int.from_bytes(_prev, "big") if _prev else 0
        ) + 1
        _meta.put(b"boot_count", self.boot_count.to_bytes(8, "big"))

        # -- identity (persisted across restarts; AbstractNode obtains
        # it from the node CA keystore, KeyStoreUtilities.kt) ---------
        self.keypair = self._load_or_create_identity()
        from ..core.identity import Party

        self.party = Party(config.name, self.keypair.public)

        # -- TLS channel identity (self-signed; pinned via network map)
        self.tls = self._load_or_create_tls() if config.use_tls else None

        advertised: tuple[str, ...] = ()
        if config.notary in ("simple", "raft", "bft"):
            # BFT is non-validating, like the reference's
            # BFTNonValidatingNotaryService (its only BFT flavour)
            advertised = (SERVICE_NOTARY,)
        elif config.notary in ("validating", "batching", "raft-validating"):
            advertised = (SERVICE_NOTARY_VALIDATING,)
        if config.is_network_map_host:
            advertised = advertised + (SERVICE_NETWORK_MAP,)

        # distributed notary members share one service identity derived
        # from (cluster_name, cluster_key_seed); the key installs into
        # key management so any member can sign for the cluster
        self._cluster_identity = None
        self._cluster_keypair = None
        if config.notary in ("raft", "raft-validating", "bft"):
            from .config import ConfigError

            if config.name not in config.cluster_peers:
                raise ConfigError(
                    f"{config.notary} notary needs cluster_peers including "
                    f"this node"
                )
        if config.notary in ("raft", "raft-validating") or (
            config.notary == "batching" and config.notary_cluster_shards > 0
        ):
            # the distributed-uniqueness batching cluster shares one
            # service identity exactly like the raft cluster: every
            # member answers (and signs) for the cluster party
            from ..core.identity import Party as _Party

            self._cluster_keypair = self._derive_keypair(
                f"{config.cluster_name}:{config.cluster_key_seed}"
            )
            self._cluster_identity = _Party(
                config.cluster_name, self._cluster_keypair.public
            )
        elif config.notary == "bft":
            # BFT: composite f+1 identity over per-member keys, all
            # derivable from the shared (cluster_name, cluster_key_seed)
            # config — dev-mode key provisioning, like the raft shared
            # key (production distributes real key material out of band)
            from ..core.identity import Party as _Party
            from ..crypto.composite import CompositeKey

            member_kps = {
                peer: self._bft_member_keypair(peer)
                for peer in config.cluster_peers
            }
            self._cluster_keypair = member_kps[config.name]
            f = (len(config.cluster_peers) - 1) // 3
            composite = CompositeKey.build(
                [member_kps[p].public for p in config.cluster_peers],
                threshold=f + 1,
            )
            self._cluster_identity = _Party(config.cluster_name, composite)

        self.info = NodeInfo(
            address=config.name,
            legal_identity=self.party,
            advertised_services=advertised,
            host=config.p2p_host,
            port=0,   # patched after the fabric binds (ephemeral ports)
            tls_fingerprint=self.tls.fingerprint if self.tls else None,
            cluster_identity=self._cluster_identity,
        )

        if batch_verifier is None and config.verifier_backend == "cpu":
            from ..crypto.batch_verifier import CpuBatchVerifier

            batch_verifier = CpuBatchVerifier()

        # -- services over one shared database -------------------------
        self.services = PersistentServiceHub.open(
            "",   # path unused: db is shared
            self.info,
            IdentityService(self.party),
            self.keypair,
            clock=clock,
            batch_verifier=batch_verifier,
            rng=random.Random(self._dev_seed("kms", per_boot=True)),
            db=self.db,
        )

        # -- fabric endpoint -------------------------------------------
        self.messaging = FabricEndpoint(
            config.name,
            self.keypair,
            self.db,
            resolve=self._resolve_peer,
            host=config.p2p_host,
            port=config.p2p_port,
            tls=self.tls,
        )
        # inbound connections claiming a map-registered name must prove
        # they hold that identity's key (fabric.py _auth_server); without
        # this, any peer could claim "Bob" and inject session messages
        self.messaging.expected_identity_key = self._expected_identity_key

        # -- network map (host or client) ------------------------------
        self.network_map_service: Optional[nm.NetworkMapService] = None
        self.network_map_client: Optional[nm.NetworkMapClient] = None
        if config.is_network_map_host:
            self.network_map_service = nm.NetworkMapService(
                self.messaging,
                self.services.clock,
                db=self.db,
                services=self.services,
            )
        else:
            self.network_map_client = nm.NetworkMapClient(
                self.services,
                self.messaging,
                config.network_map_peer,
                self.keypair.private,
            )

        # -- metrics + tracing (MonitoringService's MetricRegistry;
        # serve with node.webserver() -> GET /metrics in prometheus
        # format, the JMX/Jolokia role of Node.kt:306-308, and the
        # hot-path flight recorder at GET /traces). Created BEFORE the
        # notary so its batching counters/phase timers land on this
        # node's scrape surface. The tracer is the process default:
        # disabled unless CORDA_TPU_TRACE=1 (utils/tracing.py).
        from ..utils import tracing
        from ..utils.health import ClusterHealth, HealthMonitor
        from ..utils.metrics import MetricRegistry
        from ..utils.perf import PerfPlane, PerfPolicy

        self.metrics = MetricRegistry()
        self.tracer = tracing.get_tracer()
        # every plane the config asks for is built (none is left out)
        self.unported_planes = ()
        # performance-attribution plane (utils/perf.py): kernel
        # first-call-vs-execute accounting (it adopts the process
        # default, so every CudaBatchVerifier this process builds records
        # into it), per-shard skew, the in-process history + baseline
        # diff, and the sampling profiler. Created BEFORE the notary so
        # attach_perf can wire the flush feeds.
        self.perf = None
        if config.perf_enabled:
            self.perf = PerfPlane(
                clock=self.services.clock,
                metrics=self.metrics,
                tracer=self.tracer,
                policy=PerfPolicy(
                    profile_hz=config.perf_profile_hz or 19.0
                ),
                baseline_path=config.perf_baseline or None,
            )
        # QoS plane (node/qos.py): installed with the batching notary
        # when config.qos_enabled; None keeps every hot path unchanged
        self.qos = None
        # health plane (utils/health.py): watchdog over every long-
        # lived loop, SLO/shed/ring alert rules, the canary probe and
        # the JSON-lines event log — served at GET /healthz + /health,
        # rolled up fleet-wide at GET /cluster. Created BEFORE the
        # notary so the flush loop can register its heartbeat.
        self.health = HealthMonitor(
            clock=self.services.clock,
            metrics=self.metrics,
            tracer=self.tracer,
            event_log_path=os.path.join(
                config.base_dir, "health_events.jsonl"
            ),
        )
        self._hb_pump = self.health.heartbeat("messaging.pump")
        self._hb_raft = self._hb_bft = None
        self._canary_fn = None
        self.cluster_health = ClusterHealth(
            config.name,
            lambda: self.health.snapshot(summary=True),
            self._health_peer_urls,
            clock_fn=self.services.clock.now_micros,
        )
        # cross-node trace assembly (utils/tracing.ClusterTraces):
        # GET /cluster/trace/<id> pulls matching span sets from every
        # peer's flight recorder over the same advertised web_port the
        # health rollup rides, merges them clock-offset-adjusted
        self.cluster_traces = tracing.ClusterTraces(
            config.name,
            self.tracer,
            self._peer_web_urls,
        )
        # incident forensics (utils/health.IncidentRecorder): every
        # firing alert snapshots a durable bundle — alert + slowest
        # matching traces WITH their remote halves + metrics snapshot
        # + event tail — to base_dir/incidents, served at /incidents
        from ..utils.health import IncidentRecorder

        self.incidents = IncidentRecorder(
            os.path.join(config.base_dir, "incidents"),
            clock_fn=self.services.clock.now_micros,
            assemble=self.cluster_traces.assemble,
        )
        self.health.attach_incidents(
            self.incidents, node=config.name, background=True
        )
        # transaction provenance plane (utils/txstory.py): the per-tx
        # lifecycle ledger every serving-path seam emits into, with
        # Tx.Stage.* histograms on /metrics. Created BEFORE the notary
        # so every flavour can attach; `services.txstory` is the seam
        # the flavour-shared commit_and_sign path reads.
        self.txstory = None
        self.cluster_tx = None
        if config.txstory_enabled:
            from ..utils.txstory import ClusterTxStory, TxStory

            index = None
            if config.txstory_index:
                from .persistence import TxStoryIndex

                index = TxStoryIndex(self.db)
            self.txstory = TxStory(
                metrics=self.metrics,
                clock=self.services.clock,
                tracer=self.tracer,
                index=index,
            )
            self.services.txstory = self.txstory
            self.cluster_tx = ClusterTxStory(
                config.name,
                self.txstory,
                self._peer_web_urls,
                tracer=self.tracer,
            )
            if config.txstory_stage_slo_micros > 0:
                t = config.txstory_stage_slo_micros
                self.health.watch_txstory(
                    self.txstory,
                    {"queue": t, "verify": t, "commit": t},
                )

        # -- flows, notary, scheduler ----------------------------------
        # @corda_service instances from the imported cordapps, before
        # any flow can run (installCordaServices, AbstractNode.kt:226)
        from .cordapp import install_cordapp_services

        install_cordapp_services(self.services, config.cordapps)
        self.smm = StateMachineManager(
            self.services, self.messaging,
            rng=random.Random(self._dev_seed("smm", per_boot=True)),
        )
        self._install_notary()
        # device telemetry and capacity attribution (utils/
        # device_telemetry.py): per-device memory/busy/queue/transfer
        # over the card, fed by the process device accounting every
        # CudaBatchVerifier records into, and the capacity model naming
        # the binding constraint. Built AFTER the notary so attach_device
        # can map its queues and bridge the degraded-mode flag.
        self.device_plane = None
        self._device_plane_error = None
        if config.device_telemetry_enabled:
            from ..utils.device_telemetry import DevicePlane, DeviceSampler, host_devices
            from .notary import _on_card

            self.device_plane = DevicePlane(
                clock=self.services.clock,
                metrics=self.metrics,
                perf=self.perf,
                # a node that verifies on the CPU samples the host as one
                # cpu device; one on the card samples the card (and
                # raises without it)
                sampler=(DeviceSampler() if _on_card(self.services)
                         else DeviceSampler(host_devices)),
            )
            notary = getattr(self.services, "notary_service", None)
            if isinstance(notary, BatchingNotaryService):
                notary.attach_device(self.device_plane)
            self.health.watch_device(self.device_plane)
        # wire telemetry (utils/wire_telemetry.py): per-link frame/byte
        # accounting pushed by the fabric's seams, codec cost split
        # native vs Python, journal append/commit latency, redelivery/
        # dedupe/backlog depths pulled per tick, joined into the
        # capacity model as the "wire" resource via the device plane.
        self.wire_plane = None
        if config.wire_telemetry_enabled:
            from ..utils.wire_telemetry import WirePlane

            self.wire_plane = WirePlane(
                clock=self.services.clock,
                metrics=self.metrics,
            )
            self.wire_plane.attach_fabric(self.messaging)
            self.health.watch_wire(self.wire_plane)
            if self.device_plane is not None:
                self.device_plane.set_wire_feed(
                    self.wire_plane.wire_host_seconds)
        self.scheduler = NodeSchedulerService(self.services, self.smm.start_flow)

        # -- verifier offload ------------------------------------------
        self.verifier_service = None
        if config.verifier_type == "out_of_process":
            from .verifier import (
                OutOfProcessTransactionVerifierService,
                RedispatchPolicy,
            )

            self.verifier_service = OutOfProcessTransactionVerifierService(
                self.messaging,
                metrics=self.metrics,
                register_peer=self._register_worker_peer,
                clock=self.services.clock,
                policy=RedispatchPolicy(
                    lease_micros=config.verifier_lease_micros,
                    backoff_base_micros=config.verifier_redispatch_backoff,
                ),
            )
            self.services.transaction_verifier = self.verifier_service
            # pool-degraded alerting: a lost worker (or a starved
            # pool) pages before client timeouts do
            self.verifier_service.watch_health(self.health)
            # per-attempt verify history on the lifecycle ledger
            self.verifier_service.txstory = self.txstory

        # -- RPC --------------------------------------------------------
        users = [
            rpclib.RpcUser(u.username, u.password, tuple(u.permissions))
            for u in config.rpc_users
        ]
        self.rpc_ops = rpclib.CordaRPCOpsImpl(self.services, self.smm)
        self.rpc_server = rpclib.RPCServer(
            self.rpc_ops,
            self.messaging,
            rpclib.RPCUserService(*users),
            client_backlog=self._peer_backlog,
        )

        self._worker_peers: dict[str, PeerAddress] = {}
        self.running = False

    def _derive_keypair(self, material: str) -> schemes.KeyPair:
        """Dev-mode key derivation from shared config material (cluster
        service keys; production distributes real keys out of band)."""
        import hashlib

        return schemes.generate_keypair(
            self.config.scheme_id,
            seed=int.from_bytes(
                hashlib.sha256(material.encode()).digest()[:16], "big"
            ),
        )

    def _bft_member_keypair(self, member: str) -> schemes.KeyPair:
        cfg = self.config
        return self._derive_keypair(
            f"{cfg.cluster_name}:{cfg.cluster_key_seed}:{member}"
        )

    def _dev_seed(self, purpose: str, per_boot: bool = False):
        """Deterministic per-(node, purpose) RNG seed in dev mode, None
        (OS entropy) otherwise. The node name is mixed in: two dev nodes
        must never share a fresh-key stream, or each would hold the
        other's 'anonymous' private keys.

        per_boot additionally mixes the persistent boot counter: id/key
        streams that must not repeat across restarts (session ids, flow
        ids, fresh confidential keys) get a new stream every boot while
        staying reproducible for a given (node, boot) pair. Identity and
        cluster keys stay boot-independent — they must re-derive the
        SAME key after a restart."""
        if not self.config.dev_mode:
            return None
        import hashlib

        material = f"{self.config.name}:{self.config.key_seed}:{purpose}"
        if per_boot:
            material += f":boot{self.boot_count}"
        return int.from_bytes(
            hashlib.sha256(material.encode()).digest()[:8], "big"
        )

    # -- identity persistence ------------------------------------------------

    def _load_or_create_identity(self) -> schemes.KeyPair:
        store = PersistentKVStore(self.db, "node_identity")
        blob = store.get(b"private")
        if blob is not None:
            scheme_id = int.from_bytes(blob[:4], "big")
            return schemes.keypair_from_private(scheme_id, blob[4:])
        cfg = self.config
        seed = self._dev_seed("identity") if cfg.key_seed else None
        kp = schemes.generate_keypair(cfg.scheme_id, seed=seed)
        store.put(
            b"private",
            kp.private.scheme_id.to_bytes(4, "big") + kp.private.data,
        )
        return kp

    def _load_or_create_tls(self) -> TlsIdentity:
        # registered material first: --initial-registration stored a
        # doorman-certified TLS key+chain under certificates/tls.pem
        # (registration.py NetworkRegistrationHelper); fall back to the
        # dev-mode self-signed identity persisted in the node DB
        import os

        tls_pem = os.path.join(
            self.config.base_dir, "certificates", "tls.pem"
        )
        if os.path.exists(tls_pem):
            with open(tls_pem, "rb") as f:
                blob = f.read()
            # file layout: key PEM, then leaf cert, then the CA chain;
            # the fabric serves (and peers pin) the leaf only
            marker = b"-----BEGIN CERTIFICATE-----"
            leaf_start = blob.find(marker)
            if leaf_start == -1:
                raise RuntimeError(
                    f"{tls_pem} contains no CERTIFICATE block — the "
                    "file is corrupt or truncated; restore it or "
                    "delete it and re-run --initial-registration"
                )
            leaf_end = blob.index(marker, leaf_start + 1) \
                if blob.count(marker) > 1 else len(blob)
            return TlsIdentity(
                blob[leaf_start:leaf_end], blob[:leaf_start]
            )
        store = PersistentKVStore(self.db, "node_tls")
        cert, key = store.get(b"cert"), store.get(b"key")
        if cert is not None and key is not None:
            return TlsIdentity(bytes(cert), bytes(key))
        tls = TlsIdentity.generate(self.config.name)
        store.put(b"cert", tls.cert_pem)
        store.put(b"key", tls.key_pem)
        return tls

    # -- peer resolution -----------------------------------------------------

    def _resolve_peer(self, peer: str) -> Optional[PeerAddress]:
        """Fabric bridge target lookup: network map first (host, port,
        pinned fingerprint travel in NodeInfo), then ad-hoc worker
        registrations, then the statically-configured map host."""
        info = self.services.network_map_cache.node_by_name(peer)
        if info is not None and info.host is not None and info.port:
            return PeerAddress(info.host, info.port, info.tls_fingerprint)
        if peer in self._worker_peers:
            return self._worker_peers[peer]
        cfg = self.config
        if peer == cfg.network_map_peer and cfg.network_map_host:
            return PeerAddress(
                cfg.network_map_host,
                cfg.network_map_port,
                cfg.network_map_fingerprint,
            )
        return None

    def _register_worker_peer(self, name: str, host: str, port: int) -> None:
        self._worker_peers[name] = PeerAddress(host, port)

    def _expected_identity_key(self, peer: str):
        info = self.services.network_map_cache.node_by_name(peer)
        return None if info is None else info.legal_identity.owning_key

    def _peer_backlog(self, peer: str) -> int:
        """Outbound journal depth for one peer — the RPC server's
        dead-client detector."""
        rows = self.db.query(
            "SELECT COUNT(*) FROM fabric_out WHERE peer=?", (peer,)
        )
        return rows[0][0]

    # -- health plane ---------------------------------------------------------

    def _peer_web_urls(self) -> dict:
        """Base gateway URL per network-map peer that advertises a web
        port — the one peer list both the health rollup and the
        cross-node trace assembler ride."""
        out: dict[str, str] = {}
        for info in self.services.network_map_cache.all_nodes():
            name = info.legal_identity.name
            if name == self.config.name:
                continue
            if info.host and info.web_port:
                out[name] = f"http://{info.host}:{info.web_port}"
        return out

    def _health_peer_urls(self) -> dict:
        """The cluster rollup's peer list: every network-map node that
        advertises a web gateway (NodeInfo.web_port) answers
        GET /health?summary=1 there."""
        return {
            name: f"{base}/health?summary=1"
            for name, base in self._peer_web_urls().items()
        }

    def _launch_canary(self, complete) -> None:
        """One canary notarisation through the REAL flush path
        (utils/health.py notary_canary_fn does the work; this indirection
        exists so the probe always sees the CURRENT notary service)."""
        from ..utils.health import notary_canary_fn

        if self._canary_fn is None:
            self._canary_fn = notary_canary_fn(
                self.services, self.party, tracer=self.tracer
            )
        self._canary_fn(complete)

    # -- notary ---------------------------------------------------------------

    def _build_qos(self) -> None:
        """SLO plane for the serving path: deadline shedding, priority
        lanes, admission gating and the adaptive batching controller,
        on the node's registry so /metrics carries Qos.*. An
        operator-configured batching window is the controller's CEILING
        (it tunes inside the fence, never past the configured bound);
        unset (0) falls back to the policy default ceiling."""
        from .qos import NotaryQos, QosPolicy

        self.qos = NotaryQos(
            QosPolicy(
                target_p99_micros=self.config.qos_target_p99_micros,
                max_wait_micros=(
                    self.config.notary_batch_wait_micros
                    or QosPolicy.max_wait_micros
                ),
                admission_rate_per_sec=(
                    self.config.qos_admission_rate_per_sec
                ),
                admission_burst=self.config.qos_admission_burst,
            ),
            clock=self.services.clock,
            metrics=self.metrics,
        )
        # shed/admit events land on the lifecycle ledger with the tx
        # id attached (qos.admit_tx / shed_tx)
        self.qos.txstory = self.txstory

    def _build_state_store(self, n_shards: int):
        """Mount the commit-log committed-state registry
        (node/statestore.py) under <base_dir>/statestore, drain the
        sqlite tables into it (ONE-WAY boot migration — commit-log
        appends are idempotent, and the sqlite clear runs last, so a
        crash mid-migration simply re-migrates on next boot), and
        export the Statestore.* gauges."""
        from .statestore import (
            ShardedCommitLogUniquenessProvider,
            migrate_sqlite_state,
        )

        store = ShardedCommitLogUniquenessProvider(
            os.path.join(self.config.base_dir, "statestore"), n_shards
        )
        migrate_sqlite_state(self.db, store)
        self.statestore = store

        def stat(key):
            return lambda s=store, k=key: s.stats()[k]

        self.metrics.gauge(
            "Statestore.CommittedStates", stat("committed_states")
        )
        self.metrics.gauge("Statestore.Segments", stat("segments"))
        self.metrics.gauge(
            "Statestore.SnapshotStates", stat("snapshot_states")
        )
        self.metrics.gauge(
            "Statestore.MemtableStates", stat("memtable_states")
        )
        self.metrics.gauge("Statestore.Compactions", stat("compactions"))
        return store

    def _per_card_verifiers(self, shards: int) -> Optional[list]:
        """One card-pinned verifier per notary shard
        (batch_verifier.per_shard_verifiers) where the notary has
        several shards, the backend is the card, the node was handed no
        batch verifier and this process sees several cards; None
        otherwise, so every shard dispatches to the hub's verifier, as
        on one card. D11: an error building them stops the boot, where
        the reference serves on the shared verifier instead: a node must
        not quietly serve on fewer cards than it found. Unlike the
        reference, a verifier handed to the node is never bypassed."""
        import torch

        if (shards <= 1 or self.config.verifier_backend == "cpu"
                or self.services._batch_verifier is not None
                or torch.cuda.device_count() <= 1):
            return None
        from ..crypto.batch_verifier import per_shard_verifiers

        return per_shard_verifiers(shards)

    def _gauge_committed_states(self, uniqueness) -> None:
        # set-growth without a scan: every backend maintains the count
        # O(1), so health/capacity can watch it for free
        self.metrics.gauge(
            "Notary.CommittedStates",
            lambda u=uniqueness: u.committed_count,
        )

    def _install_distributed_uniqueness(self) -> None:
        """The batching notary over a DistributedUniquenessProvider: the
        state-ref space partitioned across the cluster members named in
        cluster_peers (ShardMap), cross-member transactions taking the
        fabric two-phase reserve→commit with the presumed-abort WAL on
        this node's database. The member signs with the cluster service
        identity, exactly like a raft member."""
        from .distributed_uniqueness import (
            DistributedUniquenessProvider,
            XShardPolicy,
        )
        from .notary import _on_card
        from .persistence import (
            NotaryIntentJournal,
            ShardedPersistentUniquenessProvider,
            XShardCoordinatorJournal,
            XShardReservationJournal,
        )

        cfg = self.config
        self.services.key_management.register_keypair(self._cluster_keypair)
        if cfg.qos_enabled:
            self._build_qos()
        if cfg.notary_state_store == "commitlog":
            store = self._build_state_store(cfg.notary_cluster_shards)
        else:
            store = ShardedPersistentUniquenessProvider(
                self.db, cfg.notary_cluster_shards
            )
        self._gauge_committed_states(store)
        provider = DistributedUniquenessProvider(
            cfg.name,
            list(cfg.cluster_peers),
            self.messaging,
            self.services.clock,
            n_partitions=cfg.notary_cluster_shards,
            store=store,
            journal=XShardCoordinatorJournal(self.db),
            reservations=XShardReservationJournal(self.db),
            metrics=self.metrics,
            tracer=self.tracer,
            qos=self.qos,
            policy=XShardPolicy(
                timeout_micros=cfg.notary_xshard_timeout_micros,
                backoff_base_micros=cfg.notary_xshard_backoff,
                backoff_cap_micros=20 * cfg.notary_xshard_backoff,
            ),
            seed=self._dev_seed("xshard") or 0,
        )
        provider.txstory = self.txstory
        # boot recovery BEFORE serving: commit-marked WAL intents
        # re-drive, unmarked ones presumed-abort, journaled
        # reservations reload as immediate orphans
        provider.recover()
        self.xshard = provider
        intent_journal = None
        if cfg.notary_intent_wal:
            intent_journal = NotaryIntentJournal(self.db)
        self.services.notary_service = BatchingNotaryService(
            self.services,
            provider,
            service_identity=self._cluster_identity,
            max_wait_micros=cfg.notary_batch_wait_micros,
            metrics=self.metrics,
            qos=self.qos,
            # D2: a card verifier takes no CPU fallback
            degraded_fallback=(
                cfg.notary_degraded_fallback and not _on_card(self.services)
            ),
            intent_journal=intent_journal,
        )
        self.services.notary_service.attach_txstory(self.txstory)
        if intent_journal is not None:
            self.services.notary_service.replay_intents()
        self.services.notary_service.attach_health(self.health)
        provider.attach_health(self.health)
        if self.qos is not None:
            self.health.watch_qos(self.qos)
        self.health.attach_canary(self._launch_canary)
        if self.perf is not None:
            self.services.notary_service.attach_perf(self.perf)
            self.health.watch_perf(self.perf)

    def _install_notary(self) -> None:
        kind = self.config.notary
        self.raft = None
        self.bft = None
        self.xshard = None
        self.statestore = None
        if kind == "":
            return
        if kind == "batching" and self.config.notary_cluster_shards > 0:
            self._install_distributed_uniqueness()
            return
        if kind in ("simple", "validating", "batching"):
            # sharded commit plane: >1 shard — or a node
            # whose DB already migrated to partition tables (the
            # layout is STICKY: once rows live in notary_commits_s<k>,
            # EVERY notary kind must read the partitions — a revert to
            # the legacy provider would consult the emptied legacy
            # table and silently accept double-spends of already
            # consumed states)
            from .persistence import ShardedPersistentUniquenessProvider

            shards = self.config.notary_shards
            stored = PersistentKVStore(
                self.db, ShardedPersistentUniquenessProvider._META_SPACE
            ).get(b"shards")
            if kind == "batching" and shards > 1:
                pass                           # explicit sharded plane
            elif stored is not None:
                if kind == "batching" and shards >= 1:
                    # an explicit count on a partitioned DB is a retune
                    # — 1 included, which migrates the rows back DOWN
                    # into a single partition
                    shards = max(shards, 1)
                else:
                    # unset (0) or a non-batching kind: keep the stored
                    # partition count — re-partitioning every boot
                    # would churn the rows for nothing, and reading the
                    # emptied legacy table instead would silently
                    # accept double-spends
                    shards = max(int.from_bytes(stored, "big"), 1)
            else:
                shards = 0                     # classic legacy layout
            if self.config.notary_state_store == "commitlog":
                # the segmented commit log + mmap hash index replaces
                # the sqlite tables; a one-way boot migration drains
                # whichever layout they held (legacy or partitioned)
                shards = max(self.config.notary_shards, 1)
                uniqueness = self._build_state_store(shards)
            elif shards:
                uniqueness = ShardedPersistentUniquenessProvider(
                    self.db, shards
                )
            else:
                uniqueness = PersistentUniquenessProvider(self.db)
            self._gauge_committed_states(uniqueness)
            if kind == "batching":
                # D2: a card verifier takes no CPU fallback, so the flag
                # holds only where neither the hub's verifier nor a
                # shard's runs on the card
                from .notary import _on_card, verifier_on_card

                shard_verifiers = self._per_card_verifiers(shards)
                degraded_fallback = (
                    self.config.notary_degraded_fallback
                    and not _on_card(self.services)
                    and not any(map(verifier_on_card, shard_verifiers or ()))
                )

                if self.config.qos_enabled:
                    self._build_qos()
                intent_journal = None
                if self.config.notary_intent_wal:
                    # durable intake: intents share the node database
                    # (same file, same WAL-mode fsync discipline as the
                    # fabric journals)
                    from .persistence import NotaryIntentJournal

                    intent_journal = NotaryIntentJournal(self.db)
                self.services.notary_service = BatchingNotaryService(
                    self.services,
                    uniqueness,
                    max_wait_micros=self.config.notary_batch_wait_micros,
                    metrics=self.metrics,
                    qos=self.qos,
                    shards=max(shards, 1),
                    shard_workers=self.config.notary_shard_workers,
                    shard_verifiers=shard_verifiers,
                    degraded_fallback=degraded_fallback,
                    intent_journal=intent_journal,
                )
                self.services.notary_service.attach_txstory(self.txstory)
                if intent_journal is not None:
                    # boot replay: requests admitted-but-in-flight at
                    # the last crash re-enter the normal flush path;
                    # uniqueness dedupe absorbs already-committed ones
                    self.services.notary_service.replay_intents()
                # health plane over the serving path: the flush loop's
                # heartbeat, the SLO burn-rate + shed-ratio rules (when
                # QoS is on), and the canary probe riding real flushes
                self.services.notary_service.attach_health(self.health)
                if self.qos is not None:
                    self.health.watch_qos(self.qos)
                self.health.attach_canary(self._launch_canary)
                # perf plane over the same path: flush phase marks feed
                # the skew/overlap telemetry, the served-request counter
                # becomes the in-process notarisations/s history, and
                # the retrace + skew alerts land on the health monitor
                if self.perf is not None:
                    self.services.notary_service.attach_perf(self.perf)
                    self.health.watch_perf(self.perf)
                return
            cls = {
                "simple": SimpleNotaryService,
                "validating": ValidatingNotaryService,
            }[kind]
            self.services.notary_service = cls(self.services, uniqueness)
            return
        if kind in ("raft", "raft-validating"):
            from .raft import RaftNode, RaftUniquenessProvider

            self.services.key_management.register_keypair(
                self._cluster_keypair
            )

            def factory(apply_fn, **raft_kw):
                return RaftNode(
                    self.config.name,
                    list(self.config.cluster_peers),
                    self.messaging,
                    apply_fn,
                    self.services.clock,
                    cluster=self.config.cluster_name,
                    db=self.db,
                    rng=random.Random(self._dev_seed("raft")),
                    # consensus observability: Raft.Phase.* timers +
                    # lag gauges on this node's scrape surface, phase
                    # spans joined to propagated client traces, applied
                    # commits stamped onto the lifecycle ledger
                    metrics=self.metrics,
                    tracer=self.tracer,
                    txstory=self.txstory,
                    **raft_kw,
                )

            provider = RaftUniquenessProvider(factory)
            self.raft = provider.raft
            cls = (
                SimpleNotaryService if kind == "raft"
                else ValidatingNotaryService
            )
            self.services.notary_service = cls(
                self.services,
                provider,
                service_identity=self._cluster_identity,
            )
            return
        if kind == "bft":
            from .bft import BftReplica, BFTNotaryService

            # sign replies with the derived member key, not the node key
            self.services.key_management.register_keypair(
                self._cluster_keypair
            )
            replica = BftReplica(
                self.config.name,
                list(self.config.cluster_peers),
                self.messaging,
                lambda cmd, ts: (None, None),
                self.services.clock,
                cluster=self.config.cluster_name,
                rng=random.Random(self._dev_seed("bft")),
                metrics=self.metrics,
                tracer=self.tracer,
                txstory=self.txstory,
            )
            self.bft = replica
            self.services.notary_service = BFTNotaryService(
                self.services,
                replica,
                self._cluster_identity,
                member_key=self._cluster_keypair.public,
                member_keys={
                    peer: self._bft_member_keypair(peer).public
                    for peer in self.config.cluster_peers
                },
            )
            # config-path invariant: production clusters always run in
            # signed-certificate mode — the hook-less fallback of
            # _valid_prepared_entry is reachable only from unit rigs
            # that wire a bare BftReplica
            if replica.sign_prepare_fn is None or (
                replica.verify_prepare_fn is None
            ):
                raise AssertionError(
                    "BFT notary booted without prepare-signature hooks"
                )
            return
        raise NotImplementedError(f"unknown notary kind {kind!r}")

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Node":
        import dataclasses

        self.messaging.start()
        # web gateway bound BEFORE the NodeInfo freezes (its port is
        # advertised through the network map so peers can pull
        # GET /health for the /cluster rollup) but not yet SERVING:
        # answering /healthz during a slow boot (checkpoint restore,
        # map registration) would feed an orchestrator 503s and
        # restart-loop exactly the slow-starting nodes. A bind failure
        # (port taken) must not strand a half-started node.
        self.web = None
        if self.config.web_port >= 0:
            u = self.config.rpc_users[0]
            try:
                self.web = self._build_webserver(
                    u.username, u.password, port=self.config.web_port
                )
            except Exception:
                self.stop()
                raise
        # the fabric bound its listen port; advertise the real one
        self.info = dataclasses.replace(
            self.info,
            port=self.messaging.listen_port,
            web_port=self.web.port if self.web is not None else None,
        )
        self.services.my_info = self.info
        self.services.network_map_cache.add_node(self.info)
        self.services.identity.register(self.party)
        if self.network_map_client is not None:
            self.network_map_client.register()
            self.network_map_client.fetch(subscribe=True)
        if self.network_map_service is not None:
            # the map host publishes its own NodeInfo so clients learn
            # its identity (and, when it doubles as a notary, that too)
            reg = nm.NodeRegistration(
                info=self.info,
                serial=self.services.clock.now_micros(),
                op=nm.ADD,
                expires_micros=self.services.clock.now_micros()
                + nm.NetworkMapClient.DEFAULT_TTL_MICROS,
            )
            try:
                self.network_map_service._process_registration(
                    nm.sign_registration(reg, self.keypair.private)
                )
            except ValueError:
                pass   # restart within one clock microsecond: already registered
        restored = self.smm.restore_checkpoints()
        if restored:
            logging.getLogger("corda_tpu_torch.node").info(
                "restored %d checkpointed flows", restored
            )
        self.running = True
        if self.web is not None:
            self.web.start()
        if self.perf is not None and self.config.perf_profile_hz > 0:
            # continuous profiling over this node's long-lived threads,
            # started after boot so first launches don't dominate
            self.perf.profiler.start()
        # boot work (map registration, checkpoint restore) may exceed
        # the watchdog deadline: the pump loop starts NOW, so its
        # heartbeat clock does too
        self._hb_pump.beat()
        return self

    def _tick_services(self) -> None:
        self.scheduler.tick()
        self.smm.tick()
        notary = getattr(self.services, "notary_service", None)
        if isinstance(notary, BatchingNotaryService):
            # the pump interval is the batch deadline: everything that
            # queued since the last pump shares one SPI dispatch
            notary.tick()
        if self.verifier_service is not None:
            # pool self-healing: lease expiry, redispatch backoff and
            # hedging all walk on the pump cadence
            self.verifier_service.tick()
        if self.xshard is not None:
            # distributed uniqueness: resend schedules, reserve-phase
            # timeouts, commit re-drives and orphan queries all walk
            # on the pump cadence too
            self.xshard.tick()
        if self.statestore is not None:
            # commit-log compaction walks on the pump cadence: fold
            # piled-up sealed segments into the next snapshot
            # generation off the serving path
            self.statestore.maintain()
        if self.raft is not None:
            if self._hb_raft is None:
                self._hb_raft = self.health.heartbeat("raft.driver")
            self.raft.tick()
            self._hb_raft.beat()
        if self.bft is not None:
            if self._hb_bft is None:
                self._hb_bft = self.health.heartbeat("bft.driver")
            self.bft.tick()
            self._hb_bft.beat()
        if self.network_map_client is not None:
            # liveness heartbeat: periodic map re-registration keeps
            # the explorer's last-seen column meaningful
            self.network_map_client.tick()
        if self.txstory is not None:
            # lifecycle ledger: group-commit the sqlite index buffer
            self.txstory.tick()
        # health plane last: the watchdog judges the beats this tick
        # just made, the canary launches, alert rules walk their states
        self.health.tick()
        if self.perf is not None:
            # history sampling rides the same cadence (self-throttled
            # to the perf policy's sample gap)
            self.perf.tick()
        if self.device_plane is not None:
            # after health.tick, so rules judge last-sample state
            try:
                self.device_plane.tick()
            except RuntimeError as e:
                # a node on the card whose host has none: the sampler
                # raises, as its verifier does at its first check; the
                # error is logged once and the pump keeps serving
                if self._device_plane_error is None:
                    self._device_plane_error = str(e)
                    logging.getLogger("corda_tpu_torch.node").error(
                        "%s: device plane: %s", self.config.name, e)
        if self.wire_plane is not None:
            # fabric depths (journal/dedupe/backlog), self-throttled alike
            self.wire_plane.tick()

    def run(self) -> None:
        """The pump loop — the single server thread (Node.kt:344)."""
        import threading

        self._run_thread = threading.current_thread()
        try:
            while self.running:
                n = self.messaging.pump(block=True, timeout=0.2)
                self._hb_pump.beat(progress=n)
                self._tick_services()
        finally:
            self._run_thread = None

    def pump(self, timeout: float = 0.0) -> int:
        """One pump step (embedded/driver use)."""
        n = self.messaging.pump(block=timeout > 0, timeout=timeout)
        self._hb_pump.beat(progress=n)
        self._tick_services()
        return n

    def stop(self) -> None:
        import threading

        # idempotence keys on its own flag, NOT on `running`: the CLI
        # signal handler clears `running` to break the pump loop, and
        # the finally-block stop() after it must still tear down (web
        # gateway, fabric, db) instead of early-returning
        if getattr(self, "_stopped", False):
            return
        self._stopped = True
        self.running = False
        perf = getattr(self, "perf", None)
        if perf is not None:
            perf.profiler.stop()
        # an embedded run() thread must drain its current pump before
        # the database closes under it
        run_thread = getattr(self, "_run_thread", None)
        if (
            run_thread is not None
            and run_thread is not threading.current_thread()
        ):
            run_thread.join(timeout=5)
        web = getattr(self, "web", None)
        if web is not None:
            web.stop()
        self.scheduler.stop()
        self.smm.stop()
        notary = getattr(self.services, "notary_service", None)
        if isinstance(notary, BatchingNotaryService):
            notary.stop()   # shard worker threads, when running
        if getattr(self, "xshard", None) is not None:
            self.xshard.stop()
        if self.raft is not None:
            self.raft.stop()
        if self.bft is not None:
            self.bft.stop()
        self.messaging.stop()
        if getattr(self, "statestore", None) is not None:
            # the commit-log index is an mmap: close it with its files
            self.statestore.close()
        self.db.close()

    # -- conveniences ---------------------------------------------------------

    @property
    def vault(self):
        return self.services.vault

    def rpc_client(self, username: str, password: str) -> rpclib.RPCClient:
        """Loopback RPC client on this node's own endpoint (the shell's
        connection — InteractiveShell talks to the node the same way a
        remote client does)."""
        return rpclib.RPCClient(
            self.messaging, self.config.name, username, password
        )

    def webserver(self, username: str, password: str, port: int = 0):
        """Embedded web gateway over the node's own RPC surface, with
        this node's MetricRegistry at /metrics, the flight recorder at
        /traces, the QoS plane (when enabled) at /qos, the health
        plane at /healthz + /health, the fleet rollup at /cluster,
        the perf plane at /perf (+ folded profiler stacks at
        /profile), the device plane at /device + the capacity model at
        /capacity, the ledger explorer UI at /web/explorer/, and the
        wire and gateway plane at /wire. The node's pump loop (run())
        drives message delivery, so the gateway itself only polls
        futures (pass a real pump when embedding without run())."""
        return self._build_webserver(username, password, port).start()

    def _build_webserver(self, username: str, password: str, port: int = 0):
        """Bind the gateway without serving yet — start() begins the
        accept loop once the node is fully booted (the bound port is
        what NodeInfo.web_port advertises)."""
        from ..client.webserver import NodeWebServer
        from ..tools import web_explorer  # noqa: F401 - /api/explorer

        return NodeWebServer(
            self.rpc_client(username, password),
            pump=lambda: None,
            port=port,
            metrics=self.metrics,
            tracer=self.tracer,
            qos=self.qos,
            health=self.health,
            cluster=self.cluster_health,
            perf=self.perf,
            cluster_traces=self.cluster_traces,
            incidents=self.incidents,
            shards=self.xshard,
            txstory=self.txstory,
            cluster_tx=self.cluster_tx,
            device=self.device_plane,
            wire=self.wire_plane,
            statestore=self.statestore,
            slow_request_micros=self.config.web_slow_request_micros,
        )


def banner(config: NodeConfig) -> str:
    return (
        "\n   ______               __         ______ ___  __  __\n"
        "  / ____/___  _________/ /___ _   /_  __// _ \\/ / / /\n"
        " / /   / __ \\/ ___/ __  / __ `/    / /  / ___/ /_/ /\n"
        "/ /___/ /_/ / /  / /_/ / /_/ /    / /  / /  / __  /\n"
        "\\____/\\____/_/   \\__,_/\\__,_/    /_/  /_/  /_/ /_/\n\n"
        f"  node: {config.name}   notary: {config.notary or 'none'}   "
        f"map: {'host' if config.is_network_map_host else config.network_map_peer}\n"
    )
