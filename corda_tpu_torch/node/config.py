"""Node configuration: typed schema + TOML loading.

Port of corda_tpu/node/config.py, with the reference's schema,
defaults, validation and TOML writer: a node.toml written by either
package is byte-equal and loads in the other. `verifier_backend =
"tpu"` names the port's accelerator verifier, a CudaBatchVerifier on
"cuda"; "cpu" names CpuBatchVerifier. `cordapps` keeps the reference's
module names (`corda_tpu.finance`); the port's node imports each as its
`corda_tpu_torch.` counterpart.

Reference: `NodeConfiguration` (node/.../config/NodeConfiguration.kt:
21-101) bound reflectively from HOCON files (node-api/.../config/
ConfigUtilities.kt `parseAs`), with `reference.conf` defaults and
per-node `node.conf`. Here the schema is a dataclass, the file format
is TOML (stdlib tomllib — no HOCON in Python), and unknown keys are
rejected the way the reference's strict binding is.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from ..crypto import schemes

_SCHEME_NAMES = {
    "rsa": schemes.RSA_SHA256,
    "secp256k1": schemes.ECDSA_SECP256K1_SHA256,
    "secp256r1": schemes.ECDSA_SECP256R1_SHA256,
    "ed25519": schemes.EDDSA_ED25519_SHA512,
}

NOTARY_KINDS = (
    "", "simple", "validating", "batching",
    "raft", "raft-validating", "bft",
)
VERIFIER_TYPES = ("in_memory", "out_of_process")


class ConfigError(Exception):
    pass


@dataclass(frozen=True)
class RpcUserConfig:
    """One RPC login (NodeConfiguration.kt rpcUsers)."""

    username: str
    password: str
    permissions: tuple[str, ...] = ()


@dataclass(frozen=True)
class NodeConfig:
    """The full node configuration (NodeConfiguration.kt:21-101).

    `name` doubles as the node's fabric peer name; `network_map_peer`
    names the directory node (empty = this node hosts the map, the
    reference's NetworkMapService advertisement); `notary` selects the
    service flavour installed at boot (AbstractNode.kt:635-643).
    """

    name: str
    base_dir: str
    p2p_host: str = "127.0.0.1"
    p2p_port: int = 0                       # 0 = ephemeral (dev)
    network_map_peer: str = ""
    network_map_host: str = ""
    network_map_port: int = 0
    network_map_fingerprint: Optional[bytes] = None
    notary: str = ""
    # batching-notary deadline, microseconds: 0 flushes every pump
    # tick; positive holds arrivals until the oldest has waited this
    # long (or the batch fills), trading bounded latency for deeper —
    # faster — flushes (notary.py BatchingNotaryService)
    notary_batch_wait_micros: int = 0
    # sharded commit plane (batching notary only): partition the
    # uniqueness namespace by state-ref prefix into this many shards,
    # each with its own bounded pending queue, flush pipeline,
    # partition table and (devices permitting) device-pinned verify
    # dispatch. 0/1 = the classic single-queue plane. A count change is
    # a safe boot-time migration (rows re-route into the new partition
    # tables).
    notary_shards: int = 0
    # committed-state registry backend: "sqlite" (the per-shard
    # `notary_commits_s<k>` tables) or "commitlog" (the billion-state
    # segmented commit log + mmap hash index under
    # <base_dir>/statestore, node/statestore.py). Switching to
    # commitlog runs a ONE-WAY boot migration out of the sqlite
    # tables; accept/reject decisions are bit-exact across backends.
    notary_state_store: str = "sqlite"
    # give every shard a dedicated flush worker thread (the pump then
    # only routes and resolves answers); False flushes shards from the
    # pump tick as a dispatch-all-then-consume wave
    notary_shard_workers: bool = False
    # durable intake WAL (batching notary only): admitted
    # requests journal to a sqlite intent table BEFORE queueing and
    # replay through the normal flush path on boot — in-flight-at-kill
    # loss goes to zero (persistence.py NotaryIntentJournal)
    notary_intent_wal: bool = False
    # distributed sharded uniqueness (node/
    # distributed_uniqueness.py): partition the state-ref space into
    # this many partitions ACROSS the notary cluster members named in
    # cluster_peers — each member owns partition k where
    # k % len(cluster_peers) picks it, cross-member transactions take
    # the fabric two-phase reserve→commit, and the ownership map is
    # served at GET /shards. 0 = off (single-node planes above).
    # Requires notary = "batching" and this node in cluster_peers;
    # mutually exclusive with notary_shards > 1 (the in-process and
    # cross-member planes partition the same namespace differently).
    notary_cluster_shards: int = 0
    # cross-shard per-phase silence timeout, microseconds: a partition
    # owner that never acks within this window yields a typed
    # `shard-unavailable` answer instead of a hang
    notary_xshard_timeout_micros: int = 2_000_000
    # base of the capped exponential cross-shard retry/resend backoff,
    # microseconds (seeded jitter rides on top)
    notary_xshard_backoff: int = 50_000
    # degraded-mode verify (batching notary): a device/kernel failure
    # at the dispatch seam retries once, then serves the flush through
    # the CPU reference verifier (bit-exact) with the
    # notary.degraded_mode alert firing until a device probe succeeds
    notary_degraded_fallback: bool = True
    # out-of-process verifier pool self-healing (node/verifier.py):
    # worker lease TTL — a worker silent past this window detaches and
    # its in-flight work re-dispatches to a survivor
    verifier_lease_micros: int = 10_000_000
    # base of the capped exponential redispatch backoff, microseconds
    verifier_redispatch_backoff: int = 100_000
    # QoS / overload control for the batching notary (node/qos.py):
    # enabled, the notary gets deadline shedding, a per-client
    # admission gate on the request path, the adaptive batching
    # controller (which then treats notary_batch_wait_micros as its
    # CEILING — it tunes the live window inside [0, that bound]) and
    # the GET /qos surface on the web gateway; the priority-lane
    # router additionally engages wherever a ring-seam fabric routes
    # wire frames through it (messaging.add_ring)
    qos_enabled: bool = False
    # the SLO the adaptive controller holds: admitted-request p99
    # completion latency, microseconds
    qos_target_p99_micros: int = 50_000
    # per-client token-bucket admission at the fabric seam: sustained
    # requests/sec per sender (0 disables) and burst capacity
    qos_admission_rate_per_sec: int = 0
    qos_admission_burst: int = 256
    # performance-attribution plane (utils/perf.py): kernel
    # compile-vs-execute accounting, per-shard skew telemetry, the
    # in-process bench history and the GET /perf surface. On by
    # default — the telemetry is passive counters; only the sampling
    # profiler costs anything, and it stays unstarted at hz 0.
    perf_enabled: bool = True
    # continuous sampling profiler rate over the node's long-lived
    # threads, in samples/sec (0 = no sampler thread; GET /profile can
    # still run an on-demand capture). 19 Hz measures <1% of the flush
    # wall — keep it off round pump cadences to avoid aliasing.
    perf_profile_hz: float = 0.0
    # committed BENCH_r*.json record the node diffs its own sustained
    # throughput history against ("notarisations/s regressed 12% vs
    # BENCH_r06" without an offline bench run); empty = no baseline
    perf_baseline: str = ""
    # device telemetry & capacity-attribution plane (utils/
    # device_telemetry.py): per-device HBM/busy/queue/transfer
    # telemetry at GET /device, the roofline capacity model naming the
    # binding constraint at GET /capacity, Device.<k>.* gauges on
    # /metrics and the device.hbm_pressure / device.fallback_active /
    # device.utilization_collapse health rules. On by default —
    # passive counters plus one sampler pass per pump second; on CPU
    # backends memory stats degrade to null, never a failure.
    device_telemetry_enabled: bool = True
    # wire & gateway telemetry plane (utils/wire_telemetry.py):
    # per-link fabric accounting + codec cost attribution at GET
    # /wire, the `wire` resource in the GET /capacity roofline,
    # Wire.*/Gateway.* gauges on /metrics and the wire.journal_growth
    # / wire.backlog / gateway.saturated health rules. On by default —
    # passive counters at the fabric seams plus a few COUNT queries
    # per pump second (<2% of the fabric wall, gated by the bench
    # `wire` metric).
    wire_telemetry_enabled: bool = True
    # the web gateway logs handlers slower than this (microseconds,
    # 0 = off): requests that steal pump time are visible in the log
    # before the wire plane is even queried
    web_slow_request_micros: int = 50_000
    # transaction provenance plane (utils/txstory.py): the per-tx
    # lifecycle ledger behind GET /tx/<id> + /tx/slowest and the
    # Tx.Stage.* histograms. On by default — bounded memory, one lock
    # + append per lifecycle event (<2% of the flush wall, gated by
    # the bench `txstory` metric).
    txstory_enabled: bool = True
    # spill the event stream to a sqlite index in the node database
    # (same WAL discipline as the intent journal): ring-evicted
    # transactions stay queryable at GET /tx/<id>
    txstory_index: bool = False
    # stage-SLO rule target, microseconds (0 = rule off): the
    # `txstory.stage_slo` alert fires when any serving stage's
    # (queue / verify / commit) recent p99 exceeds this, citing the
    # offending tx ids in its detail
    txstory_stage_slo_micros: int = 0
    verifier_type: str = "in_memory"
    # which BatchSignatureVerifier backs signature checks: "tpu" (the
    # accelerator's batch kernels: in this package a CudaBatchVerifier
    # on the card) or "cpu" (the bit-exact reference)
    verifier_backend: str = "tpu"
    dev_mode: bool = True
    key_seed: int = 0                       # dev: deterministic identity
    scheme: str = "ed25519"
    use_tls: bool = True
    # web gateway (REST + /web/explorer/) port: -1 = disabled (default),
    # 0 = ephemeral. Serving requires an rpc user for the gateway's own
    # node connection (the reference's standalone webserver
    # authenticates the same way)
    web_port: int = -1
    rpc_users: tuple[RpcUserConfig, ...] = field(default_factory=tuple)
    # notary cluster membership (raft/bft): peer names of all members
    cluster_peers: tuple[str, ...] = ()
    # distributed notary service identity: cluster name + dev-mode key
    # seed (every member configured alike derives the same shared
    # service key; production would distribute it out of band)
    cluster_name: str = "DistributedNotary"
    cluster_key_seed: int = 1
    # CorDapp modules imported at boot: registers contract/state classes
    # with the codec and @initiated_by responders (the reference's
    # CorDapp classpath scan, AbstractNode.kt:427)
    # the reference's module names; node.py reads `corda_tpu.` as
    # `corda_tpu_torch.` when it imports them
    cordapps: tuple[str, ...] = ("corda_tpu.finance",)
    # permissioning server URL for --initial-registration
    # (NodeConfiguration certificateSigningService; registration.py)
    registration_server: str = ""
    # operator contact submitted with the signing request
    # (NodeConfiguration.kt emailAddress)
    email: str = ""
    # optional out-of-band pinned network-root certificate (PEM file):
    # registration refuses a returned chain under any other root
    network_root_file: str = ""

    def __post_init__(self):
        if not self.name:
            raise ConfigError("node.name is required")
        if self.notary not in NOTARY_KINDS:
            raise ConfigError(
                f"unknown notary kind {self.notary!r}; one of {NOTARY_KINDS}"
            )
        if self.verifier_type not in VERIFIER_TYPES:
            raise ConfigError(
                f"unknown verifier_type {self.verifier_type!r}"
            )
        if self.verifier_backend not in ("tpu", "cpu"):
            raise ConfigError(
                f"unknown verifier_backend {self.verifier_backend!r}"
            )
        if self.scheme not in _SCHEME_NAMES:
            raise ConfigError(
                f"unknown scheme {self.scheme!r}; one of {sorted(_SCHEME_NAMES)}"
            )
        if self.web_port >= 0 and not self.rpc_users:
            raise ConfigError(
                "web_port requires at least one [[rpc.users]] entry "
                "(the gateway connects over RPC)"
            )
        if self.qos_enabled and self.qos_target_p99_micros <= 0:
            raise ConfigError(
                "qos_target_p99_micros must be positive when qos_enabled"
            )
        if self.qos_enabled and self.notary != "batching":
            raise ConfigError(
                "qos_enabled requires notary = 'batching' (the QoS "
                "plane steers the batching notary's flush)"
            )
        if self.notary_shards < 0:
            raise ConfigError("notary_shards must be >= 0")
        if self.notary_shards > 1 and self.notary != "batching":
            raise ConfigError(
                "notary_shards requires notary = 'batching' (only the "
                "batching notary has a sharded commit plane)"
            )
        if self.notary_shard_workers and self.notary_shards <= 1:
            raise ConfigError(
                "notary_shard_workers requires notary_shards > 1"
            )
        if self.notary_state_store not in ("sqlite", "commitlog"):
            raise ConfigError(
                "notary_state_store must be 'sqlite' or 'commitlog'"
            )
        if (
            self.notary_state_store == "commitlog"
            and self.notary in ("raft", "raft-validating", "bft")
        ):
            raise ConfigError(
                "notary_state_store = 'commitlog' serves the batching/"
                "simple/validating and distributed planes — the raft "
                "and bft notaries replicate their own store"
            )
        if self.notary_intent_wal and self.notary != "batching":
            raise ConfigError(
                "notary_intent_wal requires notary = 'batching' (only "
                "the batching notary has a durable intake queue)"
            )
        if self.notary_cluster_shards < 0:
            raise ConfigError("notary_cluster_shards must be >= 0")
        if self.notary_cluster_shards > 0:
            if self.notary != "batching":
                raise ConfigError(
                    "notary_cluster_shards requires notary = 'batching' "
                    "(the distributed uniqueness plane serves the "
                    "batching notary's commit path)"
                )
            if self.name not in self.cluster_peers:
                raise ConfigError(
                    "notary_cluster_shards needs cluster_peers "
                    "including this node (the ownership map is computed "
                    "from the member list)"
                )
            if self.notary_shards > 1:
                raise ConfigError(
                    "notary_cluster_shards and notary_shards > 1 are "
                    "mutually exclusive (one namespace, one "
                    "partitioning)"
                )
        if self.notary_xshard_timeout_micros <= 0:
            raise ConfigError(
                "notary_xshard_timeout_micros must be positive"
            )
        if self.notary_xshard_backoff <= 0:
            raise ConfigError("notary_xshard_backoff must be positive")
        if self.verifier_lease_micros <= 0:
            raise ConfigError("verifier_lease_micros must be positive")
        if self.verifier_redispatch_backoff < 0:
            raise ConfigError(
                "verifier_redispatch_backoff must be >= 0"
            )
        if self.perf_profile_hz < 0:
            raise ConfigError("perf_profile_hz must be >= 0")
        if self.txstory_stage_slo_micros < 0:
            raise ConfigError("txstory_stage_slo_micros must be >= 0")
        if self.web_slow_request_micros < 0:
            raise ConfigError("web_slow_request_micros must be >= 0")
        if not self.txstory_enabled and (
            self.txstory_index or self.txstory_stage_slo_micros > 0
        ):
            raise ConfigError(
                "txstory_index / txstory_stage_slo_micros require "
                "txstory_enabled (they configure the provenance plane)"
            )
        if not self.perf_enabled and (
            self.perf_profile_hz > 0 or self.perf_baseline
        ):
            raise ConfigError(
                "perf_profile_hz / perf_baseline require perf_enabled "
                "(the profiler and baseline diff live on the perf plane)"
            )

    @property
    def scheme_id(self) -> int:
        return _SCHEME_NAMES[self.scheme]

    @property
    def is_network_map_host(self) -> bool:
        return self.network_map_peer == ""


def load_config(path: str) -> NodeConfig:
    """Parse a TOML node config; strict about unknown keys (typos in a
    config must fail loudly at boot, not silently default)."""
    try:
        import tomllib
    except ModuleNotFoundError:
        # Python < 3.11 has no stdlib TOML parser and the container
        # bakes no third-party one in; fall back to the subset reader
        # below, which covers exactly the dialect write_config emits
        raw = _load_toml_subset(path)
    else:
        with open(path, "rb") as f:
            raw = tomllib.load(f)
    return config_from_dict(raw)


def _load_toml_subset(path: str) -> dict:
    """Minimal TOML reader for the config dialect this codebase
    round-trips (`write_config`): `[section]` / `[[section.array]]`
    headers and `key = value` pairs whose values are JSON-compatible
    TOML — basic strings, integers, floats, booleans and arrays of
    strings (true/false and string escaping are shared between the two
    grammars, so each value parses with json.loads). Anything outside
    that subset raises ConfigError naming the line, the same fail-loud
    contract the strict binding gives typos."""
    import json

    root: dict = {}
    current: dict = root
    with open(path, encoding="utf-8") as f:
        for lineno, raw_line in enumerate(f, 1):
            line = raw_line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("[[") and line.endswith("]]"):
                parts = line[2:-2].strip().split(".")
                parent = root
                for key in parts[:-1]:
                    parent = parent.setdefault(key, {})
                current = {}
                parent.setdefault(parts[-1], []).append(current)
                continue
            if line.startswith("[") and line.endswith("]"):
                parts = line[1:-1].strip().split(".")
                parent = root
                for key in parts[:-1]:
                    parent = parent.setdefault(key, {})
                current = parent.setdefault(parts[-1], {})
                continue
            key, sep, value = line.partition("=")
            if not sep:
                raise ConfigError(
                    f"{path}:{lineno}: expected 'key = value', got "
                    f"{line!r}"
                )
            try:
                current[key.strip()] = json.loads(value.strip())
            except ValueError:
                raise ConfigError(
                    f"{path}:{lineno}: unsupported TOML value "
                    f"{value.strip()!r} (the no-tomllib fallback reads "
                    f"only strings, numbers, booleans and string arrays)"
                )
    return root


def config_from_dict(raw: dict) -> NodeConfig:
    node = dict(raw.get("node", {}))
    rpc = dict(raw.get("rpc", {}))
    extra_sections = set(raw) - {"node", "rpc"}
    if extra_sections:
        raise ConfigError(f"unknown config sections {sorted(extra_sections)}")

    users = []
    for u in rpc.pop("users", []):
        unknown = set(u) - {"username", "password", "permissions"}
        if unknown:
            raise ConfigError(f"unknown rpc.users keys {sorted(unknown)}")
        users.append(
            RpcUserConfig(
                u["username"], u["password"], tuple(u.get("permissions", ()))
            )
        )
    if rpc:
        raise ConfigError(f"unknown rpc keys {sorted(rpc)}")

    fp = node.pop("network_map_fingerprint", None)
    if isinstance(fp, str):
        fp = bytes.fromhex(fp)
    known = {f.name for f in dataclasses.fields(NodeConfig)} - {
        "rpc_users", "network_map_fingerprint",
    }
    unknown = set(node) - known
    if unknown:
        raise ConfigError(f"unknown node keys {sorted(unknown)}")
    for key in ("cluster_peers", "cordapps"):
        if key in node:
            node[key] = tuple(node[key])
    try:
        return NodeConfig(
            rpc_users=tuple(users), network_map_fingerprint=fp, **node
        )
    except TypeError as e:
        raise ConfigError(str(e))


def write_config(cfg: NodeConfig, path: str) -> None:
    """Emit a TOML file for `cfg` (the cordformation role: deployments
    and demos generate per-node configs — Cordform.groovy)."""
    import json

    lines = ["[node]"]

    def quote(s: str) -> str:
        # JSON string escaping is valid TOML basic-string escaping
        return json.dumps(str(s))

    def emit(key, value):
        if isinstance(value, bool):
            lines.append(f"{key} = {'true' if value else 'false'}")
        elif isinstance(value, (int, float)):
            lines.append(f"{key} = {value}")
        else:
            lines.append(f"{key} = {quote(value)}")

    emit("name", cfg.name)
    emit("base_dir", cfg.base_dir)
    emit("p2p_host", cfg.p2p_host)
    emit("p2p_port", cfg.p2p_port)
    emit("network_map_peer", cfg.network_map_peer)
    emit("network_map_host", cfg.network_map_host)
    emit("network_map_port", cfg.network_map_port)
    if cfg.network_map_fingerprint is not None:
        emit("network_map_fingerprint", cfg.network_map_fingerprint.hex())
    emit("notary", cfg.notary)
    if cfg.notary_batch_wait_micros:
        emit("notary_batch_wait_micros", cfg.notary_batch_wait_micros)
    if cfg.notary_shards:
        emit("notary_shards", cfg.notary_shards)
        if cfg.notary_shard_workers:
            emit("notary_shard_workers", cfg.notary_shard_workers)
    if cfg.notary_intent_wal:
        emit("notary_intent_wal", cfg.notary_intent_wal)
    if cfg.notary_state_store != "sqlite":
        emit("notary_state_store", cfg.notary_state_store)
    if cfg.notary_cluster_shards:
        emit("notary_cluster_shards", cfg.notary_cluster_shards)
    if cfg.notary_xshard_timeout_micros != 2_000_000:
        emit("notary_xshard_timeout_micros", cfg.notary_xshard_timeout_micros)
    if cfg.notary_xshard_backoff != 50_000:
        emit("notary_xshard_backoff", cfg.notary_xshard_backoff)
    if not cfg.notary_degraded_fallback:
        emit("notary_degraded_fallback", cfg.notary_degraded_fallback)
    if cfg.verifier_lease_micros != 10_000_000:
        emit("verifier_lease_micros", cfg.verifier_lease_micros)
    if cfg.verifier_redispatch_backoff != 100_000:
        emit("verifier_redispatch_backoff", cfg.verifier_redispatch_backoff)
    if cfg.qos_enabled:
        emit("qos_enabled", cfg.qos_enabled)
        emit("qos_target_p99_micros", cfg.qos_target_p99_micros)
        if cfg.qos_admission_rate_per_sec:
            emit("qos_admission_rate_per_sec", cfg.qos_admission_rate_per_sec)
            emit("qos_admission_burst", cfg.qos_admission_burst)
    if not cfg.perf_enabled:
        emit("perf_enabled", cfg.perf_enabled)
    if not cfg.device_telemetry_enabled:
        emit("device_telemetry_enabled", cfg.device_telemetry_enabled)
    if not cfg.wire_telemetry_enabled:
        emit("wire_telemetry_enabled", cfg.wire_telemetry_enabled)
    if cfg.web_slow_request_micros != 50_000:
        emit("web_slow_request_micros", cfg.web_slow_request_micros)
    if cfg.perf_profile_hz:
        emit("perf_profile_hz", cfg.perf_profile_hz)
    if cfg.perf_baseline:
        emit("perf_baseline", cfg.perf_baseline)
    if not cfg.txstory_enabled:
        emit("txstory_enabled", cfg.txstory_enabled)
    if cfg.txstory_index:
        emit("txstory_index", cfg.txstory_index)
    if cfg.txstory_stage_slo_micros:
        emit("txstory_stage_slo_micros", cfg.txstory_stage_slo_micros)
    emit("verifier_type", cfg.verifier_type)
    emit("verifier_backend", cfg.verifier_backend)
    emit("dev_mode", cfg.dev_mode)
    emit("key_seed", cfg.key_seed)
    emit("scheme", cfg.scheme)
    emit("use_tls", cfg.use_tls)
    if cfg.web_port >= 0:
        emit("web_port", cfg.web_port)
    emit("cluster_name", cfg.cluster_name)
    emit("cluster_key_seed", cfg.cluster_key_seed)
    if cfg.registration_server:
        emit("registration_server", cfg.registration_server)
    if cfg.email:
        emit("email", cfg.email)
    if cfg.network_root_file:
        emit("network_root_file", cfg.network_root_file)
    if cfg.cluster_peers:
        peers = ", ".join(quote(p) for p in cfg.cluster_peers)
        lines.append(f"cluster_peers = [{peers}]")
    apps = ", ".join(quote(a) for a in cfg.cordapps)
    lines.append(f"cordapps = [{apps}]")
    for u in cfg.rpc_users:
        lines.append("")
        lines.append("[[rpc.users]]")
        emit("username", u.username)
        emit("password", u.password)
        perms = ", ".join(quote(p) for p in u.permissions)
        lines.append(f"permissions = [{perms}]")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
