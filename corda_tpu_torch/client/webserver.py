"""REST gateway: HTTP endpoints bridging to a node over RPC.

Port of corda_tpu/client/webserver.py: `NodeWebServer` with every
route of the reference and the same JSON bodies, `WebApiPlugin`,
`register_web_api` and the dispatch wrapper that records each request
into the wire plane's GatewayAccounting. Flows posted here verify as
the node verifies: on the card unless its config says "cpu"; an RPC
error is answered as a JSON error body, never rerouted.

Reference: the standalone `webserver` module (webserver/.../internal/
NodeWebServer.kt:31,171-173) — a Jetty/Jersey process that talks to its
node via RPC and exposes CorDapp REST APIs + static content. Here the
stdlib HTTP server exposes the node surface as JSON (client/jackson's
mapping), one gateway process (or thread) per node.

  GET  /                           endpoint index (what is mounted here)
  GET  /api/status                 identity + clock
  GET  /api/network                network map snapshot
  GET  /api/notaries               notary identities
  GET  /api/vault[?contract=Tag]   unconsumed states
  GET  /api/flows                  registered responder protocols
  POST /api/flows/<FlowClass>      start a flow; JSON body = kwargs

Operational endpoints (wired per gateway): /metrics (Prometheus text),
/traces (flight recorder), /qos (overload control plane), /healthz
(orchestrator liveness, 200/503 from watchdog state), /health (full
health-plane JSON), /cluster (fleet-wide health rollup), /device
(per-device HBM/busy/queue/transfer telemetry), /capacity (the
roofline capacity model naming the binding constraint) and /wire
(per-link fabric accounting, codec cost attribution, gateway request
accounting). Every
response carries an explicit Content-Type — text/plain for /metrics,
application/json everywhere else — and unknown paths (any method) get
a JSON 404 body, never the http.server default stub.
"""

from __future__ import annotations

import json
import logging
import threading
from ..utils import locks
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from ..node import rpc as rpclib
from . import json_support as js
from .common import FlowLookupError, find_flow_class, wait_rpc


# ---------------------------------------------------------------------------
# CorDapp web APIs (WebServerPluginRegistry, NodeWebServer.kt:171-173)


class WebContext:
    """What a CorDapp route handler gets: the RPC client + a wait that
    pumps the fabric — the same power as any RPC client, no more."""

    def __init__(self, gateway: "NodeWebServer"):
        self.client = gateway.client
        self.wait = gateway._wait


@dataclass(frozen=True)
class WebApiPlugin:
    """A CorDapp's REST surface, mounted at /api/<prefix>/<subpath>
    (and /web/<prefix>/<path> for static content). `routes` maps
    (method, subpath) to `handler(ctx, query, body) -> (status,
    jsonable)`; `static` maps path -> (content_type, bytes)."""

    prefix: str
    routes: tuple   # ((method, subpath, handler), ...)
    static: tuple = ()   # ((path, content_type, bytes), ...)

    def route(self, method: str, subpath: str):
        for m, p, h in self.routes:
            if m == method and p == subpath:
                return h
        return None

    def static_for(self, path: str):
        for p, ctype, data in self.static:
            if p == path:
                return ctype, data
        return None


_WEB_PLUGINS: dict[str, WebApiPlugin] = {}


_RESERVED_PREFIXES = frozenset(
    {"status", "network", "notaries", "vault", "flows", "plugins"}
)


def register_web_api(plugin: WebApiPlugin) -> None:
    """Install a CorDapp web API process-wide (call from the cordapp
    module — the ServiceLoader-scan analogue)."""
    if plugin.prefix in _RESERVED_PREFIXES:
        raise ValueError(
            f"prefix {plugin.prefix!r} shadows a built-in /api endpoint"
        )
    existing = _WEB_PLUGINS.get(plugin.prefix)
    if existing is not None and existing != plugin:
        raise ValueError(f"web api prefix {plugin.prefix!r} already taken")
    _WEB_PLUGINS[plugin.prefix] = plugin


def registered_web_apis() -> tuple[WebApiPlugin, ...]:
    return tuple(_WEB_PLUGINS.values())


class NodeWebServer:
    """One gateway over one RPC client. `pump` drives the underlying
    fabric (the node loopback or a console endpoint)."""

    def __init__(
        self,
        client: rpclib.RPCClient,
        pump: Callable[[], None],
        host: str = "127.0.0.1",
        port: int = 0,
        rpc_timeout: float = 90.0,
        metrics=None,
        tracer=None,
        qos=None,
        health=None,
        cluster=None,
        perf=None,
        cluster_traces=None,
        incidents=None,
        shards=None,
        txstory=None,
        cluster_tx=None,
        device=None,
        wire=None,
        statestore=None,
        slow_request_micros: int = 50_000,
    ):
        """`metrics`: an optional MetricRegistry served at GET /metrics
        in prometheus exposition format (the reference exports
        dropwizard metrics over JMX/Jolokia HTTP, Node.kt:306-308).

        `tracer`: an optional utils.tracing.Tracer whose flight
        recorder is served at GET /traces — chrome://tracing-loadable
        trace-event JSON (object form) with a per-stage latency
        summary under `stageSummary`.

        `qos`: an optional node/qos.NotaryQos whose live control-plane
        state (adaptive-controller knobs + admitted p99, brownout
        level, Qos.Shed.* counts, lane depths, admission gate) is
        served as JSON at GET /qos — the operator's overload view next
        to /metrics and /traces.

        `health`: an optional utils/health.HealthMonitor — GET /healthz
        answers 200/503 from live watchdog state (the orchestrator
        liveness probe) and GET /health serves the full health-plane
        JSON (heartbeats, alerts with evidence, canary, event-log
        tail; `?summary=1` for the condensed per-peer form).

        `cluster`: an optional utils/health.ClusterHealth — GET
        /cluster serves the fleet-wide rollup (per-node summaries,
        worst-state, stale marking for unreachable peers).

        `perf`: an optional utils/perf.PerfPlane — GET /perf serves
        the attribution snapshot (kernel compile-vs-execute split,
        host stage seconds, per-shard skew, wave overlap efficiency,
        the in-process history + BENCH baseline diff) and GET /profile
        serves the sampling profiler's collapsed stacks in the
        flamegraph.pl folded format (`?seconds=N` runs an on-demand
        capture when the continuous sampler is off; `?reset=1` clears
        the table after serving).

        `cluster_traces`: an optional utils/tracing.ClusterTraces —
        GET /cluster/trace/<trace_id> serves the cross-node assembly
        of one trace (matching span sets pulled from every peer's
        flight recorder, clock-offset-adjusted, merged into one tree
        with a per-member consensus-phase summary).

        `incidents`: an optional utils/health.IncidentRecorder — GET
        /incidents lists the captured forensics bundles,
        GET /incidents/<id> serves one bundle in full.

        `shards`: an optional node/distributed_uniqueness.
        DistributedUniquenessProvider — GET /shards serves the
        cross-member ownership map (partition -> owner, this member's
        committed/reservation depths, orphan count, unreachable
        owners), the operator's routing-truth view of the distributed
        uniqueness plane.

        `txstory`: an optional utils/txstory.TxStory — GET /tx/<id>
        serves one transaction's lifecycle timeline (admission ->
        flush membership -> per-attempt verify -> commit/terminal,
        with the linked trace id) and GET /tx/slowest the completed-
        transaction leaderboard. `cluster_tx`: an optional
        ClusterTxStory — /tx/<id> then assembles the timeline
        CLUSTER-WIDE (peer stories pulled over the network map,
        clock-shifted onto one axis); `?local=1` serves this member's
        story alone (the peer-pull form).

        `device`: an optional utils/device_telemetry.DevicePlane —
        GET /device serves the per-device telemetry snapshot (HBM
        occupancy + live-buffer census, windowed busy fraction,
        dispatch-queue depth/wait, transfer bandwidth, the degraded-
        fallback bridge) and GET /capacity the roofline capacity
        model: per-resource ceilings + headroom for the notary line
        with the binding constraint NAMED (host_pump |
        device_compute | transfer | commit_plane);
        `?what_if=shards:8,devices:4` substitutes model knobs for
        planning the GIL escape and the next device round.

        `wire`: an optional utils/wire_telemetry.WirePlane — GET /wire
        serves the wire-telemetry snapshot (per-link frame/byte rates
        per peer and topic, CTS codec cost attribution split native
        vs pure-Python, journal append/commit latency quantiles,
        redelivery + dedupe-table depth, per-peer unacked backlog with
        high-water marks, and per-endpoint gateway request
        accounting). Every request through this gateway — whatever
        the outcome — records its endpoint label, handler wall and
        bytes served into the plane, which windows them into
        requests/s and the measured pump-time-stolen fraction.

        `slow_request_micros`: handlers slower than this log a
        WARNING with endpoint + duration (0 disables) — gateway
        requests that steal pump time are visible in the log before
        the wire plane is even queried.

        Every operational endpoint honours `?ts=1`: the payload gains
        a shared process-monotonic `ts_micros` stamp (a trailing
        `# ts_micros` comment on /metrics text), so cross-endpoint
        snapshots — each built under its own lock with its own
        staleness — can be correlated in tests and dashboards."""
        self.client = client
        self.pump = pump
        self.rpc_timeout = rpc_timeout
        self.metrics = metrics
        self.tracer = tracer
        self.qos = qos
        self.health = health
        self.cluster = cluster
        self.perf = perf
        self.cluster_traces = cluster_traces
        self.incidents = incidents
        self.shards = shards
        self.txstory = txstory
        self.cluster_tx = cluster_tx
        self.device = device
        self.wire = wire
        self.statestore = statestore
        self.slow_request_micros = int(slow_request_micros)
        # serializes /profile on-demand captures and resets: without
        # it a second ?seconds=N request returns a partial table and
        # a concurrent ?reset=1 wipes an in-flight capture
        self._profile_lock = locks.make_lock("NodeWebServer._profile_lock")
        self._lock = locks.make_lock(
            "NodeWebServer._lock"
        )   # one RPC conversation at a time
        # the operational surface: path -> (description, handler(query)
        # -> (status, content_type, payload bytes)). ONE table drives
        # dispatch AND the GET / index, so the index can never drift
        # from what is actually mounted.
        self._ops = {
            "/": ("endpoint index", self._serve_index),
            "/metrics": (
                "Prometheus text metrics", self._serve_metrics,
            ),
            "/traces": (
                "flight recorder (chrome://tracing JSON + stage "
                "summary; ?trace_id= ?name= ?limit= filter "
                "server-side)", self._serve_traces,
            ),
            "/incidents": (
                "incident forensics bundles (alerts + assembled "
                "traces + metrics + event tail); /incidents/<id> for "
                "one bundle", self._serve_incidents,
            ),
            "/qos": ("QoS control-plane state", self._serve_qos),
            "/shards": (
                "distributed uniqueness ownership map: partition -> "
                "owner, reservation/orphan depths, unreachable owners",
                self._serve_shards,
            ),
            "/healthz": (
                "liveness probe: 200/503 from watchdog state",
                self._serve_healthz,
            ),
            "/health": (
                "full health plane: heartbeats, alerts, canary, "
                "event log (?summary=1 for the condensed form)",
                self._serve_health,
            ),
            "/cluster": (
                "fleet-wide health rollup over the network-map peers",
                self._serve_cluster,
            ),
            "/device": (
                "per-device telemetry: HBM occupancy + live buffers, "
                "busy fraction, dispatch queue depth/wait, transfer "
                "bandwidth, degraded-fallback bridge",
                self._serve_device,
            ),
            "/capacity": (
                "roofline capacity model: per-resource ceiling + "
                "headroom for the notary line, binding constraint "
                "named (?what_if=shards:8 substitutes knobs)",
                self._serve_capacity,
            ),
            "/wire": (
                "wire & gateway telemetry: per-link frame/byte rates, "
                "codec cost attribution (native vs python CTS), "
                "journal latency quantiles, redelivery/dedupe/backlog, "
                "per-endpoint gateway accounting",
                self._serve_wire,
            ),
            "/statestore": (
                "billion-state committed-state registry: per-shard "
                "segment/snapshot depth, memtable size, compaction "
                "and probe counters for the commit-log backend",
                self._serve_statestore,
            ),
            "/perf": (
                "performance attribution: kernel compile/execute "
                "split, host stages, shard skew, history + baseline "
                "diff", self._serve_perf,
            ),
            "/profile": (
                "sampling profiler collapsed stacks (flamegraph.pl "
                "folded; ?seconds=N on-demand capture, ?reset=1 "
                "clears)", self._serve_profile,
            ),
        }
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # quiet
                pass

            def do_GET(self):
                gateway._handle(self, "GET")

            def do_POST(self):
                gateway._handle(self, "POST")

            def do_PUT(self):
                gateway._reject_method(self, "PUT")

            def do_DELETE(self):
                gateway._reject_method(self, "DELETE")

            def do_PATCH(self):
                gateway._reject_method(self, "PATCH")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "NodeWebServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="webserver",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        # safe on a bound-but-never-started gateway (the node binds
        # early to learn its port, serves only once fully booted):
        # shutdown() would block forever waiting for a serve_forever
        # loop that never ran
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()

    # -- RPC plumbing --------------------------------------------------------

    def _wait(self, fut):
        return wait_rpc(fut, self.pump, self.rpc_timeout)

    # -- response plumbing ---------------------------------------------------

    @staticmethod
    def _send(req, status: int, ctype: str, payload: bytes) -> None:
        # bytes-served tally for the gateway accounting wrapper: every
        # response path funnels through here, so the per-request stash
        # on the handler object can never miss a body
        req._bytes_served = getattr(req, "_bytes_served", 0) + len(payload)
        req.send_response(status)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(payload)))
        req.end_headers()
        req.wfile.write(payload)

    @staticmethod
    def _json(status: int, body) -> tuple[int, str, bytes]:
        return status, "application/json", json.dumps(body).encode()

    @staticmethod
    def _stamp_ts(ctype: str, payload: bytes) -> bytes:
        """The shared `?ts=1` echo: every operational endpoint builds
        its payload under its OWN lock with its own staleness, so
        correlating a /metrics scrape with a /qos or /perf snapshot
        needs a common clock IN the payload. One process-monotonic
        stamp (time.monotonic_ns, immune to wall-clock steps): JSON
        object payloads gain a top-level `ts_micros`, text payloads
        (/metrics, /profile) a trailing `# ts_micros` comment line."""
        ts = time.monotonic_ns() // 1_000
        if ctype.startswith("application/json"):
            try:
                body = json.loads(payload)
            except ValueError:
                return payload
            if isinstance(body, dict):
                body["ts_micros"] = ts
                return json.dumps(body).encode()
            return payload
        return payload.rstrip(b"\n") + f"\n# ts_micros {ts}\n".encode()

    def _reject_method(self, req, method: str) -> None:
        self._send(
            req, 405, "application/json",
            json.dumps(
                {"error": f"method {method} not supported "
                          f"for {urlparse(req.path).path}"}
            ).encode(),
        )

    # -- the operational surface (served without the RPC lock) --------------

    def _serve_index(self, query) -> tuple[int, str, bytes]:
        wired = {
            "/metrics": self.metrics, "/traces": self.tracer,
            "/qos": self.qos, "/healthz": self.health,
            "/health": self.health, "/cluster": self.cluster,
            "/perf": self.perf, "/profile": self.perf,
            "/incidents": self.incidents, "/shards": self.shards,
            "/device": self.device, "/capacity": self.device,
            "/wire": self.wire,
            "/statestore": self.statestore,
        }
        rows = [
            {
                "path": path,
                "description": desc,
                "enabled": (
                    wired[path] is not None if path in wired else True
                ),
            }
            for path, (desc, _) in self._ops.items()
        ]
        # path-parameterized routes (dispatched by prefix, not the
        # _ops table — an exact-match entry could never be hit)
        rows.append({
            "path": "/cluster/trace/<trace_id>",
            "description": (
                "cross-node assembly of one trace: span sets pulled "
                "from every peer's flight recorder, clock-offset "
                "adjusted, merged with a per-member phase summary"
            ),
            "enabled": self.cluster_traces is not None,
        })
        rows.append({
            "path": "/tx/<tx_id>",
            "description": (
                "one transaction's lifecycle timeline, assembled "
                "cluster-wide (admission, flush membership, "
                "per-attempt verify, consensus commit, terminal — "
                "with the linked trace id; ?local=1 for this member "
                "alone)"
            ),
            "enabled": self.txstory is not None,
        })
        rows.append({
            "path": "/tx/slowest",
            "description": (
                "slowest completed transactions: total latency + "
                "per-stage breakdown (?limit=N)"
            ),
            "enabled": self.txstory is not None,
        })
        return self._json(200, {
            "endpoints": sorted(rows, key=lambda r: r["path"]),
            "api": [
                "/api/status", "/api/network", "/api/notaries",
                "/api/vault", "/api/flows", "/api/plugins",
            ],
            "plugins": sorted(_WEB_PLUGINS),
        })

    def _serve_metrics(self, query) -> tuple[int, str, bytes]:
        try:
            text = (
                self.metrics.to_prometheus()
                if self.metrics is not None
                else ""
            )
            status = 200 if self.metrics is not None else 404
        except Exception as e:   # a bad gauge must yield a 500, not
            text = f"# metrics rendering failed: {e}\n"   # a reset
            status = 500
        return status, "text/plain; version=0.0.4", text.encode()

    def _serve_traces(self, query) -> tuple[int, str, bytes]:
        # hot-path traces: the flight recorder's retained traces
        # (N slowest + N most recent) as chrome://tracing-loadable
        # JSON plus the per-stage latency summary — /metrics tells
        # you THAT serving slowed, this tells you WHICH stage.
        # ?trace_id= / ?name= / ?limit= filter SERVER-side (the
        # ClusterTraces pull path, and the cure for serializing the
        # whole recorder per request).
        from ..utils import tracing as tracelib

        try:
            if self.tracer is None:
                return self._json(
                    404, {"error": "tracing not wired on this gateway"}
                )
            tid_text = query.get("trace_id", [None])[0]
            trace_id = None
            if tid_text is not None:
                trace_id = tracelib.parse_trace_id(tid_text)
                if trace_id is None:
                    return self._json(
                        400, {"error": f"bad trace_id {tid_text!r}"}
                    )
            name = query.get("name", [None])[0] or None
            limit_text = query.get("limit", [None])[0]
            limit = None
            if limit_text:
                try:
                    limit = max(0, int(limit_text))
                except ValueError:
                    return self._json(
                        400, {"error": f"bad limit {limit_text!r}"}
                    )
            # serialize INSIDE the guard: a non-JSON span attribute
            # must yield the 500, not a half-written response (span
            # attributes are caller-typed Any)
            return self._json(
                200,
                self.tracer.export(
                    trace_id=trace_id, name=name, limit=limit
                ),
            )
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"trace export failed: {e}"})

    def _serve_cluster_trace(self, tid_text: str) -> tuple[int, str, bytes]:
        from ..utils import tracing as tracelib

        try:
            if self.cluster_traces is None:
                return self._json(
                    404,
                    {"error": "cluster traces not wired on this gateway"},
                )
            trace_id = tracelib.parse_trace_id(tid_text)
            if trace_id is None:
                return self._json(
                    400, {"error": f"bad trace_id {tid_text!r}"}
                )
            out = self.cluster_traces.assemble(trace_id)
            return self._json(200 if out["found"] else 404, out)
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(
                500, {"error": f"cluster trace assembly failed: {e}"}
            )

    def _serve_incidents(self, query) -> tuple[int, str, bytes]:
        try:
            if self.incidents is None:
                return self._json(
                    404,
                    {"error": "incident recorder not wired on this "
                              "gateway"},
                )
            return self._json(200, {
                "incidents": self.incidents.list(),
                "recorded": self.incidents.recorded,
            })
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"incident list failed: {e}"})

    def _serve_incident(self, incident_id: str) -> tuple[int, str, bytes]:
        try:
            if self.incidents is None:
                return self._json(
                    404,
                    {"error": "incident recorder not wired on this "
                              "gateway"},
                )
            bundle = self.incidents.load(incident_id)
            if bundle is None:
                return self._json(
                    404, {"error": f"no incident {incident_id!r}"}
                )
            return self._json(200, bundle)
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"incident load failed: {e}"})

    def _serve_qos(self, query) -> tuple[int, str, bytes]:
        # the QoS control plane's live state: shed counters,
        # adaptive-controller knobs vs target, brownout level,
        # lane depths — /metrics tells you the node slowed, THIS
        # tells you what the overload machinery is doing about it
        try:
            if self.qos is not None:
                return self._json(200, self.qos.snapshot())
            return self._json(
                404,
                {"enabled": False, "error": "qos not wired on this gateway"},
            )
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"qos snapshot failed: {e}"})

    def _serve_shards(self, query) -> tuple[int, str, bytes]:
        # the distributed uniqueness plane's routing truth: which
        # member owns which partition, how many reservations this
        # member holds (and how many are orphaned), which owners the
        # cross-shard protocol currently cannot reach
        try:
            if self.shards is not None:
                return self._json(200, self.shards.shards_snapshot())
            return self._json(
                404,
                {"error": "distributed uniqueness not wired on this "
                          "gateway"},
            )
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"shards snapshot failed: {e}"})

    def _serve_tx_slowest(self, query) -> tuple[int, str, bytes]:
        # the completed-transaction leaderboard: total admission->
        # terminal micros with the per-stage breakdown — the "which
        # transactions were slow" entry point /metrics p99s can't give
        try:
            if self.txstory is None:
                return self._json(
                    404,
                    {"error": "transaction provenance not wired on "
                              "this gateway"},
                )
            limit_text = query.get("limit", [None])[0]
            limit = None
            if limit_text:
                try:
                    limit = max(0, int(limit_text))
                except ValueError:
                    return self._json(
                        400, {"error": f"bad limit {limit_text!r}"}
                    )
            return self._json(200, {
                "slowest": self.txstory.slowest(limit),
                "summary": self.txstory.snapshot(),
            })
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"tx leaderboard failed: {e}"})

    def _serve_tx(self, tx_id: str, query) -> tuple[int, str, bytes]:
        # one transaction's lifecycle timeline. Default = cluster-wide
        # assembly (events from every member on one clock-shifted
        # axis); ?local=1 = this member's story + ClockSync evidence
        # (the form peers pull, so assembly can't recurse)
        try:
            if self.txstory is None:
                return self._json(
                    404,
                    {"error": "transaction provenance not wired on "
                              "this gateway"},
                )
            if not tx_id:
                return self._json(400, {"error": "empty tx id"})
            local = query.get("local", ["0"])[0] not in ("", "0")
            if local or self.cluster_tx is None:
                out = self.txstory.local_payload(tx_id)
            else:
                out = self.cluster_tx.assemble(tx_id)
            return self._json(200 if out.get("found") else 404, out)
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"tx story failed: {e}"})

    def _serve_healthz(self, query) -> tuple[int, str, bytes]:
        # orchestrator liveness: judged LIVE against the watchdog (the
        # pump that would have ticked the monitor may be the very
        # thread that stalled), tiny payload, 200/503
        try:
            if self.health is None:
                return self._json(
                    404, {"error": "health plane not wired on this gateway"}
                )
            ok, detail = self.health.healthz()
            return self._json(200 if ok else 503, detail)
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"healthz failed: {e}"})

    def _serve_health(self, query) -> tuple[int, str, bytes]:
        try:
            if self.health is None:
                return self._json(
                    404, {"error": "health plane not wired on this gateway"}
                )
            summary = query.get("summary", ["0"])[0] not in ("", "0")
            return self._json(200, self.health.snapshot(summary=summary))
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"health snapshot failed: {e}"})

    def _serve_cluster(self, query) -> tuple[int, str, bytes]:
        try:
            if self.cluster is None:
                return self._json(
                    404,
                    {"error": "cluster rollup not wired on this gateway"},
                )
            return self._json(200, self.cluster.snapshot())
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"cluster rollup failed: {e}"})

    def _serve_device(self, query) -> tuple[int, str, bytes]:
        # per-device telemetry: HBM occupancy (absent-not-fatal on
        # CPU backends — the hbm section reads null), windowed busy
        # fraction and queue depth/wait per chip, transfer bandwidth,
        # and the degraded-fallback bridge — the chips' side of the
        # story every host-facing plane so far left invisible
        try:
            if self.device is None:
                return self._json(
                    404,
                    {"error": "device telemetry not wired on this "
                              "gateway"},
                )
            return self._json(200, self.device.snapshot())
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(
                500, {"error": f"device snapshot failed: {e}"}
            )

    def _serve_capacity(self, query) -> tuple[int, str, bytes]:
        # the roofline answer: which resource binds the notary line
        # next (host_pump | device_compute | transfer | commit_plane),
        # per-resource ceilings + headroom, one operator-readable
        # sentence. ?what_if=shards:8,devices:4 substitutes model
        # knobs for planning the GIL escape / the next device round.
        from ..utils import device_telemetry as devlib

        try:
            if self.device is None:
                return self._json(
                    404,
                    {"error": "device telemetry not wired on this "
                              "gateway"},
                )
            what_if_text = query.get("what_if", [None])[0]
            what_if = None
            if what_if_text:
                try:
                    what_if = devlib.parse_what_if(what_if_text)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
            return self._json(200, self.device.capacity(what_if))
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(
                500, {"error": f"capacity model failed: {e}"}
            )

    def _serve_wire(self, query) -> tuple[int, str, bytes]:
        # the wire's side of the story: what the fabric's per-frame
        # encode/decode + journal writes cost (split by codec path —
        # the native rewrite's exact prize), which links carry the
        # bytes, and what this gateway itself steals from the pump
        try:
            if self.wire is None:
                return self._json(
                    404,
                    {"error": "wire telemetry not wired on this "
                              "gateway"},
                )
            return self._json(200, self.wire.snapshot())
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"wire snapshot failed: {e}"})

    def _serve_statestore(self, query) -> tuple[int, str, bytes]:
        # the committed-state registry's shape: how deep the snapshot
        # is, how much unfolded tail the memtable carries, how often
        # compaction folds — the reading guide lives in
        # docs/node-administration.md ("Billion-state store")
        try:
            if self.statestore is None:
                return self._json(
                    404,
                    {"error": "commit-log state store not wired on "
                              "this gateway (notary_state_store = "
                              "sqlite?)"},
                )
            return self._json(200, self.statestore.stats())
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(
                500, {"error": f"statestore snapshot failed: {e}"}
            )

    def _serve_perf(self, query) -> tuple[int, str, bytes]:
        # the attribution snapshot: /metrics tells you THAT serving
        # slowed, /traces WHICH request was slow — this tells you WHY:
        # which host stage, which kernel shape (compile vs execute),
        # which shard, and whether the node already regressed vs its
        # committed bench baseline
        try:
            if self.perf is None:
                return self._json(
                    404, {"error": "perf plane not wired on this gateway"}
                )
            return self._json(200, self.perf.snapshot())
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"perf snapshot failed: {e}"})

    def _serve_profile(self, query) -> tuple[int, str, bytes]:
        # folded collapsed stacks — pipe straight into flamegraph.pl /
        # speedscope. With the continuous sampler off, ?seconds=N runs
        # a blocking on-demand capture on this request thread (the
        # gateway is a ThreadingHTTPServer: other endpoints keep
        # answering meanwhile).
        try:
            if self.perf is None:
                return self._json(
                    404, {"error": "perf plane not wired on this gateway"}
                )
            prof = self.perf.profiler
            seconds = float(query.get("seconds", ["0"])[0] or 0)
            with self._profile_lock:
                # under the lock a concurrent ?seconds=N waits for the
                # in-flight capture (then reads the FULL table) and a
                # ?reset=1 cannot wipe a capture mid-flight
                if seconds > 0 and not prof.running:
                    prof.start()
                    time.sleep(min(seconds, 60.0))
                    prof.stop()
                text = prof.collapsed()
                if not text:
                    text = (
                        "# no samples (profiler not started; try "
                        "?seconds=2)"
                    )
                if query.get("reset", ["0"])[0] not in ("", "0"):
                    prof.clear()
            return 200, "text/plain", (text + "\n").encode()
        except Exception as e:   # noqa: BLE001 - defensive render
            return self._json(500, {"error": f"profile export failed: {e}"})

    # -- dispatch ------------------------------------------------------------

    def _endpoint_label(self, path: str) -> str:
        """Normalize a request path to a bounded endpoint label (the
        gateway accounting's row key): path-parameterized routes
        collapse onto one row each, so a scan of random tx ids cannot
        grow the table without bound."""
        if path in self._ops:
            return path
        if path.startswith("/web/"):
            return "/web/<prefix>"
        if path.startswith("/cluster/trace/"):
            return "/cluster/trace/<trace_id>"
        if path.startswith("/incidents/"):
            return "/incidents/<id>"
        if path == "/tx/slowest":
            return "/tx/slowest"
        if path.startswith("/tx/"):
            return "/tx/<tx_id>"
        parts = [p for p in path.split("/") if p]
        if parts[:1] == ["api"]:
            return "/api/" + parts[1] if len(parts) > 1 else "/api"
        return "<other>"

    def _handle(self, req: BaseHTTPRequestHandler, method: str) -> None:
        """Timed choke point over every request: dispatch, then record
        endpoint label + handler wall + bytes served into the wire
        plane (when wired) and log slow handlers — the gateway's cost
        is measured exactly where it is paid."""
        t0 = time.perf_counter()
        try:
            self._dispatch(req, method)
        finally:
            wall = time.perf_counter() - t0
            endpoint = self._endpoint_label(urlparse(req.path).path)
            slow = (
                0 < self.slow_request_micros <= wall * 1e6
            )
            if slow:
                logging.getLogger("corda_tpu_torch.webserver").warning(
                    "slow handler: %s %s took %.1fms",
                    method, endpoint, wall * 1e3,
                )
            if self.wire is not None:
                self.wire.gateway.record_request(
                    endpoint, wall,
                    getattr(req, "_bytes_served", 0), slow=slow,
                )

    def _dispatch(self, req: BaseHTTPRequestHandler, method: str) -> None:
        url = urlparse(req.path)
        path = url.path
        if method == "GET" and path.startswith("/web/"):
            # CorDapp static content: /web/<prefix>/<path>
            parts = [p for p in path.split("/") if p]
            hit = None
            if len(parts) >= 2 and parts[1] in _WEB_PLUGINS:
                hit = _WEB_PLUGINS[parts[1]].static_for("/".join(parts[2:]))
            if hit is None:
                status, ctype, payload = self._json(
                    404, {"error": f"no such content {path}"}
                )
            else:
                status, ctype, payload = 200, hit[0], hit[1]
            self._send(req, status, ctype, payload)
            return
        if method == "GET" and path.startswith("/cluster/trace/"):
            # path-parameterized: the trace id rides in the URL (the
            # form every evidence row and export prints verbatim)
            status, ctype, payload = self._serve_cluster_trace(
                path[len("/cluster/trace/"):]
            )
            self._send(req, status, ctype, payload)
            return
        if method == "GET" and path.startswith("/incidents/"):
            status, ctype, payload = self._serve_incident(
                path[len("/incidents/"):]
            )
            self._send(req, status, ctype, payload)
            return
        if method == "GET" and path.startswith("/tx/"):
            # path-parameterized: /tx/slowest is the leaderboard,
            # anything else is a transaction id (the str(SecureHash)
            # form every answer, story and evidence row prints)
            rest = path[len("/tx/"):]
            query = parse_qs(url.query)
            if rest == "slowest":
                status, ctype, payload = self._serve_tx_slowest(query)
            else:
                status, ctype, payload = self._serve_tx(rest, query)
            if query.get("ts", ["0"])[0] not in ("", "0"):
                payload = self._stamp_ts(ctype, payload)
            self._send(req, status, ctype, payload)
            return
        if method == "GET" and path in self._ops:
            query = parse_qs(url.query)
            status, ctype, payload = self._ops[path][1](query)
            if query.get("ts", ["0"])[0] not in ("", "0"):
                payload = self._stamp_ts(ctype, payload)
            self._send(req, status, ctype, payload)
            return
        try:
            with self._lock:
                status, body = self._route(req, method)
        except (rpclib.RpcError, js.CallParseError, FlowLookupError,
                json.JSONDecodeError, ValueError) as e:
            status, body = 400, {"error": str(e)}
        except TimeoutError as e:
            status, body = 504, {"error": str(e)}
        except Exception as e:   # pragma: no cover - defensive
            status, body = 500, {"error": f"{type(e).__name__}: {e}"}
        payload = json.dumps(body, indent=2).encode()
        self._send(req, status, "application/json", payload)

    def _route(self, req, method: str):
        url = urlparse(req.path)
        parts = [p for p in url.path.split("/") if p]
        if method == "GET":
            if parts == ["api", "status"]:
                info = self._wait(self.client.node_identity())
                now = self._wait(self.client.current_node_time())
                return 200, {
                    "identity": js.to_jsonable(info.legal_identity),
                    "address": info.address,
                    "time_micros": now,
                }
            if parts == ["api", "network"]:
                infos = self._wait(self.client.network_map_snapshot())
                return 200, [js.to_jsonable(i) for i in infos]
            if parts == ["api", "notaries"]:
                ids = self._wait(self.client.notary_identities())
                return 200, [js.to_jsonable(p) for p in ids]
            if parts == ["api", "flows"]:
                return 200, list(self._wait(self.client.registered_flows()))
            if parts == ["api", "vault"]:
                from ..node.vault_query import VaultQueryCriteria

                q = parse_qs(url.query)
                contract = q.get("contract", [None])[0]
                criteria = (
                    VaultQueryCriteria(contract_state_types=(contract,))
                    if contract
                    else VaultQueryCriteria()
                )
                page = self._wait(self.client.vault_query_by(criteria))
                return 200, {
                    "total": page.total_states_available,
                    "states": [js.to_jsonable(s) for s in page.states],
                }
            if parts == ["api", "plugins"]:
                return 200, sorted(_WEB_PLUGINS)
        # CorDapp-mounted REST APIs: /api/<prefix>/<subpath>
        # (WebServerPluginRegistry mounting, NodeWebServer.kt:171-173)
        if len(parts) >= 2 and parts[0] == "api" and parts[1] in _WEB_PLUGINS:
            plugin = _WEB_PLUGINS[parts[1]]
            subpath = "/".join(parts[2:])
            handler = plugin.route(method, subpath)
            if handler is None:
                return 404, {
                    "error": f"plugin {plugin.prefix!r} has no "
                    f"{method} /{subpath}"
                }
            body = None
            if method == "POST":
                length = int(req.headers.get("Content-Length", 0))
                raw = req.rfile.read(length) if length else b"{}"
                body = json.loads(raw)
            return handler(WebContext(self), parse_qs(url.query), body)
        if method == "GET":
            return 404, {"error": f"no such endpoint {url.path}"}
        if method == "POST" and parts[:2] == ["api", "flows"] and len(parts) == 3:
            flow_tag = find_flow_class(parts[2])
            length = int(req.headers.get("Content-Length", 0))
            raw = req.rfile.read(length) if length else b"{}"
            body = json.loads(raw)
            if not isinstance(body, dict):
                raise ValueError("flow POST body must be a JSON object")
            kwargs = {k: js.from_jsonable(v) for k, v in body.items()}
            handle = self._wait(
                self.client.call("start_flow", flow_tag, kwargs)
            )
            result = self._wait(handle.result)
            return 200, {"result": js.to_jsonable(result)}
        return 404, {"error": f"no such endpoint {method} {url.path}"}

