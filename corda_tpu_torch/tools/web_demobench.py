"""Web DemoBench: the browser node launcher.

Reference: tools/demobench/ — the desktop app
(net/corda/demobench/DemoBench.kt) that spawns local node processes,
shows each node's terminal pane, and opens views against any of them.
The terminal REPL form lives in `tools/demobench.py`; this module is
the GUI counterpart in the framework's web-first style: a
zero-dependency HTML page over a JSON API, driving the SAME
programmatic `DemoBench` (spawn, panes, status, shutdown).

    python -m corda_tpu_torch.tools.web_demobench ./bench --port 8090
    # browse http://127.0.0.1:8090/

API (all JSON):
  GET  /api/bench/status          nodes: name, state, p2p port, pane
                                  path, web explorer port (when the
                                  node runs a gateway), map-host flag
  POST /api/bench/add             {name, notary?, web?, ...config}
                                  spawn starts in the background;
                                  poll status for "starting" -> "up"
  POST /api/bench/stop            {name}
  GET  /api/bench/pane?name=X&tail=N     last N pane-log lines

Nodes spawned with {"web": true} get an ephemeral web gateway
(web_port=0 + the bench RPC user), and the page links straight to
their /web/explorer/ — the reference demobench's "open explorer"
action.

Port of corda_tpu/tools/web_demobench.py over the port's DemoBench: its
nodes verify on the card unless the add request sets
"verifier_backend": "cpu".
"""

from __future__ import annotations

import json
import os
import re
import threading
from ..utils import locks
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .demobench import DemoBench

_WEB_PORT_RE = re.compile(rb"WEB_PORT=(\d+)")

# NodeConfig keys the add form may set (a typo'd key must fail the
# request loudly, and nothing outside the config schema may pass)
_ALLOWED_KEYS = {
    "notary", "scheme", "verifier_type", "verifier_backend",
    "notary_batch_wait_micros", "cluster_peers", "cluster_name",
    "cluster_key_seed", "cordapps",
}


class WebDemoBench:
    """The launcher state: one DemoBench + background spawner threads."""

    def __init__(self, bench_dir: str, base_port: int = 10_000):
        self.bench = DemoBench(bench_dir, base_port)
        # _lock guards launcher bookkeeping (fast); _spawn_lock
        # serialises the slow node boots so DemoBench's port
        # allocation and node dict never race — status reads stay
        # unblocked while a node is starting
        self._lock = locks.make_lock("WebDemoBench._lock")
        self._spawn_lock = locks.make_lock("WebDemoBench._spawn_lock")
        self._starting: dict[str, Optional[str]] = {}  # name -> error|None
        self._web_ports: dict[str, int] = {}   # announced ports, cached
        self._closed = False

    # -- operations ----------------------------------------------------------

    def add(self, body: dict) -> tuple[int, dict]:
        name = str(body.get("name", "")).strip()
        if not re.fullmatch(r"[A-Za-z][A-Za-z0-9_-]{0,31}", name or ""):
            return 400, {"error": "name must be [A-Za-z][A-Za-z0-9_-]*"}
        unknown = set(body) - _ALLOWED_KEYS - {"name", "web"}
        if unknown:
            return 400, {"error": f"unknown config keys {sorted(unknown)}"}
        kw = {k: body[k] for k in _ALLOWED_KEYS if k in body}
        if body.get("web"):
            kw["web_port"] = 0              # ephemeral gateway + explorer
        with self._lock:
            if self._closed:
                return 409, {"error": "launcher is shutting down"}
            node = self.bench.nodes.get(name)
            in_flight = (
                name in self._starting and self._starting[name] is None
            )
            if (node is not None and node.alive) or in_flight:
                return 409, {"error": f"node {name!r} already running"}
            # a FAILED previous spawn is retryable
            self._starting[name] = None

        def spawn() -> None:
            try:
                with self._spawn_lock:
                    with self._lock:
                        if self._closed:
                            # shutdown won the race: booting now would
                            # orphan a node past the launcher
                            self._starting.pop(name, None)
                            return
                    # register_lock=self._lock: the bench-mutation
                    # portion of add_node's completion happens under
                    # the SAME lock status()/pane() read with, so a
                    # poll can never observe a half-registered node
                    # (round-5 advisor — GIL atomicity is not a
                    # consistency contract)
                    self.bench.add_node(name, register_lock=self._lock, **kw)
                with self._lock:
                    del self._starting[name]
            except Exception as e:   # noqa: BLE001 - surfaced via status
                with self._lock:
                    self._starting[name] = str(e)

        threading.Thread(target=spawn, daemon=True).start()
        return 202, {"status": "starting", "name": name}

    def stop(self, body: dict) -> tuple[int, dict]:
        name = str(body.get("name", ""))
        with self._lock:
            if name in self._starting and self._starting[name] is None:
                return 409, {"error": f"node {name!r} is still starting"}
            failed = self._starting.pop(name, None) is not None
            # take the node out of the bench under the lock; terminate
            # OUTSIDE it (SIGTERM wait can take 15 s — status polls
            # must not freeze behind it)
            node = self.bench.nodes.pop(name, None)
            self._web_ports.pop(name, None)
        if node is None:
            if failed:
                return 200, {"status": "cleared", "name": name}
            return 404, {"error": f"no node {name!r}"}
        node.stop()
        return 200, {"status": "stopped", "name": name}

    def status(self) -> tuple[int, dict]:
        # snapshot the table under the lock; the pane-log scan in
        # _web_port (file I/O, unbounded pane growth) runs OUTSIDE it,
        # same discipline as pane() — status polls must not serialize
        # behind each other on disk reads
        with self._lock:
            map_host = self.bench._map_host()
            nodes = []
            live: list = []
            seen = set()
            for name in self.bench._order:
                seen.add(name)
                node = self.bench.nodes.get(name)
                if node is None:
                    # a re-added name stays in _order: an in-flight or
                    # failed spawn outranks the stale "stopped" row
                    if name in self._starting:
                        err = self._starting[name]
                        state = f"failed: {err}" if err else "starting"
                    else:
                        state = "stopped"
                    nodes.append({"name": name, "state": state})
                    continue
                row = {
                    "name": name,
                    "state": "up" if node.alive else "DEAD",
                    "port": node.port,
                    "pane": node.log_path,
                    "web_port": None,
                    "map_host": node is map_host,
                    "notary": node.config.notary or None,
                }
                nodes.append(row)
                live.append((row, node))
            for name, err in self._starting.items():
                if name not in seen and name not in self.bench.nodes:
                    nodes.append(
                        {"name": name,
                         "state": f"failed: {err}" if err else "starting"}
                    )
        for row, node in live:
            row["web_port"] = self._web_port(node)
        return 200, {"bench_dir": self.bench.bench_dir, "nodes": nodes}

    def pane(self, name: str, tail: int) -> tuple[int, dict]:
        with self._lock:
            node = self.bench.nodes.get(name)
        if node is None:
            return 404, {"error": f"no node {name!r}"}
        try:
            with open(node.log_path, "rb") as f:
                lines = f.read().decode(errors="replace").splitlines()
        except OSError:
            lines = []
        return 200, {"name": name, "lines": lines[-tail:] if tail > 0 else []}

    def _web_port(self, node) -> Optional[int]:
        """A gateway node announces WEB_PORT= into its pane log;
        cached on first sight (the announcement never changes and the
        pane grows unboundedly — status must not rescan it forever).
        Cache reads/writes happen under the lock (stop() invalidates
        under it) but the pane scan does not; the write re-checks that
        `node` is still the bench's current instance so a stop()/
        re-add racing the scan can never resurrect a stale port."""
        with self._lock:
            cached = self._web_ports.get(node.name)
        if cached is not None:
            return cached
        if node.config.web_port < 0:
            return None
        try:
            with open(node.log_path, "rb") as f:
                m = _WEB_PORT_RE.search(f.read())
        except OSError:
            return None
        if m is None:
            return None
        port = int(m.group(1))
        with self._lock:
            if self.bench.nodes.get(node.name) is node:
                self._web_ports[node.name] = port
        return port

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True   # add() refuses from here on
        # wait out any in-flight boot (it holds _spawn_lock), so a
        # node finishing its handshake mid-shutdown is IN the bench
        # and gets stopped — never orphaned past the launcher
        with self._spawn_lock:
            with self._lock:
                self.bench.shutdown()


_PAGE = b"""<!doctype html>
<meta charset="utf-8">
<title>corda_tpu_torch demobench</title>
<style>
  body { font-family: ui-monospace, Menlo, Consolas, monospace;
         margin: 2rem; max-width: 72rem; }
  h1 { font-size: 1.2rem; } h2 { font-size: 1rem; margin-top: 1.5rem; }
  table { border-collapse: collapse; width: 100%; }
  th, td { text-align: left; padding: .25rem .75rem .25rem 0;
           border-bottom: 1px solid #ddd; font-size: .85rem; }
  pre { background: #f6f6f6; padding: .5rem; overflow-x: auto; }
  #err { color: #a00; }
</style>
<h1>demobench &mdash; <span id="dir">&hellip;</span></h1>
<p id="err"></p>
<h2>launch a node</h2>
<p>
  <label>name <input id="add-name" size="12" value="Notary"></label>
  <label>notary <select id="add-notary">
    <option value="">(none)</option><option>simple</option>
    <option>validating</option><option>batching</option>
  </select></label>
  <label><input type="checkbox" id="add-web" checked> web explorer</label>
  <button onclick="addNode()">launch</button>
  <span id="add-out"></span>
</p>
<h2>nodes</h2>
<table id="nodes"></table>
<h2>pane <span id="pane-name"></span></h2>
<pre id="pane">(click a node's pane link)</pre>
<script>
const q = id => document.getElementById(id);
const esc = s => String(s).replace(/[&<>"']/g, ch => (
  {"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"}[ch]));
async function addNode() {
  const body = {name: q("add-name").value, web: q("add-web").checked};
  if (q("add-notary").value) body.notary = q("add-notary").value;
  q("add-out").textContent = "...";
  const r = await fetch("/api/bench/add", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify(body)});
  const out = await r.json();
  q("add-out").textContent = r.ok ? out.status : "failed: " + out.error;
  refresh();
}
async function stopNode(name) {
  await fetch("/api/bench/stop", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({name})});
  refresh();
}
async function showPane(name) {
  const r = await fetch("/api/bench/pane?name=" + encodeURIComponent(name)
                        + "&tail=40");
  const out = await r.json();
  q("pane-name").textContent = "- " + name;
  q("pane").textContent = (out.lines || []).join("\\n") || "(empty)";
}
async function refresh() {
  try {
    const st = await (await fetch("/api/bench/status")).json();
    q("dir").textContent = st.bench_dir;
    q("nodes").innerHTML = "<tr><th>node</th><th>state</th><th>p2p</th>" +
      "<th>role</th><th>pane</th><th>explorer</th><th></th></tr>" +
      st.nodes.map(n => "<tr><td>" + esc(n.name) + "</td><td>" +
        esc(n.state) + "</td><td>" + esc(n.port || "-") + "</td><td>" +
        esc((n.map_host ? "map host " : "") + (n.notary || "")) +
        "</td><td><a href=\\"#pane\\" onclick=\\"showPane('" +
        esc(n.name) + "')\\">tail</a></td><td>" +
        (n.web_port ? "<a target=_blank href=\\"http://" +
         location.hostname + ":" + n.web_port +
         "/web/explorer/\\">open</a>" : "-") +
        "</td><td><button onclick=\\"stopNode('" + esc(n.name) +
        "')\\">stop</button></td></tr>").join("");
    q("err").textContent = "";
  } catch (e) { q("err").textContent = "refresh failed: " + e; }
}
refresh();
setInterval(refresh, 2000);
</script>
"""


class _Handler(BaseHTTPRequestHandler):
    launcher: WebDemoBench = None   # set by serve()

    def log_message(self, *a) -> None:   # quiet
        pass

    def _reply(self, status: int, payload, content_type="application/json"):
        body = (
            payload
            if isinstance(payload, (bytes, bytearray))
            else json.dumps(payload).encode()
        )
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            return self._reply(200, _PAGE, "text/html")
        if url.path == "/api/bench/status":
            return self._reply(*self.launcher.status())
        if url.path == "/api/bench/pane":
            qs = parse_qs(url.query)
            name = (qs.get("name") or [""])[0]
            try:
                tail = int((qs.get("tail") or ["100"])[0])
            except ValueError:
                tail = 100
            return self._reply(*self.launcher.pane(name, tail))
        self._reply(404, {"error": "not found"})

    def do_POST(self) -> None:
        url = urlparse(self.path)
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            return self._reply(400, {"error": f"bad request body: {e}"})
        if url.path == "/api/bench/add":
            return self._reply(*self.launcher.add(body))
        if url.path == "/api/bench/stop":
            return self._reply(*self.launcher.stop(body))
        self._reply(404, {"error": "not found"})


def serve(
    bench_dir: str,
    port: int = 0,
    base_port: int = 10_000,
) -> tuple[ThreadingHTTPServer, WebDemoBench]:
    """Start the launcher server (returns immediately; caller owns
    shutdown of both the HTTP server and the bench)."""
    launcher = WebDemoBench(bench_dir, base_port)
    handler = type("_BoundHandler", (_Handler,), {"launcher": launcher})
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, launcher


def main(argv=None) -> int:
    import argparse
    import time

    parser = argparse.ArgumentParser(
        prog="corda_tpu_torch.tools.web_demobench",
        description="Browser node launcher (demobench GUI analogue)",
    )
    parser.add_argument("bench_dir")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--base-port", type=int, default=10_000)
    args = parser.parse_args(argv)
    server, launcher = serve(args.bench_dir, args.port, args.base_port)
    print(f"demobench UI: http://127.0.0.1:{server.server_port}/")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        launcher.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
