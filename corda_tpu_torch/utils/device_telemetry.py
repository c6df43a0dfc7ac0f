"""Device telemetry and capacity attribution: which resource binds next.

Port of corda_tpu/utils/device_telemetry.py. The question every speed
item turns on is which resource binds next: the Python pump, device
compute, the host-to-card copy, the commit plane or the wire. This
module measures each in the node and names ONE binding constraint.
Three pieces behind one `DevicePlane` facade (built in node.py, ticked
on the pump):

  DeviceSampler      - per-device telemetry over the torch CUDA devices
      (`torch.cuda`): memory in use, peak and limit from the caching
      allocator and the device's total memory, platform/kind identity,
      and a live-buffer census read from the allocator's active blocks
      (count and bytes per device). `devices_fn` is injectable so rigs
      and tests feed fake devices with scripted memory stats. Without
      one, the sampler lists the card and raises where torch.cuda
      cannot be queried: a node whose verifier is on the card does not
      sample an empty list.

  DeviceAccounting   - per-device dispatch accounting at the verify
      seam, the device-keyed complement of perf.KernelAccounting: the
      launch wall as busy seconds, dispatch counts, the host-side queue
      wait (bucket entry to each chunk's launch) and host-to-card
      transfer bytes and seconds. Process-scoped
      (`get_device_accounting()`); every CudaBatchVerifier records into
      it.

  capacity_model     - a roofline-style ceiling for
      `batching_notary_notarisations_per_sec`: joins host pump
      seconds/tx (the notary flush phase timers), device busy
      seconds/tx and transfer bandwidth and bytes/tx
      (DeviceAccounting), commit-plane seconds/tx, the wire's host
      seconds/tx and the sustained rate from the perf plane's history.
      The output NAMES the binding constraint (`host_pump` |
      `device_compute` | `transfer` | `commit_plane` | `wire`) with
      per-resource ceilings and headroom fractions; `what_if` knobs
      substitute inputs for planning.

"Busy" is the reference's: the launch wall the host pays, not a device
event reading. On the card that wall holds the torch ops a chunk
issues around its ladder kernel, so `device_compute` can bind where
the host sets the pace.

Health integration (`HealthMonitor.watch_device`): `device.hbm_pressure`
on sustained memory in use over the limit, `device.fallback_active`
bridging the notary's degraded mode with device evidence, and
`device.utilization_collapse` — busy fraction dropping while the
backlog grows. Clock-injected throughout; host logic, snapshots and
rules are the reference's.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from . import locks
from .metrics import MetricRegistry


@dataclass(frozen=True)
class DevicePolicy:
    """Operator knobs (config.py gates the plane on/off; the
    thresholds live here like PerfPolicy's). Windows are node-clock
    microseconds."""

    # one sample per tick at most this often (0 = every tick — A/B
    # A/B and simulated-time rigs)
    sample_gap_micros: int = 1_000_000
    # busy-fraction / transfer-rate / backlog windows
    window_micros: int = 30_000_000
    # device.hbm_pressure: sustained bytes_in_use / bytes_limit at or
    # above this fraction
    hbm_pressure_threshold: float = 0.92
    # device.utilization_collapse: busy fraction below this while the
    # backlog holds at least collapse_min_backlog AND grows across the
    # window — the pump starving the chip
    collapse_busy_fraction: float = 0.10
    collapse_min_backlog: int = 64
    # live-buffer census (the caching allocator's active blocks) per
    # sample — disable for embedded rigs
    live_buffer_census: bool = True
    # sustained-rate window the capacity model reads from PerfHistory
    capacity_history_window: int = 32


# ---------------------------------------------------------------------------
# per-device dispatch accounting (the verify-seam feed)


class DeviceAccounting:
    """Cumulative per-device counters recorded at the CudaBatchVerifier
    dispatch seam. The DevicePlane windows these on its tick; the chip
    script and tests read the raw snapshot. Keys are torch device
    indices (ints; 0 for a verifier on the CPU)."""

    def __init__(self):
        self._lock = locks.make_lock("DeviceAccounting._lock")
        self._devices: dict[int, dict] = {}

    def _row(self, device_id: int) -> dict:
        row = self._devices.get(int(device_id))
        if row is None:
            row = self._devices[int(device_id)] = {
                "dispatches": 0,
                "requests": 0,
                "busy_seconds": 0.0,
                "queue_wait_seconds": 0.0,
                "transfer_bytes": 0,
                "transfer_seconds": 0.0,
            }
        return row

    def record_dispatch(
        self,
        device_id: int,
        n: int,
        seconds: float,
        queue_wait_seconds: float = 0.0,
    ) -> None:
        """One kernel launch on one device: `n` real (unpadded)
        requests, `seconds` of host dispatch wall (the busy proxy the
        window turns into a busy fraction), and the host-side queue
        wait this chunk paid before its launch."""
        with self._lock:
            row = self._row(device_id)
            row["dispatches"] += 1
            row["requests"] += int(n)
            row["busy_seconds"] += float(seconds)
            row["queue_wait_seconds"] += float(queue_wait_seconds)

    def record_transfer(
        self, device_id: int, nbytes: int, seconds: float
    ) -> None:
        with self._lock:
            row = self._row(device_id)
            row["transfer_bytes"] += int(nbytes)
            row["transfer_seconds"] += float(seconds)

    def device_ids(self) -> list[int]:
        with self._lock:
            return sorted(self._devices)

    def snapshot(self) -> dict:
        with self._lock:
            devices = {
                k: dict(row) for k, row in sorted(self._devices.items())
            }
        totals = {
            "dispatches": sum(r["dispatches"] for r in devices.values()),
            "requests": sum(r["requests"] for r in devices.values()),
            "busy_seconds": sum(r["busy_seconds"] for r in devices.values()),
            "transfer_bytes": sum(
                r["transfer_bytes"] for r in devices.values()
            ),
            "transfer_seconds": sum(
                r["transfer_seconds"] for r in devices.values()
            ),
        }
        return {"devices": devices, "totals": totals}


# the process default (what CudaBatchVerifier records into): per-device
# attribution is process-scoped exactly like perf's kernel accounting —
# the built kernels and the cards are process resources, and two
# embedded nodes must read one truthful ledger
_default_devices: Optional[DeviceAccounting] = None
_default_devices_lock = locks.make_lock(
    "device_telemetry._default_devices_lock"
)


def get_device_accounting() -> DeviceAccounting:
    global _default_devices
    if _default_devices is None:
        with _default_devices_lock:
            if _default_devices is None:
                _default_devices = DeviceAccounting()
    return _default_devices


def set_device_accounting(acct: Optional[DeviceAccounting]) -> None:
    global _default_devices
    with _default_devices_lock:
        _default_devices = acct


# ---------------------------------------------------------------------------
# device sampler


class CudaDevice:
    """One torch CUDA device as the sampler reads it: `id`, `platform`,
    `device_kind` and `memory_stats()` (the caching allocator's bytes
    in use and peak, the card's total memory as the limit)."""

    platform = "gpu"

    def __init__(self, index: int):
        import torch

        self.id = int(index)
        self.device_kind = torch.cuda.get_device_name(self.id)

    def memory_stats(self) -> dict:
        import torch

        return {
            "bytes_in_use": torch.cuda.memory_allocated(self.id),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(self.id),
            "bytes_limit": torch.cuda.get_device_properties(self.id).total_memory,
        }


class HostDevice:
    """The host CPU as the sampler reads it, for a node that verifies on
    the CPU: one device (`index` 0; a CPU device of a mesh keeps its
    own), platform "cpu", no memory stats (its row's hbm is null), as
    the reference samples its CPU backend."""

    platform = "cpu"
    device_kind = "cpu"

    def __init__(self, index: int = 0):
        self.id = int(index)


def host_devices() -> list:
    return [HostDevice()]


def cuda_devices() -> list:
    """Every visible torch CUDA device; raises where torch.cuda cannot
    be queried (no card, no driver, a CPU build of torch)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the device sampler reads the card "
            "(inject devices_fn for a node that verifies on the CPU)"
        )
    return [CudaDevice(i) for i in range(torch.cuda.device_count())]


class DeviceSampler:
    """Memory + identity + live-buffer census over the visible devices.

    `devices_fn` is injectable (fake devices with scripted
    `memory_stats()` drive the hbm_pressure tests and rigs; a node that
    verifies on the CPU passes `host_devices`), and an injected function
    that fails samples as no devices, as in the reference. The default
    is `cuda_devices()`, which raises where torch.cuda cannot be
    queried: a sampler meant to see the card never reads an empty list
    in its place."""

    def __init__(self, devices_fn: Optional[Callable[[], list]] = None):
        self._devices_fn = devices_fn

    def devices(self) -> list:
        if self._devices_fn is not None:
            try:
                return list(self._devices_fn())
            except Exception:
                return []
        return cuda_devices()

    @staticmethod
    def _memory_stats(dev) -> Optional[dict]:
        """`device.memory_stats()` — absent-not-fatal: a device with no
        memory stats (or no method at all) samples `null`, never a
        crash."""
        fn = getattr(dev, "memory_stats", None)
        if fn is None:
            return None
        try:
            stats = fn()
        except Exception:
            return None
        if not isinstance(stats, dict):
            return None
        return stats

    def live_buffers(self) -> dict[int, dict]:
        """Live tensors per CUDA device, from the caching allocator:
        {id: {count, bytes}} of its active blocks (staged operands,
        in-flight results and pinned constants). Empty where no CUDA
        device is visible or the allocator never ran."""
        import torch

        if not torch.cuda.is_available():
            return {}
        out: dict[int, dict] = {}
        for did in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(did)
            if not stats:
                continue
            out[did] = {
                "count": int(stats.get("active.all.current", 0)),
                "bytes": int(stats.get("active_bytes.all.current", 0)),
            }
        return out

    def sample(self, census: bool = True) -> list[dict]:
        """One telemetry pass: a JSON-safe row per device."""
        buffers = self.live_buffers() if census else {}
        rows = []
        for dev in self.devices():
            stats = self._memory_stats(dev)
            hbm = None
            if stats is not None:
                in_use = stats.get("bytes_in_use")
                limit = stats.get("bytes_limit")
                hbm = {
                    "bytes_in_use": in_use,
                    "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                    "bytes_limit": limit,
                    "utilization": (
                        round(in_use / limit, 4)
                        if isinstance(in_use, (int, float))
                        and isinstance(limit, (int, float)) and limit
                        else None
                    ),
                }
            did = int(getattr(dev, "id", 0))
            rows.append({
                "id": did,
                "platform": getattr(dev, "platform", "unknown"),
                "kind": getattr(dev, "device_kind", "unknown"),
                "hbm": hbm,
                "live_buffers": buffers.get(did),
            })
        return rows


# ---------------------------------------------------------------------------
# capacity model (roofline over measured inputs)

RESOURCES = (
    "host_pump", "device_compute", "transfer", "commit_plane", "wire",
)

# what_if knobs GET /capacity?what_if= accepts (key:value, comma-
# separated). Scale knobs model the planned restructures; *_us / *_per_*
# knobs substitute raw measured inputs for synthetic planning.
WHAT_IF_KNOBS = (
    "shards",                 # N parallel pump planes (the GIL escape):
    #                           divides host_pump AND commit_plane s/tx
    "devices",                # N chips: scales device_compute + transfer
    "pump_us_per_tx",         # host pump seconds/tx override (micros)
    "commit_us_per_tx",       # commit-plane seconds/tx override (micros)
    "device_us_per_tx",       # device busy seconds/tx override (micros)
    "transfer_bytes_per_tx",
    "transfer_bytes_per_sec",
    "wire_us_per_tx",         # wire host cost override (micros) — e.g.
    #                           price what the native codec would save
)


def parse_what_if(text: str) -> dict:
    """`shards:8,devices:4` -> {"shards": 8.0, "devices": 4.0}.
    Raises ValueError naming the bad knob/value (the 400 body)."""
    out: dict[str, float] = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition(":")
        key = key.strip()
        if not sep or key not in WHAT_IF_KNOBS:
            raise ValueError(
                f"unknown what_if knob {part!r}; knobs: "
                + ", ".join(WHAT_IF_KNOBS)
            )
        try:
            out[key] = float(value.strip())
        except ValueError:
            raise ValueError(f"bad what_if value {part!r}")
        if out[key] <= 0:
            raise ValueError(f"what_if {key} must be positive")
    return out


def capacity_model(
    inputs: dict, what_if: Optional[dict] = None
) -> dict:
    """The roofline join: measured per-resource seconds/tx -> a
    predicted ceiling for `batching_notary_notarisations_per_sec`
    with the binding constraint NAMED and per-resource headroom.

    `inputs` (every key optional; a resource with no measured input
    resolves to an unbounded ceiling rather than a guess):

      pump_seconds_per_tx     host flush work per notarisation
                              (stage + dispatch + resolve_verify +
                              validate + sign_scatter)
      commit_seconds_per_tx   commit + stream_commit per notarisation
      lock_hold_seconds_per_tx  measured pump-hot lock holds per tx
                              (the lock-hold split-report feed) — the
                              commit plane charges max(timer, holds)
      device_seconds_per_tx   device busy per request (DeviceAccounting)
      device_count            chips the dispatch path can spread over
      transfer_bytes_per_tx / transfer_bytes_per_sec
      wire_seconds_per_tx     fabric host cost per notarisation
                              (codec encode/decode + journal walls,
                              the WirePlane feed)
      current_per_sec         the sustained live rate (PerfHistory)

    `what_if` substitutes knobs (see WHAT_IF_KNOBS) — `shards:8`
    models a per-shard process split, `devices:4` more cards — and the
    answer names whichever constraint binds AFTER the substitution."""
    what_if = dict(what_if or {})
    pump_s = inputs.get("pump_seconds_per_tx")
    commit_s = inputs.get("commit_seconds_per_tx")
    hold_s = inputs.get("lock_hold_seconds_per_tx")
    dev_s = inputs.get("device_seconds_per_tx")
    dev_n = inputs.get("device_count") or 1
    bytes_tx = inputs.get("transfer_bytes_per_tx")
    bw = inputs.get("transfer_bytes_per_sec")
    wire_s = inputs.get("wire_seconds_per_tx")
    current = inputs.get("current_per_sec")

    if "pump_us_per_tx" in what_if:
        pump_s = what_if["pump_us_per_tx"] / 1e6
    if "commit_us_per_tx" in what_if:
        commit_s = what_if["commit_us_per_tx"] / 1e6
    if "device_us_per_tx" in what_if:
        dev_s = what_if["device_us_per_tx"] / 1e6
    if "transfer_bytes_per_tx" in what_if:
        bytes_tx = what_if["transfer_bytes_per_tx"]
    if "transfer_bytes_per_sec" in what_if:
        bw = what_if["transfer_bytes_per_sec"]
    if "wire_us_per_tx" in what_if:
        wire_s = what_if["wire_us_per_tx"] / 1e6
    shards = what_if.get("shards", 1.0)
    devices = what_if.get("devices", float(dev_n))
    device_scale = devices / float(dev_n)

    # commit plane: the flush's commit timer OR the measured pump-hot
    # lock holds, whichever states the larger serialized cost
    commit_eff = max(
        [s for s in (commit_s, hold_s) if s], default=None
    )

    resources: dict[str, dict] = {}

    def resource(name, ceiling, evidence):
        headroom = None
        if ceiling is not None and ceiling > 0:
            headroom = round(
                max(0.0, 1.0 - (current or 0.0) / ceiling), 4
            )
        resources[name] = {
            "ceiling_per_sec": (
                round(ceiling, 1) if ceiling is not None else None
            ),
            "headroom_fraction": headroom,
            "evidence": evidence,
        }

    resource(
        "host_pump",
        shards / pump_s if pump_s else None,
        (
            f"host pump pays {pump_s * 1e6:.1f}us/tx across the flush "
            f"phases (stage+dispatch+resolve_verify+validate+"
            f"sign_scatter)"
            + (f" across {shards:g} parallel pump planes"
               if shards != 1.0 else "")
            if pump_s else
            "no flush phase timings yet (no notarisations served)"
        ),
    )
    resource(
        "device_compute",
        devices / dev_s if dev_s else None,
        (
            f"device busy {dev_s * 1e6:.1f}us/request over "
            f"{devices:g} device(s)"
            if dev_s else
            "no device dispatches recorded (CPU verify path, or no "
            "traffic through the batch verifier)"
        ),
    )
    resource(
        "transfer",
        (
            device_scale * bw / bytes_tx
            if bw and bytes_tx else None
        ),
        (
            f"{bytes_tx:.0f} bytes/tx over a measured "
            f"{bw / 1e6:.1f} MB/s host->device link"
            + (f" x{device_scale:g} links" if device_scale != 1.0 else "")
            if bw and bytes_tx else
            "no timed host->device transfers recorded"
        ),
    )
    resource(
        "commit_plane",
        shards / commit_eff if commit_eff else None,
        (
            f"commit plane serializes {commit_eff * 1e6:.1f}us/tx "
            + ("(measured pump-hot lock holds exceed the commit timer)"
               if hold_s and (not commit_s or hold_s > commit_s)
               else "(commit + stream_commit flush phases)")
            + (f" across {shards:g} shards" if shards != 1.0 else "")
            if commit_eff else
            "no commit phase timings yet"
        ),
    )
    resource(
        "wire",
        shards / wire_s if wire_s else None,
        (
            f"fabric wire work pays {wire_s * 1e6:.1f}us/tx on the "
            f"host (codec encode/decode + journal append/fsync)"
            + (f" across {shards:g} parallel pump planes"
               if shards != 1.0 else "")
            if wire_s else
            "no wire telemetry feed (wire plane disabled, or no "
            "fabric traffic yet)"
        ),
    )

    bounded = {
        name: row["ceiling_per_sec"]
        for name, row in resources.items()
        if row["ceiling_per_sec"] is not None
    }
    binding = (
        min(bounded, key=bounded.get) if bounded else None
    )
    ceiling = bounded.get(binding) if binding else None
    sentence = None
    if binding is not None:
        cur_txt = (
            f"{current:.0f}/s sustained" if current else "no sustained rate yet"
        )
        sentence = (
            f"{binding} binds the notary line at ~{ceiling:.0f} "
            f"notarisations/s ({cur_txt}): "
            f"{resources[binding]['evidence']}"
        )
    return {
        "inputs": {
            k: (round(v, 9) if isinstance(v, float) else v)
            for k, v in inputs.items() if v is not None
        },
        "what_if": what_if or None,
        "resources": resources,
        "binding_constraint": binding,
        "predicted_ceiling_per_sec": ceiling,
        "current_per_sec": (
            round(current, 1) if current is not None else None
        ),
        "sentence": sentence,
    }


# ---------------------------------------------------------------------------
# alert rules (installed on a HealthMonitor by DevicePlane.install_rules)


def _device_rules(plane: "DevicePlane"):
    """The hbm-pressure / fallback-bridge / utilization-collapse
    AlertRules over one DevicePlane. Imported lazily from utils.health
    so device_telemetry stays importable standalone (the perf-plane
    pattern)."""
    from . import health as hlib

    pol = plane.policy

    class _HbmPressureRule(hlib.AlertRule):
        """Sustained HBM occupancy at/over the threshold on any
        device. The engine's pending->firing hold supplies the
        "sustained" — a one-sample allocation spike never pages."""

        def __init__(self):
            super().__init__(
                "device.hbm_pressure", self._check,
                severity=hlib.SEV_WARNING,
            )

        def _check(self, now: int) -> tuple[bool, dict]:
            worst = plane.hbm_worst()
            cond = (
                worst is not None
                and worst["utilization"] is not None
                and worst["utilization"] >= pol.hbm_pressure_threshold
            )
            return cond, {
                "threshold": pol.hbm_pressure_threshold,
                "worst": worst,
            }

    class _FallbackRule(hlib.AlertRule):
        """The notary's degraded-mode gauge, bridged with device evidence:
        while the notary serves flushes off the CPU reference, this
        alert carries WHAT the device side looked like at the time
        (platform, HBM, busy fractions) next to the degraded error.
        Zero holds on both edges — the degraded flag already encodes
        its own duration (it clears on the first successful probe)."""

        def __init__(self):
            super().__init__(
                "device.fallback_active", self._check,
                severity=hlib.SEV_WARNING,
                for_micros=0, clear_for_micros=0,
                trace_filter="notar",
            )

        def _check(self, now: int) -> tuple[bool, dict]:
            degraded = plane.fallback_active()
            detail = {"degraded": degraded}
            if degraded:
                detail["degraded_evidence"] = plane.fallback_evidence()
                detail["devices"] = plane.device_summary()
            return degraded, detail

    class _CollapseRule(hlib.AlertRule):
        """The pump starved the chip: busy fraction collapsed while
        the backlog holds and grows — requests are queueing on the
        host while the device idles, the signature that separates a
        host-bound stall from device saturation."""

        def __init__(self):
            super().__init__(
                "device.utilization_collapse", self._check,
                severity=hlib.SEV_WARNING,
                trace_filter="notar",
            )

        def _check(self, now: int) -> tuple[bool, dict]:
            busy = plane.busy_fraction_max()
            backlog, growth = plane.backlog_window()
            cond = (
                plane.saw_dispatches()
                and busy < pol.collapse_busy_fraction
                and backlog >= pol.collapse_min_backlog
                and growth > 0
            )
            return cond, {
                "busy_fraction_max": round(busy, 4),
                "busy_threshold": pol.collapse_busy_fraction,
                "backlog": backlog,
                "backlog_growth_in_window": growth,
            }

    return _HbmPressureRule(), _FallbackRule(), _CollapseRule()


# ---------------------------------------------------------------------------
# the facade


class DevicePlane:
    """What the node, the chip script and tests hold.

    Owns the sampler and (by default adopts) the process device
    accounting; `tick()` on the pump cadence samples HBM + windows the
    per-device counters; `snapshot()` is the GET /device payload and
    `capacity()` the GET /capacity one. `install_rules()` puts the
    three device alerts on a HealthMonitor
    (`HealthMonitor.watch_device` calls it)."""

    def __init__(
        self,
        clock=None,
        metrics: Optional[MetricRegistry] = None,
        policy: Optional[DevicePolicy] = None,
        sampler: Optional[DeviceSampler] = None,
        perf=None,
        accounting: Optional[DeviceAccounting] = None,
        install_default_accounting: bool = True,
    ):
        """`perf`: the node's utils/perf.PerfPlane — the capacity
        model reads the sustained notarisations/s from its history
        ring and the flush phase timers from the shared registry; None
        degrades the model to ceilings without a current-rate line.

        `accounting`: an explicit DeviceAccounting; None adopts the
        process default (every CudaBatchVerifier in-process records
        there — the perf-plane adoption discipline), unless
        `install_default_accounting=False` keeps a private ledger
        (tests, embedded rigs)."""
        self.policy = policy or DevicePolicy()
        self._clock = clock
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.perf = perf
        self.sampler = sampler or DeviceSampler()
        if accounting is not None:
            self.accounting = accounting
        elif install_default_accounting:
            self.accounting = get_device_accounting()
        else:
            self.accounting = DeviceAccounting()
        # latest sampler rows keyed by device id + registration memo
        self._samples: dict[int, dict] = {}
        self._gauged: set[int] = set()
        # per-device window: deque of (micros, busy_s, dispatches,
        # queue_wait_s, transfer_bytes, transfer_s) cumulative anchors
        self._windows: dict[int, deque] = {}
        self._backlog: deque = deque()      # (micros, backlog)
        self._last_tick: Optional[int] = None
        # notary feeds (attach_notary): queue depth fns mapped onto
        # device ids, the backlog fn, the degraded bridge
        self._queue_fns: list[Callable[[], int]] = []
        self._queue_devices: list[Optional[int]] = []
        self._fallback_fn: Optional[Callable[[], bool]] = None
        self._fallback_evidence_fn: Optional[Callable[[], dict]] = None
        # the lock-hold split-report feed: seconds of pump-hot lock hold
        # per served tx (armed sanitizer rigs wire it; production
        # leaves it None and the commit timer speaks alone)
        self._lock_hold_fn: Optional[Callable[[], Optional[float]]] = None
        # the wire feed: cumulative fabric host seconds (codec +
        # journal walls) the capacity join divides by served txs
        self._wire_fn: Optional[Callable[[], Optional[float]]] = None
        self.metrics.gauge(
            "Device.Count", lambda: len(self.sampler.devices())
        )

    # -- clock ---------------------------------------------------------------

    def now_micros(self) -> int:
        if self._clock is not None:
            return self._clock.now_micros()
        return time.time_ns() // 1_000

    # -- wiring --------------------------------------------------------------

    def attach_queues(
        self,
        depth_fns: list,
        device_ids: Optional[list] = None,
    ) -> None:
        """The dispatch-queue feed: one depth fn per commit-plane
        queue (the sharded notary's per-shard pending queues), each
        optionally mapped to the device its verifier pins to — the
        per-device `QueueDepth` gauge and the collapse rule's backlog
        read these."""
        self._queue_fns = list(depth_fns)
        self._queue_devices = list(
            device_ids if device_ids is not None
            else [None] * len(self._queue_fns)
        )

    def watch_fallback(
        self,
        flag_fn: Callable[[], bool],
        evidence_fn: Optional[Callable[[], dict]] = None,
    ) -> None:
        """Bridge the notary's degraded mode: `flag_fn` is the notary's
        `degraded` property, `evidence_fn` its `degraded_evidence`."""
        self._fallback_fn = flag_fn
        self._fallback_evidence_fn = evidence_fn

    def set_lock_hold_feed(
        self, fn: Callable[[], Optional[float]]
    ) -> None:
        """Wire the lock-hold split-report feed: `fn()` answers measured
        pump-hot lock hold seconds per served transaction (None when
        the sanitizer is disarmed — the normal production state)."""
        self._lock_hold_fn = fn

    def set_wire_feed(
        self, fn: Callable[[], Optional[float]]
    ) -> None:
        """Wire the wire-telemetry feed: `fn()` answers
        cumulative fabric host seconds (codec encode/decode + journal
        append/fsync walls; None until any wire work is recorded) —
        capacity_inputs divides by served transactions to price the
        `wire` roofline resource."""
        self._wire_fn = fn

    def install_rules(self, monitor) -> None:
        """Wire the hbm-pressure + fallback + collapse alerts onto a
        HealthMonitor (HealthMonitor.watch_device delegates here)."""
        for rule in _device_rules(self):
            monitor.add_rule(rule)

    # -- the tick ------------------------------------------------------------

    def tick(self, now: Optional[int] = None) -> None:
        if now is None:
            now = self.now_micros()
        if (
            self._last_tick is not None
            and now - self._last_tick < self.policy.sample_gap_micros
        ):
            return
        self._last_tick = now
        # telemetry sample: HBM + identity + live buffers
        rows = self.sampler.sample(
            census=self.policy.live_buffer_census
        )
        self._samples = {row["id"]: row for row in rows}
        for did in self._samples:
            if did not in self._gauged:
                self._gauged.add(did)
                self._register_device_gauges(did)
        # accounting windows: cumulative anchors, deltas over the
        # policy window (the ShardSkew discipline — an idle plane's
        # window keeps sliding so a fired collapse alert resolves)
        snap = self.accounting.snapshot()["devices"]
        horizon = now - self.policy.window_micros
        for did, row in snap.items():
            dq = self._windows.setdefault(did, deque())
            dq.append((
                now, row["busy_seconds"], row["dispatches"],
                row["queue_wait_seconds"], row["transfer_bytes"],
                row["transfer_seconds"],
            ))
            while len(dq) > 1 and dq[0][0] < horizon:
                dq.popleft()
            if did not in self._gauged:
                self._gauged.add(did)
                self._register_device_gauges(did)
        # backlog window (collapse rule)
        self._backlog.append((now, self.backlog()))
        while len(self._backlog) > 1 and self._backlog[0][0] < horizon:
            self._backlog.popleft()

    def _register_device_gauges(self, did: int) -> None:
        g = self.metrics.gauge
        g(f"Device.{did}.HbmBytesInUse",
          lambda k=did: self._hbm_value(k, "bytes_in_use"))
        g(f"Device.{did}.HbmBytesLimit",
          lambda k=did: self._hbm_value(k, "bytes_limit"))
        g(f"Device.{did}.HbmUtilization",
          lambda k=did: self._hbm_value(k, "utilization"))
        g(f"Device.{did}.BusyFraction",
          lambda k=did: self._busy_fraction(k))
        g(f"Device.{did}.QueueDepth",
          lambda k=did: self.queue_depth(k))
        g(f"Device.{did}.QueueWaitMicros",
          lambda k=did: self._queue_wait_micros(k))
        g(f"Device.{did}.TransferBytesPerSec",
          lambda k=did: self._transfer_rate(k))
        g(f"Device.{did}.LiveBuffers",
          lambda k=did: self._live_buffer_count(k))

    # -- windowed readouts ---------------------------------------------------

    def _window_deltas(self, did: int) -> Optional[tuple]:
        dq = self._windows.get(did)
        if not dq or len(dq) < 2:
            return None
        t0, b0, d0, q0, tb0, ts0 = dq[0]
        t1, b1, d1, q1, tb1, ts1 = dq[-1]
        if t1 <= t0:
            return None
        return (
            (t1 - t0) / 1e6, b1 - b0, d1 - d0, q1 - q0,
            tb1 - tb0, ts1 - ts0,
        )

    def _busy_fraction(self, did: int) -> float:
        d = self._window_deltas(did)
        if d is None:
            return 0.0
        wall, busy = d[0], d[1]
        return max(0.0, min(1.0, busy / wall)) if wall > 0 else 0.0

    def busy_fraction_max(self) -> float:
        return max(
            [self._busy_fraction(did) for did in self._windows],
            default=0.0,
        )

    def saw_dispatches(self) -> bool:
        """True once any device EVER recorded a dispatch — the
        collapse rule must not fire on a rig that never drove a chip
        (a pure-CPU notary has nothing to starve), but a chip starved
        for longer than the whole window is exactly the condition, so
        this is lifetime, not windowed."""
        snap = self.accounting.snapshot()
        return snap["totals"]["dispatches"] > 0

    def _queue_wait_micros(self, did: int) -> float:
        d = self._window_deltas(did)
        if d is None or d[2] <= 0:
            return 0.0
        return d[3] * 1e6 / d[2]

    def _transfer_rate(self, did: int) -> float:
        d = self._window_deltas(did)
        if d is None or d[5] <= 0:
            return 0.0
        return d[4] / d[5]

    def queue_depth(self, did: Optional[int] = None) -> int:
        """Dispatch-queue depth: the pending-queue depths mapped onto
        `did`'s pipelines (None = all queues — the plane backlog).
        Queues with no device mapping count toward every device on a
        single-device rig and toward the aggregate otherwise."""
        total = 0
        single = len(set(
            d for d in self._queue_devices if d is not None
        )) <= 1
        for fn, dev in zip(self._queue_fns, self._queue_devices):
            if did is not None and dev is not None and dev != did:
                continue
            if did is not None and dev is None and not single:
                continue
            try:
                total += int(fn())
            except Exception:
                continue
        return total

    def backlog(self) -> int:
        return self.queue_depth(None)

    def backlog_window(self) -> tuple[int, int]:
        """(current backlog, growth across the window)."""
        if not self._backlog:
            return self.backlog(), 0
        current = self.backlog()
        return current, current - self._backlog[0][1]

    # -- hbm / fallback readouts --------------------------------------------

    def _hbm_value(self, did: int, key: str) -> float:
        row = self._samples.get(did)
        hbm = row.get("hbm") if row else None
        val = hbm.get(key) if hbm else None
        return float(val) if isinstance(val, (int, float)) else 0.0

    def _live_buffer_count(self, did: int) -> int:
        row = self._samples.get(did)
        buf = row.get("live_buffers") if row else None
        return int(buf["count"]) if buf else 0

    def hbm_worst(self) -> Optional[dict]:
        """The most-pressured device's HBM row (None when no sampled
        device reports memory stats — the CPU degradation)."""
        worst = None
        for did, row in self._samples.items():
            hbm = row.get("hbm")
            if not hbm or hbm.get("utilization") is None:
                continue
            if (
                worst is None
                or hbm["utilization"] > worst["utilization"]
            ):
                worst = {
                    "device": did,
                    "utilization": hbm["utilization"],
                    "bytes_in_use": hbm.get("bytes_in_use"),
                    "bytes_limit": hbm.get("bytes_limit"),
                }
        return worst

    def fallback_active(self) -> bool:
        try:
            return bool(self._fallback_fn and self._fallback_fn())
        except Exception:
            return False

    def fallback_evidence(self) -> dict:
        try:
            if self._fallback_evidence_fn is not None:
                return dict(self._fallback_evidence_fn())
        except Exception:
            pass
        return {}

    def device_summary(self) -> list[dict]:
        """The compact per-device line alert evidence carries."""
        out = []
        for did, row in sorted(self._samples.items()):
            hbm = row.get("hbm") or {}
            out.append({
                "id": did,
                "platform": row.get("platform"),
                "busy_fraction": round(self._busy_fraction(did), 4),
                "queue_depth": self.queue_depth(did),
                "hbm_utilization": hbm.get("utilization"),
            })
        return out

    # -- capacity ------------------------------------------------------------

    def _phase_seconds(self) -> dict[str, float]:
        """Total seconds per Notary.FlushPhase.* timer on the shared
        registry — via perf.flush_phase_seconds, the ONE reader both
        planes share, so the roofline's host-pump input can never
        drift from the stage table GET /perf displays."""
        from . import perf as perflib

        return {
            stage: row["total_s"]
            for stage, row in perflib.flush_phase_seconds(
                self.metrics
            ).items()
        }

    # flush phases charged to the serial host pump vs the commit
    # plane. `commit` alone feeds the commit_plane ceiling: the
    # streamed flush's `stream_commit` mark spans the whole
    # chunk-consume loop — device wait + validate + commit
    # interleaved (a first launch's build lands there too) — so
    # charging it to the commit plane would name
    # commit_plane for what is really device/link time. It reports
    # as WAIT_PHASES evidence (device_wait_seconds_per_tx) instead;
    # the device side of a streamed flush is modeled by the
    # DeviceAccounting busy/transfer rows.
    PUMP_PHASES = (
        "stage", "dispatch", "resolve_verify", "validate", "sign_scatter",
    )
    COMMIT_PHASES = ("commit",)
    WAIT_PHASES = ("link_wait", "stream_commit")

    def _requests_served(self) -> int:
        m = self.metrics.get("Notary.RequestsBatched")
        return int(getattr(m, "count", 0) or 0)

    def capacity_inputs(self) -> dict:
        phases = self._phase_seconds()
        served = self._requests_served()
        pump_s = commit_s = wait_s = None
        if served > 0:
            pump_total = sum(
                phases.get(p, 0.0) for p in self.PUMP_PHASES
            )
            commit_total = sum(
                phases.get(p, 0.0) for p in self.COMMIT_PHASES
            )
            wait_total = sum(
                phases.get(p, 0.0) for p in self.WAIT_PHASES
            )
            pump_s = pump_total / served if pump_total > 0 else None
            commit_s = commit_total / served if commit_total > 0 else None
            wait_s = wait_total / served if wait_total > 0 else None
        hold_s = None
        if self._lock_hold_fn is not None:
            try:
                hold_s = self._lock_hold_fn()
            except Exception:
                hold_s = None
        wire_s = None
        if self._wire_fn is not None and served > 0:
            try:
                wire_total = self._wire_fn()
            except Exception:
                wire_total = None
            if wire_total is not None and wire_total > 0:
                wire_s = wire_total / served
        totals = self.accounting.snapshot()["totals"]
        dev_s = bytes_tx = bw = None
        if totals["requests"] > 0 and totals["busy_seconds"] > 0:
            dev_s = totals["busy_seconds"] / totals["requests"]
        if totals["requests"] > 0 and totals["transfer_bytes"] > 0:
            bytes_tx = totals["transfer_bytes"] / totals["requests"]
        if totals["transfer_seconds"] > 0:
            bw = totals["transfer_bytes"] / totals["transfer_seconds"]
        current = None
        if self.perf is not None:
            current = self.perf.history.sustained(
                "batching_notary_notarisations_per_sec",
                self.policy.capacity_history_window,
            )
        return {
            "requests_served": served,
            "pump_seconds_per_tx": pump_s,
            "commit_seconds_per_tx": commit_s,
            # evidence, not a ceiling: host time spent waiting on the
            # device/link (link_wait + the mixed streamed-consume
            # loop) — the chip's side of these seconds is modeled by
            # the DeviceAccounting busy/transfer rows
            "device_wait_seconds_per_tx": wait_s,
            "lock_hold_seconds_per_tx": hold_s,
            "wire_seconds_per_tx": wire_s,
            "device_seconds_per_tx": dev_s,
            "device_count": max(1, len(self.sampler.devices())),
            "transfer_bytes_per_tx": bytes_tx,
            "transfer_bytes_per_sec": bw,
            "current_per_sec": current,
        }

    def capacity(self, what_if: Optional[dict] = None) -> dict:
        """The GET /capacity payload."""
        out = capacity_model(self.capacity_inputs(), what_if)
        out["now_micros"] = self.now_micros()
        return out

    # -- exports -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The GET /device payload: per-device telemetry + windowed
        dispatch attribution + the fallback bridge state."""
        acct = self.accounting.snapshot()
        devices = []
        keys = sorted(set(self._samples) | set(acct["devices"]))
        for did in keys:
            sample = self._samples.get(did, {})
            row = {
                "id": did,
                "platform": sample.get("platform"),
                "kind": sample.get("kind"),
                "hbm": sample.get("hbm"),
                "live_buffers": sample.get("live_buffers"),
                "busy_fraction": round(self._busy_fraction(did), 4),
                "queue_depth": self.queue_depth(did),
                "queue_wait_micros": round(
                    self._queue_wait_micros(did), 1
                ),
                "transfer_bytes_per_sec": round(
                    self._transfer_rate(did), 1
                ),
                "dispatch_totals": acct["devices"].get(did),
            }
            devices.append(row)
        backlog, growth = self.backlog_window()
        return {
            "now_micros": self.now_micros(),
            "devices": devices,
            "totals": acct["totals"],
            "backlog": backlog,
            "backlog_growth_in_window": growth,
            "fallback_active": self.fallback_active(),
            "fallback_evidence": (
                self.fallback_evidence()
                if self.fallback_active() else None
            ),
        }
