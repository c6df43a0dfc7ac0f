"""Pipelined wire ingest: parallel CTS decode + batched Merkle ids.

Port of corda_tpu/node/ingest.py: the stage that FEEDS the batch
verifier — decode a wire blob, compute the transaction id, stage the
signature requests — as three stages behind one seam, so the card's
dispatch is not starved by one-transaction-at-a-time host work:

  blobs -> [DecodePool]  sharded worker threads run the CTS decoder on
           slices of the arrival batch, DOUBLE-BUFFERED: decode of
           batch N+1 overlaps the consumer's verify dispatch of batch
           N (the card's work and its copies release the GIL; the
           decode threads fill that window instead of idling).
        -> [batched Merkle-id]  every decoded transaction's component
           leaves are hashed in ONE batched SHA-256 pass
           (hashes.sha256_many -> one native call) and the roots in
           one merkle_roots_from_digests call, instead of per-leaf
           round trips per transaction. A leaf-digest cache keyed on
           the component's canonical bytes plus a subtree(root) cache
           keyed on the concatenated leaf digests mean RE-SEEN
           structures (the same notary Party in every tx, hot
           commands, re-delivered frames) skip hashing entirely —
           bit-identity is free because the key IS the preimage.
        -> [staging]  signature requests are built once here
           (memoised on the SignedTransaction), so the notary flush
           and the verifier worker drain pre-staged work instead of
           re-staging per consumer.

  A bounded HOT-FRAME cache in front of the decode pool is the limit
  case of the same content-keyed idea: CTS is canonical (same bytes
  <=> same value, and the decoded objects are frozen), so a frame
  byte-identical to a recently decoded one reuses the decoded
  transaction — with its id and staged requests — outright.
        -> [IngestRing]  a BOUNDED handoff: `put` blocks when the
           consumer is behind, which is the backpressure that stops
           the decode pool from running unboundedly ahead of the
           dispatch it feeds (notary.BatchingNotaryService
           .attach_ingest drains it on every flush).

Per-blob fault isolation throughout: a malformed blob yields an
IngestedTx carrying its exception in ITS slot — the rest of the batch
ingests normally (mirrors the notary flush's per-tx staging guard).

`IngestPipeline(perf=)` reports every batch's frames and stage seconds
to the perf plane (`PerfPlane.observe_ingest`), and `txstory=` stamps
each ingested frame's decode and stage on its transaction's lifecycle
story. The leaf and root cache sizes are the module constants below;
the frame cache's is `frame_cache_size=` (FRAME_CACHE_SIZE by default,
0 disables it). Staging always runs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Optional

from ..core import serialization as ser
from ..core.transactions import SignedTransaction
from ..crypto.hashes import SecureHash, sha256_many
from ..crypto.merkle import merkle_roots_from_digests
from ..utils import locks, tracing
from .qos import DeadlineExpired, expired

LEAF_CACHE_SIZE = 65536     # component-leaf digests
ROOT_CACHE_SIZE = 16384     # Merkle roots by concatenated leaf digests
FRAME_CACHE_SIZE = 8192     # whole frames -> (stx, obj, staged requests)


@dataclass
class IngestedTx:
    """One wire blob's ingest outcome.

    On success `stx` carries the decoded transaction with its id
    already installed (`stx.wtx.id` is a cache hit) and its signature
    requests already staged (`stx.signature_requests()` returns
    `requests` without rebuilding). On failure `error` holds the
    exception and the other fields stay empty — the slot's position in
    the batch is preserved either way."""

    blob: bytes
    stx: Optional[SignedTransaction] = None
    obj: Any = None            # the decoded wire object (== stx unless a
    #                            custom extract pulled the stx out of an
    #                            envelope, e.g. TxVerificationRequest)
    error: Optional[Exception] = None
    requests: list = field(default_factory=list)
    # tracing (utils/tracing.py): the frame's LIVE root span, opened at
    # ingest (continuing the wire frame's propagated context when the
    # fabric carried one). None whenever tracing is off.
    span: Any = None
    # the frame's propagated absolute-microsecond deadline
    # (messaging.Message.deadline). A frame already expired at ingest
    # is shed PRE-DECODE — error becomes qos.DeadlineExpired and no
    # decode/id/stage work is spent on it.
    deadline: Optional[int] = None

    @property
    def tx_id(self) -> Optional[SecureHash]:
        return None if self.stx is None else self.stx.id


class DigestCache:
    """Bounded content-keyed cache with FIFO eviction.

    Keys are content (a leaf's id-preimage, a tree's concatenated leaf
    digests, a whole wire frame), so a hit is bit-identical by
    construction. Eviction drops the oldest eighth in one sweep —
    cheap, and the hot keys (shared notary/command components)
    re-enter immediately."""

    __slots__ = ("_map", "_cap")

    def __init__(self, capacity: int = 65536):
        self._map: dict[bytes, Any] = {}
        self._cap = max(capacity, 8)

    def get(self, key: bytes) -> Optional[Any]:
        return self._map.get(key)

    def put(self, key: bytes, value: Any) -> None:
        m = self._map
        if key not in m and len(m) >= self._cap:
            drop = max(1, self._cap // 8)
            for k in list(m.keys())[:drop]:
                del m[k]
        m[key] = value

    def __len__(self) -> int:
        return len(self._map)


def install_tx_ids(
    wtxs: list,
    leaf_cache: Optional[DigestCache] = None,
    root_cache: Optional[DigestCache] = None,
) -> None:
    """Vectorised Merkle-id stage: compute and install `_id_cache` for
    every WireTransaction in `wtxs` with ONE batched SHA-256 pass over
    all uncached component leaves and one batched tree pass over all
    uncached roots. Bit-identical to the per-tx `wtx.id` walk — the
    preimage encoding is shared (WireTransaction.leaf_preimages) and
    the caches key on content."""
    todo = [w for w in wtxs if w.__dict__.get("_id_cache") is None]
    if not todo:
        return
    rows: list[list] = []
    # duplicate preimages (and whole transactions) are common in a
    # batch — hash each distinct payload once
    pending: dict[bytes, list[tuple[int, int]]] = {}
    for w in todo:
        pres = w.leaf_preimages()
        row: list = [None] * len(pres)
        ri = len(rows)
        for j, p in enumerate(pres):
            d = leaf_cache.get(p) if leaf_cache is not None else None
            if d is None:
                pending.setdefault(p, []).append((ri, j))
            else:
                row[j] = d
        rows.append(row)
    if pending:
        payloads = list(pending)
        for p, d in zip(payloads, sha256_many(payloads)):
            if leaf_cache is not None:
                leaf_cache.put(p, d)
            for ri, j in pending[p]:
                rows[ri][j] = d
    # root stage: subtree cache keyed on the tree's full leaf-digest
    # concatenation (the subtree IS determined by it)
    roots: list = [None] * len(rows)
    need: dict[bytes, list[int]] = {}
    for i, row in enumerate(rows):
        key = b"".join(row)
        r = root_cache.get(key) if root_cache is not None else None
        if r is None:
            need.setdefault(key, []).append(i)
        else:
            roots[i] = r
    if need:
        uniq = list(need)
        for key, root in zip(
            uniq, merkle_roots_from_digests([rows[need[k][0]] for k in uniq])
        ):
            if root_cache is not None:
                root_cache.put(key, root)
            for i in need[key]:
                roots[i] = root
    for w, r in zip(todo, roots):
        object.__setattr__(w, "_id_cache", SecureHash(r))


class _SliceFuture:
    """Handle over one decode batch split across pool workers."""

    def __init__(self, futures: list, blobs: list):
        self._futures = futures
        self.blobs = blobs

    def result(self) -> list:
        out: list = []
        for f in self._futures:
            out.extend(f.result())
        return out


class DecodePool:
    """Sharded CTS decode workers.

    CPython's GIL serialises the C decoder itself, so the pool's win is
    OVERLAP, not intra-batch parallelism: while the consumer of batch N
    waits on the card (GIL released), the workers decode batch N+1 in
    that window. Shards stay small accordingly."""

    def __init__(self, shards: Optional[int] = None, decode=ser.decode):
        # 2, not cpu_count: decode holds the GIL, so more shards only
        # buy contention
        self.shards = shards or 2
        self._decode = decode
        self._ex = ThreadPoolExecutor(
            max_workers=self.shards, thread_name_prefix="cts-ingest"
        )

    def _decode_slice(self, blobs: list) -> list:
        out = []
        decode = self._decode
        for b in blobs:
            try:
                out.append(decode(b))
            except Exception as e:  # noqa: BLE001 - per-blob isolation
                out.append(e)
        return out

    def decode_async(self, blobs: list) -> _SliceFuture:
        """Kick off decoding of a whole batch; slices go to the
        workers, per-blob errors are captured in their slots."""
        n = len(blobs)
        step = max(1, -(-n // self.shards))
        futures = [
            self._ex.submit(self._decode_slice, blobs[off : off + step])
            for off in range(0, n, step)
        ]
        return _SliceFuture(futures, blobs)

    def close(self) -> None:
        self._ex.shutdown(wait=False)


class IngestRing:
    """Bounded batch handoff between the ingest pipeline (producer)
    and the verify/notary consumer — THE backpressure seam: `put`
    blocks once `depth` batches wait unconsumed, so decode can never
    run unboundedly ahead of the dispatch it feeds."""

    def __init__(self, depth: int = 2):
        self.depth = max(1, depth)
        self._dq: deque = deque()
        self._cond = locks.make_condition("IngestRing._cond")
        self._closed = False
        # lifetime high-water mark (messaging.register_ring_gauges
        # exports it beside the depth)
        self.high_water = 0

    def put(self, batch, timeout: Optional[float] = None) -> bool:
        """Block until there is room (backpressure); False on timeout
        or when the ring is closed."""
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._closed or len(self._dq) < self.depth, timeout
            ):
                return False
            if self._closed:
                return False
            self._append_locked(batch)
            return True

    def offer(self, batch) -> bool:
        """Non-blocking put — the messaging fast path parks the frame
        for redelivery instead of blocking the pump when this is
        False."""
        with self._cond:
            if self._closed or len(self._dq) >= self.depth:
                return False
            self._append_locked(batch)
            return True

    def _append_locked(self, batch) -> None:
        self._dq.append(batch)
        if len(self._dq) > self.high_water:
            self.high_water = len(self._dq)
        self._cond.notify_all()

    def take(self, timeout: Optional[float] = None):
        """Next batch, blocking up to `timeout`; None when empty/closed."""
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._closed or self._dq, timeout
            ):
                return None
            if not self._dq:
                return None
            batch = self._dq.popleft()
            self._cond.notify_all()
            return batch

    def drain(self) -> list:
        """Every waiting batch, without blocking (the notary tick)."""
        with self._cond:
            out = list(self._dq)
            self._dq.clear()
            self._cond.notify_all()
            return out

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._dq)


class IngestPipeline:
    """The composed subsystem: sharded decode -> batched Merkle id ->
    staging -> bounded ring.

    `extract` maps a decoded wire object to the SignedTransaction to
    id/stage — identity for bare stx blobs, `lambda req: req.stx` for
    verifier-request envelopes. `stage_seconds` sums each stage's
    host seconds (decode, which includes any overlap waited out at the
    decode handle; merkle_id; stage) over every batch.

    `perf`: an optional utils/perf.PerfPlane. Every finished batch
    reports its frame count and per-stage (decode / merkle-id /
    staging) host seconds, so the plane attributes the pre-flush host
    work, and its `wire_ingest_pipelined_per_sec` history key tracks
    the live ingest rate.

    `txstory`: an optional utils/txstory.TxStory. Every successfully
    ingested frame stamps `ingest.decode` + `ingest.stage` lifecycle
    events (batch-shared stage seconds as attributes) onto its
    transaction's story — the earliest per-tx provenance a wire arrival
    gets.

    `decode` replaces the CTS decoder (a test's counting decoder);
    `frame_cache_size` bounds the frame cache (0 disables it)."""

    def __init__(
        self,
        shards: Optional[int] = None,
        ring_depth: int = 2,
        extract: Callable[[Any], Optional[SignedTransaction]] = None,
        tracer=None,
        perf=None,
        txstory=None,
        decode=ser.decode,
        frame_cache_size: int = FRAME_CACHE_SIZE,
    ):
        self.pool = DecodePool(shards, decode)
        self.ring = IngestRing(ring_depth)
        self.leaf_cache = DigestCache(LEAF_CACHE_SIZE)
        self.root_cache = DigestCache(ROOT_CACHE_SIZE)
        # frame cache: blob bytes -> finished (stx, obj, staged
        # requests). 0 disables. Only SUCCESSFUL ingests are cached — a
        # malformed frame re-decodes so every arrival reports its own
        # error.
        self.frame_cache = (
            DigestCache(frame_cache_size) if frame_cache_size else None
        )
        self.frame_hits = 0
        self.stage_seconds = {"decode": 0.0, "merkle_id": 0.0, "stage": 0.0}
        self._extract = extract or (lambda obj: obj)
        # explicit tracer, or the process default resolved per batch
        # (None here so a later set_tracer()/env enable is honoured)
        self.tracer = tracer
        self.perf = perf
        self.txstory = txstory

    def _tracer(self):
        return self.tracer if self.tracer is not None else tracing.get_tracer()

    # -- one batch ---------------------------------------------------------

    def ingest(
        self,
        blobs: list,
        trace_parents: Optional[list] = None,
        end_spans: bool = True,
        deadlines: Optional[list] = None,
        now_micros: Optional[int] = None,
    ) -> list[IngestedTx]:
        """Decode + id + stage one batch synchronously (the pipelined
        form below overlaps; this is the building block and the test
        surface).

        Tracing: with the tracer enabled, every entry gets a root span
        (continuing `trace_parents[i]` — the wire frame's propagated
        header — when given) plus decode / merkle_id / stage child
        spans carrying the batch-stage boundaries. `end_spans=False`
        leaves the root OPEN and hands ownership downstream.

        `deadlines[i]` (absolute node-clock micros, None = no deadline)
        sheds already-expired frames BEFORE the frame-cache probe and
        the decode pool ever see them; the entry carries
        `error=qos.DeadlineExpired` in its slot. Live deadlines ride
        out on `IngestedTx.deadline`."""
        return self._finish(
            self._start(blobs, trace_parents, deadlines, now_micros),
            end_spans,
        )

    def _start(
        self,
        blobs: list,
        trace_parents: Optional[list] = None,
        deadlines: Optional[list] = None,
        now_micros: Optional[int] = None,
    ):
        """Probe the frame cache, then kick the MISSES off on the
        decode pool. Returns the in-flight handle _finish consumes."""
        t0 = time.perf_counter()
        shed: dict[int, IngestedTx] = {}
        if deadlines is not None:
            if now_micros is None:
                now_micros = time.time_ns() // 1_000
            for i, d in enumerate(deadlines[: len(blobs)]):
                if expired(d, now_micros):
                    shed[i] = IngestedTx(
                        blobs[i],
                        error=DeadlineExpired(d, now_micros),
                        deadline=d,
                    )
        hits: dict[int, tuple] = {}
        cache = self.frame_cache
        misses, miss_idx = [], []
        for i, b in enumerate(blobs):
            if i in shed:
                continue
            cached = cache.get(b) if cache is not None else None
            if cached is None:
                misses.append(b)
                miss_idx.append(i)
            else:
                hits[i] = cached
        self.frame_hits += len(hits)
        handle = self.pool.decode_async(misses) if misses else None
        return blobs, hits, miss_idx, handle, trace_parents, t0, shed, deadlines

    def _finish(self, started, end_spans: bool = True) -> list[IngestedTx]:
        blobs, hits, miss_idx, handle, parents, t0, shed, deadlines = started
        entries: list[Optional[IngestedTx]] = [None] * len(blobs)
        for i, e in shed.items():
            entries[i] = e
        for i, (stx, obj, requests) in hits.items():
            entries[i] = IngestedTx(
                blobs[i], stx=stx, obj=obj, requests=requests
            )
        stxs: list[SignedTransaction] = []
        fresh: list[IngestedTx] = []
        results = handle.result() if handle is not None else []
        t_decode = time.perf_counter()
        for i, obj in zip(miss_idx, results):
            blob = blobs[i]
            if isinstance(obj, Exception):
                entries[i] = IngestedTx(blob, error=obj)
                continue
            try:
                stx = self._extract(obj)
                # None is a VALID extract result (a verifier-request
                # envelope with no stx: contract-only work) — the
                # entry passes through with nothing to id/stage.
                # Anything else non-stx is a malformed frame.
                if stx is not None and not isinstance(
                    stx, SignedTransaction
                ):
                    raise ser.SerializationError(
                        f"ingest expected a SignedTransaction, got "
                        f"{type(stx).__name__}"
                    )
            except Exception as e:  # noqa: BLE001 - per-blob isolation
                entries[i] = IngestedTx(blob, obj=obj, error=e)
                continue
            e = IngestedTx(blob, stx=stx, obj=obj)
            entries[i] = e
            if stx is not None:
                stxs.append(stx)
            fresh.append(e)
        install_tx_ids(
            [s.wtx for s in stxs], self.leaf_cache, self.root_cache
        )
        t_id = time.perf_counter()
        for e in fresh:
            if e.stx is not None:
                # memoised on the stx: downstream drains reuse this
                # exact list instead of re-staging
                e.requests = e.stx.signature_requests()
            if self.frame_cache is not None:
                self.frame_cache.put(e.blob, (e.stx, e.obj, e.requests))
        if deadlines is not None:
            # live deadlines ride out per-arrival (cache hits included:
            # the deadline belongs to THIS arrival, never to the cache)
            for i, d in enumerate(deadlines[: len(entries)]):
                if i not in shed and entries[i] is not None:
                    entries[i].deadline = d
        t_stage = time.perf_counter()
        sec = self.stage_seconds
        sec["decode"] += t_decode - t0
        sec["merkle_id"] += t_id - t_decode
        sec["stage"] += t_stage - t_id
        if self.perf is not None:
            # per-batch host-stage seconds (decode includes any overlap
            # waited out at handle.result(); hits skipped both) + frame
            # count into the plane's ingest-rate history key
            self.perf.observe_ingest(
                len(entries),
                max(0.0, t_decode - t0),
                max(0.0, t_id - t_decode),
                max(0.0, t_stage - t_id),
            )
        if self.txstory is not None:
            # lifecycle ledger: decode+stage events for every frame
            # whose tx id resolved (errors carry no id to key on) —
            # one lock hold for the whole batch
            ids = [
                e.tx_id for e in entries
                if e is not None and e.error is None
                and e.tx_id is not None
            ]
            if ids:
                self.txstory.ingest_batch(
                    ids,
                    max(0.0, t_decode - t0),
                    max(0.0, t_stage - t_id),
                )
        tracer = self._tracer()
        if tracer.enabled:
            self._emit_spans(
                tracer, entries, hits, parents,
                t0, t_decode, t_id, t_stage, end_spans,
            )
        return entries

    def _emit_spans(
        self, tracer, entries, hits, parents,
        t0, t_decode, t_id, t_stage, end_spans,
    ) -> None:
        """Per-frame trace assembly for one batch: a root span per
        entry (joining the frame's propagated context when the fabric
        carried one) with decode / merkle_id / stage children stamped
        with the BATCH stage boundaries — the stages run batched, so
        the interval is shared and the batch size is an attribute."""
        n = len(entries)
        for i, e in enumerate(entries):
            parent = None
            if parents is not None and i < len(parents):
                parent = parents[i]
            root = tracer.start_trace("notarise.frame", parent=parent)
            root.start = t0
            root.set_attribute("wire_bytes", len(e.blob))
            if e.tx_id is not None:
                root.set_attribute("tx_id", str(e.tx_id))
            if i in hits:
                root.set_attribute("frame_cache_hit", True)
            else:
                tracer.span_at(
                    "ingest.decode", root, t0, t_decode, batch=n
                )
                if e.error is None:
                    tracer.span_at(
                        "ingest.merkle_id", root, t_decode, t_id, batch=n
                    )
                    tracer.span_at(
                        "ingest.stage", root, t_id, t_stage, batch=n
                    )
            e.span = root
            if e.error is not None:
                root.set_attribute("error", repr(e.error))
                root.end(t_stage)   # nothing downstream will own it
            elif end_spans:
                root.end(t_stage)

    # -- double-buffered stream --------------------------------------------

    def pipeline(self, batches: Iterable[list]) -> Iterator[list[IngestedTx]]:
        """Yield ingested batches with decode of batch N+1 already
        running on the pool while the caller consumes batch N — the
        double buffer. The id/stage work for a batch happens on the
        caller's thread at yield time (it needs the decode output),
        overlapping the NEXT batch's decode."""
        it = iter(batches)
        try:
            started = self._start(next(it))
        except StopIteration:
            return
        for nxt in it:
            nxt_started = self._start(nxt)
            yield self._finish(started)
            started = nxt_started
        yield self._finish(started)

    def pipeline_blobs(
        self, blobs: list, chunk: int = 512
    ) -> Iterator[list[IngestedTx]]:
        """`pipeline` over a flat blob list in `chunk`-sized batches."""
        return self.pipeline(
            blobs[off : off + chunk] for off in range(0, len(blobs), chunk)
        )

    def feed(
        self,
        batches: Iterable[list],
        wrap: Optional[Callable[[list[IngestedTx]], Any]] = None,
        heartbeat=None,
    ) -> threading.Thread:
        """Producer loop on its own thread: ingest each batch and
        `put` it on self.ring, BLOCKING when the ring is full — the
        backpressure path the notary flush drains
        (BatchingNotaryService.attach_ingest). `wrap` maps each entry
        batch before the put (e.g. to _PendingNotarisation lists).

        `heartbeat`: an optional utils/health.Heartbeat beaten once per
        produced batch (progress = frames ingested), so a wedged decode
        pool — or a feed thread parked forever on a full ring nobody
        drains — trips the health plane's watchdog."""

        def run() -> None:
            for entries in self.pipeline(batches):
                if heartbeat is not None:
                    heartbeat.beat(progress=len(entries))
                item = wrap(entries) if wrap is not None else entries
                if not self.ring.put(item):
                    break   # ring closed: consumer shut down

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    def close(self) -> None:
        self.ring.close()
        self.pool.close()
