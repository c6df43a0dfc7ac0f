"""Notary services: uniqueness (double-spend prevention) + signing.

Port of corda_tpu/node/notary.py: the uniqueness providers (in-memory
and sharded), the time-window checker, the simple, validating and
batching notaries, the batching notary's sharded commit plane, its
join and streaming flush paths, its per-phase timers and its degraded
mode. Its verify dispatch goes to the hub's batch verifier — on the
card, CudaBatchVerifier — whose streamed handle
(`PendingVerification.chunks()`) the flush's streaming tail consumes.
The pipelined wire ingest's seam is ported (`attach_ingest`: the flush
drains a ring of pre-decoded, id'd and staged requests, node/ingest.py).
The reference's other optional planes are not: QoS (node/qos.py keeps
only deadline shedding), the health plane, the txstory ledger, the perf
and device planes and the intent journal; the constructor has no
argument for them, and the `deadline` every `process` takes is ignored,
as the reference ignores it without a QoS plane. The flow state machine
(flows/statemachine.py) drives `process` from NotaryServiceFlow; a
caller without flows drives it with `run_process`.

RSA and SPHINCS rows, which no device path verifies in either package,
ride the same dispatch: the verifier checks them on the host while the
card runs their batchmates (batch_verifier.HOST_SCHEMES). A row of a
scheme no path verifies (COMPOSITE as a signing key, an unknown id) is
answered `unsupported-scheme` at intake, before the dispatch. The
degraded mode's CPU fallback serves a CPU-device verifier only: with a
verifier on the card the notary never moves a flush to the host.

Reference: node/.../services/transactions/ (SURVEY §2.7) —
SimpleNotaryService / ValidatingNotaryService over a
PersistentUniquenessProvider (locked stateRef->consumingTx map,
PersistentUniquenessProvider.kt:20, commit :63+), TimeWindowChecker
(core/.../node/services/TimeWindowChecker.kt), and the NotaryFlow
service side (core/.../flows/NotaryFlow.kt:107-130).

Batch-first: the notary is the batch seam. `BatchingNotaryService`
accumulates concurrent notarisation requests in a queue and, on each
pump tick (or when `max_batch` fills), drains EVERY pending
transaction's signature checks through ONE BatchSignatureVerifier
dispatch — padded per-scheme batches on the card — then
commits inputs and scatters signed replies back to the waiting service
flows. This is the serving path the reference approximates with
horizontally-scaled verifier processes (SURVEY §2.5,
OutOfProcessTransactionVerifierService.kt:19-73).
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

from ..core import serialization as ser
from ..core.contracts import StateRef, TimeWindow
from ..core.identity import Party
from ..core.transactions import (
    FilteredTransaction,
    SignedTransaction,
    TransactionVerificationError,
)
from ..crypto.batch_verifier import HOST_SCHEMES, SCHEME_KERNELS, CpuBatchVerifier
from ..crypto.hashes import SecureHash
from ..crypto.schemes import CODE_NAMES
from ..flows.api import FlowFuture, _WaitFuture, wait_future
from ..utils import locks, tracing
from ..utils.metrics import MetricRegistry
from .messaging import register_ring_gauges
from .services import ServiceHub

# -- errors (wire-serializable: sent back to the requesting flow) ------------


@ser.serializable
@dataclass(frozen=True)
class NotaryError:
    """Base marker for notarisation failures (reference:
    core/.../flows/NotaryError.kt)."""

    kind: str
    message: str
    conflict: Any = None    # {state_ref: consuming_tx_id} for conflicts


class NotaryException(Exception):
    """A notarisation failed: raised in the requesting flow
    (core_flows.NotaryFlow) with the notary's NotaryError."""

    def __init__(self, error: NotaryError):
        self.error = error
        super().__init__(f"notarisation failed: {error.kind}: {error.message}")


class UniquenessConflict(Exception):
    def __init__(self, conflict: dict):
        self.conflict = conflict   # StateRef -> consuming tx id
        super().__init__(f"{len(conflict)} input(s) already consumed")


# journaled flow-future outcomes must round-trip the codec so a restored
# notary flow replays the same conflict
ser.register_custom(
    UniquenessConflict,
    "UniquenessConflict",
    lambda e: e.conflict,
    lambda v: UniquenessConflict(dict(v)),
)


# -- uniqueness providers ----------------------------------------------------


class UniquenessProvider:
    """stateRef -> consuming-tx registry; the core consensus primitive."""

    # True on providers whose commit completes inline on this host
    # (in-memory, sqlite): the batching notary then drains a whole
    # flush through ONE commit_many call instead of a future +
    # callback per transaction. Distributed providers (Raft, BFT)
    # stay False — their commits resolve on cluster consensus.
    batch_synchronous = False

    def commit(
        self, states: list[StateRef], tx_id: SecureHash, requester: Party
    ) -> None:
        raise NotImplementedError

    def commit_async(
        self,
        states: list[StateRef],
        tx_id: SecureHash,
        requester: Party,
        trace=None,
    ):
        """Future-shaped commit (what notary flows actually await):
        local providers resolve immediately; distributed ones (Raft,
        BFT) resolve when the cluster reaches consensus. `trace` is an
        optional trace context: distributed providers thread it
        through their protocol messages so every cluster member stamps
        consensus-phase spans into the requester's trace; local
        providers (commit resolves inline, nothing to attribute)
        ignore it."""
        del trace
        fut = FlowFuture()
        try:
            self.commit(states, tx_id, requester)
            fut.set_result(None)
        except Exception as e:
            fut.set_exception(e)
        return fut

    def commit_many(self, entries) -> list:
        """Batched commit: `entries` is [(states, tx_id, requester)];
        returns one outcome per entry, in order — None on success or
        the exception (UniquenessConflict etc.) that entry raised.
        Semantics are EXACTLY sequential commit in list order: an
        earlier entry's refs are committed before a later conflicting
        entry is checked, so intra-batch double spends resolve
        first-wins like they would one call at a time."""
        out = []
        for states, tx_id, requester in entries:
            try:
                self.commit(states, tx_id, requester)
                out.append(None)
            except Exception as e:   # noqa: BLE001 - per-entry outcome
                out.append(e)
        return out


class InMemoryUniquenessProvider(UniquenessProvider):
    """Single-node map (reference: PersistentUniquenessProvider
    semantics, minus the JDBC persistence — see persistence.py for the
    sqlite-backed version). Commit is all-or-nothing: on any conflict
    nothing is recorded and the full conflict set is reported."""

    batch_synchronous = True

    def __init__(self):
        self.committed: dict[StateRef, SecureHash] = {}

    def commit(self, states, tx_id, requester) -> None:
        conflict = {
            ref: self.committed[ref]
            for ref in states
            if ref in self.committed and self.committed[ref] != tx_id
        }
        if conflict:
            raise UniquenessConflict(conflict)
        for ref in states:
            self.committed[ref] = tx_id


# -- sharded uniqueness ------------------------------------------------------


def shard_of_ref(ref: StateRef, n_shards: int) -> int:
    """Deterministic state-ref -> shard routing: the first two bytes of
    the producing transaction's id, mod the shard count. A pure
    function of the ref bytes — the same ref lands on the same shard
    across restarts, processes and hosts, which is what makes the
    partitioned uniqueness namespace sound (a ref checked on the wrong
    partition would miss the committed row that conflicts it). Sibling
    outputs of one transaction share a prefix, so the common
    spend-what-one-tx-issued shape stays single-shard."""
    if n_shards <= 1:
        return 0
    return int.from_bytes(ref.txhash.bytes_[:2], "big") % n_shards


def shard_of_tx(stx, n_shards: int) -> int:
    """Home shard of one transaction: its first input's owning shard
    (input-less issues route by their own id — they touch no uniqueness
    namespace, any shard can serve them)."""
    if n_shards <= 1:
        return 0
    inputs = stx.wtx.inputs
    if inputs:
        return shard_of_ref(inputs[0], n_shards)
    return int.from_bytes(stx.id.bytes_[:2], "big") % n_shards


class _UniquenessPartition:
    """One shard's slice of the committed-state registry: the committed
    map, in-flight cross-shard reservations, and the condition that
    serialises both."""

    __slots__ = ("committed", "reserved", "cond")

    def __init__(self):
        self.committed: dict[StateRef, SecureHash] = {}
        # ref -> reserving tx id: marked by the reserve phase of a
        # cross-shard commit; holders resolve (commit or abort) within
        # one flush, so waiters never park long
        self.reserved: dict[StateRef, SecureHash] = {}
        self.cond = locks.make_condition("_UniquenessPartition.cond")


class ShardReservation:
    """A held cross-shard reservation (phase one of reserve→commit).

    Every involved partition holds `reserved[ref] = tx_id` rows for
    this transaction; `commit()` flips them to committed rows,
    `abort()` releases them — per partition atomically (under its
    condition), waking any committer parked on the reservation. A
    reservation resolves exactly once."""

    def __init__(self, provider, tx_id, requester, by_shard):
        self._provider = provider
        self._tx_id = tx_id
        self._requester = requester
        self._by_shard = by_shard      # shard id -> [StateRef], ascending
        self._resolved = False

    @property
    def shards(self) -> list[int]:
        return sorted(self._by_shard)

    def commit(self) -> None:
        self._resolve(commit=True)

    def abort(self) -> None:
        self._resolve(commit=False)

    def _resolve(self, commit: bool) -> None:
        if self._resolved:
            return
        self._resolved = True
        self._provider._resolve_reservation(
            self._by_shard, self._tx_id, self._requester, commit
        )


class ShardedUniquenessProvider(UniquenessProvider):
    """Partitioned committed-state registry: the uniqueness namespace
    split into `n_shards` slices by state-ref prefix (`shard_of_ref`),
    each with its own lock, so N shard flush pipelines commit
    concurrently instead of serialising on one map.

    Cross-shard transactions (inputs owned by more than one partition)
    take a deterministic two-phase reserve→commit: partitions are
    visited in ascending shard order (no lock-order cycles), each marks
    the refs reserved; any conflict aborts the whole reservation —
    releasing every partition's rows atomically — and reports the full
    conflict set, exactly as the single-map provider would. A committer
    that finds a ref reserved by ANOTHER transaction waits for that
    reservation to resolve (they resolve within one flush), so a
    rejected request always lost to a transaction that really
    committed — never to a reservation that later aborted. That is
    what keeps accept/reject decisions bit-exact against a serial
    single-shard replay.

    `record_decisions=True` keeps an append-only decision log
    [(tx_id, conflict-or-None)] in the exact serialisation order the
    partitions decided — the replay order the shard-correctness tests
    pin against a serial reference."""

    batch_synchronous = True

    def __init__(self, n_shards: int = 1, record_decisions: bool = False):
        self.n_shards = max(1, int(n_shards))
        self._parts = [_UniquenessPartition() for _ in range(self.n_shards)]
        self._decision_lock = locks.make_lock(
            "ShardedUniquenessProvider._decision_lock"
        )
        self.decisions: Optional[list] = [] if record_decisions else None

    # -- routing -----------------------------------------------------------

    def shard_of(self, ref: StateRef) -> int:
        return shard_of_ref(ref, self.n_shards)

    def _by_shard(self, states) -> dict[int, list[StateRef]]:
        out: dict[int, list[StateRef]] = {}
        for ref in states:
            out.setdefault(self.shard_of(ref), []).append(ref)
        return out

    # -- views -------------------------------------------------------------

    @property
    def committed(self) -> dict:
        """Merged read-only view across partitions (tests, snapshots)."""
        merged: dict[StateRef, SecureHash] = {}
        for part in self._parts:
            with part.cond:
                merged.update(part.committed)
        return merged

    def partition_depth(self, shard: int) -> int:
        part = self._parts[shard]
        with part.cond:
            return len(part.committed)

    # -- storage backend (overridden by the persistent subclass) ----------

    def _prior_consumer(self, shard: int, ref: StateRef):
        """The committed consumer of `ref` on `shard`, or None. Called
        under the partition condition."""
        return self._parts[shard].committed.get(ref)

    def _prior_consumers_many(self, shard: int, refs) -> dict:
        """Batched membership probe: {ref: committed consumer} for the
        subset of `refs` already committed on `shard` (absent = free).
        Called under the partition condition. The default is per-ref
        point probes; backends with a real batched sweep (the commit-
        log store's sorted mmap-index walk, the sqlite layer's one
        `IN (...)` query) override this — commit_many issues exactly
        ONE of these per flush run."""
        out = {}
        for ref in refs:
            prior = self._prior_consumer(shard, ref)
            if prior is not None:
                out[ref] = prior
        return out

    def _write_shard(self, shard: int, refs, tx_id, requester) -> None:
        """Durably commit `refs` -> tx_id on `shard`. Called under the
        partition condition."""
        committed = self._parts[shard].committed
        for ref in refs:
            committed[ref] = tx_id

    def _write_rows(self, shard: int, rows) -> None:
        """Durably commit a run of (ref, tx_id, requester) rows on one
        shard — commit_many's batched write. Called under the partition
        condition."""
        committed = self._parts[shard].committed
        for ref, tx_id, _requester in rows:
            committed[ref] = tx_id

    # -- the two-phase core ------------------------------------------------

    def reserve(self, states, tx_id, requester) -> ShardReservation:
        """Phase one: mark every ref reserved across its owning
        partitions (ascending shard order). Raises UniquenessConflict
        with the FULL conflict set — after releasing any rows already
        reserved — when any ref is already committed to a different
        transaction. Blocks (briefly) on other transactions' in-flight
        reservations rather than failing against them: a reservation is
        not a commit until it resolves."""
        by_shard = self._by_shard(states)
        reserved: dict[int, list[StateRef]] = {}
        conflict: dict[StateRef, SecureHash] = {}
        try:
            for shard in sorted(by_shard):
                part = self._parts[shard]
                refs = by_shard[shard]
                with part.cond:
                    # wait out other transactions' reservations on our
                    # refs — but not once a conflict already doomed the
                    # request: the remaining shards are only visited to
                    # complete the conflict REPORT, and parking a dead
                    # request behind unrelated reservations would add
                    # latency exactly under contention
                    if not conflict:
                        part.cond.wait_for(
                            lambda: all(
                                part.reserved.get(r) in (None, tx_id)
                                for r in refs
                            )
                        )
                    for ref in refs:
                        prior = self._prior_consumer(shard, ref)
                        if prior is not None and prior != tx_id:
                            conflict[ref] = prior
                    if conflict:
                        # keep scanning remaining shards for the
                        # complete conflict report, but reserve nothing
                        # further
                        continue
                    for ref in refs:
                        part.reserved[ref] = tx_id
                    reserved[shard] = refs
        except BaseException:
            # a storage-backend error mid-reserve (e.g. the persistent
            # subclass's _prior_consumer hitting a locked database) must
            # not LEAK the partitions already reserved — a leaked row is
            # waited on forever by every later committer of those refs
            self._resolve_reservation(reserved, tx_id, requester, False)
            raise
        if conflict:
            self._resolve_reservation(reserved, tx_id, requester, False)
            self._record(tx_id, conflict)
            raise UniquenessConflict(conflict)
        return ShardReservation(self, tx_id, requester, reserved)

    def _resolve_reservation(self, by_shard, tx_id, requester, commit) -> None:
        if commit:
            # record the accept BEFORE any partition flips: a loser can
            # only observe (and record its conflict against) this
            # transaction after its rows became visible, so the decision
            # log stays in true serialisation order — the property the
            # serial-replay tests ride on
            self._record(tx_id, None)
        for shard in sorted(by_shard):
            part = self._parts[shard]
            refs = by_shard[shard]
            with part.cond:
                for ref in refs:
                    if part.reserved.get(ref) == tx_id:
                        del part.reserved[ref]
                if commit:
                    self._write_shard(shard, refs, tx_id, requester)
                part.cond.notify_all()

    def _record(self, tx_id, conflict) -> None:
        if self.decisions is not None:
            with self._decision_lock:
                self.decisions.append((tx_id, conflict))

    # -- UniquenessProvider SPI -------------------------------------------

    def commit_many(self, entries) -> list:
        """Batched commit with EXACTLY sequential first-wins semantics
        (the UniquenessProvider contract), tuned for the shard flush's
        shape: consecutive entries fully owned by ONE partition — the
        overwhelming majority, since the flush that calls this already
        routed by home shard — process as a run under a single
        condition hold (one acquire + one backing write per run, like
        the unsharded provider's one-lock commit_many), with a staged
        view so intra-run conflicts resolve first-wins. Cross-shard
        entries fall back to the per-entry two-phase commit in place,
        preserving order."""
        out: list = [None] * len(entries)
        n = len(entries)
        shard_of = self.shard_of
        i = 0
        while i < n:
            home = None
            for ref in entries[i][0]:
                s = shard_of(ref)
                if home is None:
                    home = s
                elif s != home:
                    home = -1
                    break
            if home == -1:
                # cross-shard: the two-phase reserve→commit, in order
                try:
                    self.commit(*entries[i])
                except Exception as e:   # noqa: BLE001 - per-entry outcome
                    out[i] = e
                i += 1
                continue
            home = home or 0
            # extend the single-shard run
            j = i + 1
            while j < n:
                states_j = entries[j][0]
                if any(shard_of(r) != home for r in states_j):
                    break
                j += 1
            part = self._parts[home]
            rows: list = []
            staged: dict = {}
            done = i
            with part.cond:
                # the condition is held for the WHOLE run — never
                # released mid-run, or the staged-but-unwritten rows
                # would be invisible to a concurrent cross-shard
                # reserve on this partition, which could then accept a
                # second consumer for a staged ref. An entry whose refs
                # carry someone ELSE's in-flight reservation therefore
                # TRUNCATES the run (we must not wait while holding
                # staged state); it re-enters below via the per-entry
                # two-phase path, which parks on the reservation
                # correctly.
                # ONE batched membership probe for the whole run: the
                # backing store never changes under the held condition
                # (the run's own rows write at the end), so the
                # persisted view is fixed — only the staged view
                # evolves entry to entry
                run_refs: list = []
                seen: set = set()
                for k in range(i, j):
                    for ref in entries[k][0]:
                        if ref not in seen:
                            seen.add(ref)
                            run_refs.append(ref)
                persisted = self._prior_consumers_many(home, run_refs)
                for k in range(i, j):
                    states_k, tx_k, req_k = entries[k]
                    if any(
                        part.reserved.get(r) not in (None, tx_k)
                        for r in states_k
                    ):
                        break
                    conflict = {}
                    for ref in states_k:
                        prior = staged.get(ref)
                        if prior is None:
                            prior = persisted.get(ref)
                        if prior is not None and prior != tx_k:
                            conflict[ref] = prior
                    if conflict:
                        out[k] = UniquenessConflict(conflict)
                        self._record(tx_k, conflict)
                    else:
                        for ref in states_k:
                            staged[ref] = tx_k
                            rows.append((ref, tx_k, req_k))
                        self._record(tx_k, None)
                    done = k + 1
                if rows:
                    self._write_rows(home, rows)
            if done == i:
                # first entry of the run is blocked on a foreign
                # reservation: the per-entry commit path waits it out
                try:
                    self.commit(*entries[i])
                except Exception as e:   # noqa: BLE001 - per-entry outcome
                    out[i] = e
                done = i + 1
            i = done
        return out

    def commit(self, states, tx_id, requester) -> None:
        by_shard = self._by_shard(states)
        if len(by_shard) <= 1:
            # single-partition fast path: check + write under ONE
            # condition hold — no reservation round trip
            shard = next(iter(by_shard), 0)
            part = self._parts[shard]
            refs = by_shard.get(shard, [])
            with part.cond:
                part.cond.wait_for(
                    lambda: all(
                        part.reserved.get(r) in (None, tx_id) for r in refs
                    )
                )
                conflict = {}
                for ref in refs:
                    prior = self._prior_consumer(shard, ref)
                    if prior is not None and prior != tx_id:
                        conflict[ref] = prior
                if conflict:
                    self._record(tx_id, conflict)
                    raise UniquenessConflict(conflict)
                # record inside the hold: the accept must serialise
                # into the decision log before any later conflict
                # against these rows can be recorded
                self._record(tx_id, None)
                self._write_shard(shard, refs, tx_id, requester)
            return
        self.reserve(states, tx_id, requester).commit()


# -- time window -------------------------------------------------------------


class TimeWindowChecker:
    """Clock-tolerance validation (TimeWindowChecker.kt): the notary
    accepts a window iff `now` (± tolerance) intersects it."""

    def __init__(self, clock, tolerance_micros: int = 30_000_000):
        self.clock = clock
        self.tolerance = tolerance_micros

    def is_valid(self, tw: Optional[TimeWindow], now: Optional[int] = None) -> bool:
        """`now` override: distributed notaries validate against the
        consensus-ordered timestamp so every replica gets one answer."""
        if tw is None:
            return True
        if now is None:
            now = self.clock.now_micros()
        if tw.until_time is not None and now - self.tolerance >= tw.until_time:
            return False
        if tw.from_time is not None and now + self.tolerance < tw.from_time:
            return False
        return True


# -- the services ------------------------------------------------------------


class NotaryService:
    """Common commit-and-sign core shared by every notary flavour."""

    validating = False

    def __init__(
        self,
        services: ServiceHub,
        uniqueness: Optional[UniquenessProvider] = None,
        tolerance_micros: int = 30_000_000,
        service_identity: Optional[Party] = None,
    ):
        """`service_identity`: the cluster-shared notary Party for
        distributed notaries (each member holds the shared key and
        answers for it); None = this node's own identity."""
        self.services = services
        self.uniqueness = uniqueness or InMemoryUniquenessProvider()
        self.time_window_checker = TimeWindowChecker(
            services.clock, tolerance_micros
        )
        self.service_identity = service_identity

    @property
    def identity(self) -> Party:
        if self.service_identity is not None:
            return self.service_identity
        return self.services.my_info.notary_identity

    def commit_and_sign(
        self,
        tx_id: SecureHash,
        inputs: list[StateRef],
        time_window: Optional[TimeWindow],
        requester: Party,
        trace=None,
    ):
        """validate time window -> commit inputs -> sign tx id
        (NotaryFlow.Service.call, NotaryFlow.kt:110-130). A generator
        (`yield from` it inside a flow): the commit awaits the
        uniqueness provider's future, which suspends the service flow
        while a distributed provider reaches consensus. Returns a
        TransactionSignature or a NotaryError. `trace`: optional trace
        context handed to the provider so a distributed commit's
        consensus-phase spans join the requester's trace."""
        if not self.time_window_checker.is_valid(time_window):
            return NotaryError(
                "time-window-invalid",
                f"window {time_window} outside notary clock tolerance",
            )
        try:
            yield from wait_future(
                self.uniqueness.commit_async(
                    inputs, tx_id, requester, trace=trace
                )
            )
        except UniquenessConflict as e:
            return NotaryError(
                "conflict",
                str(e),
                conflict={str(r): h for r, h in e.conflict.items()},
            )
        except Exception as e:
            return NotaryError("commit-unavailable", str(e))
        return self.services.key_management.sign(
            tx_id, self.identity.owning_key
        )


class SimpleNotaryService(NotaryService):
    """Non-validating: sees only a Merkle tear-off of (inputs, notary,
    time window) — privacy-preserving, trusts the requester for contract
    validity (SimpleNotaryService.kt)."""

    def process(
        self,
        ftx: FilteredTransaction,
        requester: Party,
        deadline: Optional[int] = None,
        trace=None,
    ):
        # `deadline` (the reference's QoS plane) is accepted on every
        # notary flavour so the service flow passes it uniformly;
        # without a QoS plane every flavour ignores it, as the
        # reference does when its `qos` is None. `trace`: an optional
        # trace context threaded to the uniqueness provider, where a
        # distributed (Raft) commit stamps per-member consensus-phase
        # spans into it.
        del deadline
        try:
            ftx.verify()
        except TransactionVerificationError as e:
            return NotaryError("invalid-proof", str(e))
        # completeness: a tear-off hiding an input (or the time window /
        # notary) would let the requester double-spend the hidden state
        from ..core.transactions import G_INPUTS, G_NOTARY, G_TIMEWINDOW

        for g, what in (
            (G_INPUTS, "inputs"),
            (G_NOTARY, "notary"),
            (G_TIMEWINDOW, "time window"),
        ):
            if not ftx.all_revealed(g):
                return NotaryError(
                    "incomplete-tearoff",
                    f"tear-off hides {what} components",
                )
        if ftx.notary != self.identity:
            return NotaryError(
                "wrong-notary", f"tx names notary {ftx.notary}, I am "
                f"{self.identity}"
            )
        return (
            yield from self.commit_and_sign(
                ftx.id, list(ftx.inputs), ftx.time_window, requester,
                trace=trace,
            )
        )


@dataclass
class _PendingNotarisation:
    stx: SignedTransaction
    requester: Party
    future: Any   # FlowFuture resolved with TransactionSignature | NotaryError
    # tracing: the request's live root span (utils/tracing.py). The
    # flush attributes its phase intervals to it and ENDS it when this
    # request is answered. None when tracing is off.
    span: Any = None


class _ShardAnswer:
    """Future proxy used by threaded shard workers: `set_result` lands
    the outcome on the notary's completion queue instead of resolving
    the real FlowFuture from a worker thread — the pump thread drains
    the queue and resolves, so flow resumption stays single-threaded
    (FlowFuture's contract). Duck-types the subset of the future
    surface the flush paths touch."""

    __slots__ = ("future", "_queue", "done")

    def __init__(self, future, queue):
        self.future = future
        self._queue = queue
        self.done = False

    def set_result(self, value) -> None:
        if self.done:
            return
        self.done = True
        self._queue.append((self.future, value))

    def add_done_callback(self, cb) -> None:
        # callbacks belong on the REAL future: they fire on the pump
        # thread when the completion drains
        self.future.add_done_callback(cb)


class _NotaryShard:
    """One slice of the sharded commit plane: a bounded pending queue,
    its own flush state and per-shard metrics. The
    BatchingNotaryService routes requests here by state-ref prefix
    (shard_of_tx) and either flushes shards inline from the pump tick
    or hands each one to a dedicated worker thread."""

    __slots__ = (
        "id", "pending", "oldest_arrival", "cond",
        "queue_bound", "flushes", "requests", "answered", "wake", "busy",
    )

    def __init__(self, sid: int, queue_bound: int, metrics):
        self.id = sid
        self.pending: list[_PendingNotarisation] = []
        self.oldest_arrival: Optional[int] = None
        self.cond = locks.make_condition("_NotaryShard.cond")
        self.queue_bound = queue_bound
        self.flushes = metrics.counter(f"Notary.Shard{sid}.Flushes")
        self.requests = metrics.counter(f"Notary.Shard{sid}.Requests")
        self.answered = metrics.counter(f"Notary.Shard{sid}.Answered")
        metrics.gauge(f"Notary.Shard{sid}.Depth", lambda: len(self.pending))
        self.wake = False              # worker flush requested
        self.busy = False              # a flush of this shard is running

    def depth(self) -> int:
        return len(self.pending)


def _on_card(services: ServiceHub) -> bool:
    """True where the hub's batch verifier (or the one it wraps) runs on
    a CUDA device; a hub without one uses default_verifier(), which
    does."""
    verifier = services._batch_verifier
    if verifier is None:
        return True
    while verifier is not None:
        if getattr(getattr(verifier, "device", None), "type", None) == "cuda":
            return True
        verifier = getattr(verifier, "inner", None)
    return False


class BatchingNotaryService(NotaryService):
    """Batch-committing validating notary — the serving path.

    `process` enqueues the request and suspends the service flow on a
    future; `flush` (driven by the pump tick, or immediately when
    `max_batch` requests are queued) drains the queue:

      queue -> ONE BatchSignatureVerifier dispatch over every pending
      transaction's signatures (the SPI buckets per scheme and pads to
      its batch sizes) -> per-tx required-signer/contract/time-window
      checks -> uniqueness commit in arrival order -> one Merkle-batch
      notary signature, scattered with per-tx inclusion proofs.

    With a streamed handle (CudaBatchVerifier's) and a synchronous
    uniqueness provider, chunk k's transactions validate and commit
    while the card still runs chunk k+1 (`_stream_tail`).
    """

    validating = True

    def __init__(
        self,
        services: ServiceHub,
        uniqueness: Optional[UniquenessProvider] = None,
        tolerance_micros: int = 30_000_000,
        service_identity: Optional[Party] = None,
        max_batch: int = 512,
        max_wait_micros: int = 0,
        metrics: Optional[MetricRegistry] = None,
        shards: int = 1,
        shard_workers: bool = False,
        shard_queue_depth: int = 0,
        degraded_fallback: bool = False,
    ):
        """`max_wait_micros` is the batching DEADLINE: 0 (default)
        flushes every pump tick; positive, the tick HOLDS arrivals until
        the oldest one has waited that long (or `max_batch` fills).

        `metrics`: the node's MetricRegistry (batching counters, ratio
        gauge, flush-phase timers); None keeps a private registry. Set
        CORDA_TPU_NOTARY_PROFILE=1 to also sum per-phase wall seconds
        into `phase_seconds`.

        `shards` > 1 partitions the COMMIT PLANE: requests route by
        state-ref prefix (shard_of_tx) onto N shards, each with its own
        bounded pending queue, flush pipeline and uniqueness partition
        (pass a ShardedUniquenessProvider); every shard dispatches to
        the hub's verifier. Cross-shard
        transactions take the provider's two-phase reserve→commit.
        `shard_workers=True` gives every shard a flush thread; False
        flushes due shards from the tick in a dispatch-all-then-consume
        wave. `shard_queue_depth` bounds each shard's queue (0 = 4x
        max_batch); a full queue triggers that shard's flush.

        `degraded_fallback` (for a CPU-device verifier only; a verifier
        on the card refuses it, so no flush moves to the host): a
        verifier exception at the dispatch retries once, then serves
        THAT flush through the CPU reference verifier (bit-exact:
        CpuBatchVerifier is what the kernels are held against),
        counting Notary.DegradedFlushes and setting `degraded`; the
        next flush's dispatch is the recovery probe. A batch that fails
        deterministically (the CPU pass raises too) is bisected to
        quarantine the poison transaction(s). False (the default): one
        dispatch failure answers the whole flush
        `verification-unavailable`."""
        if degraded_fallback and _on_card(services):
            raise ValueError(
                "degraded_fallback moves a flush to the CPU: refused while "
                "the hub's batch verifier runs on the card"
            )
        super().__init__(
            services, uniqueness, tolerance_micros, service_identity
        )
        self.max_batch = max_batch
        self.max_wait_micros = max_wait_micros
        self._pending: list[_PendingNotarisation] = []
        self._oldest_arrival: Optional[int] = None
        self._ingest_ring = None       # attach_ingest
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._batches_counter = self.metrics.counter(
            "Notary.BatchesDispatched"
        )
        self._requests_counter = self.metrics.counter(
            "Notary.RequestsBatched"
        )
        self.metrics.gauge(
            "Notary.BatchingRatio",
            lambda: (
                self._requests_counter.count / self._batches_counter.count
                if self._batches_counter.count
                else 0.0
            ),
        )
        # per-phase flush timers: always on (a handful of updates per
        # FLUSH, not per tx)
        self._phase_timers: dict[str, Any] = {}
        self._phase_profile: Optional[dict] = (
            {} if os.environ.get("CORDA_TPU_NOTARY_PROFILE") else None
        )
        # -- fault-tolerance plane -----------------------------------------
        self.degraded_fallback = degraded_fallback
        self._degraded = False         # device path currently distrusted
        self._degraded_last: dict = {}     # evidence: error, at_micros
        self._cpu_reference = None         # lazy CpuBatchVerifier
        self._degraded_counter = self.metrics.counter(
            "Notary.DegradedFlushes"
        )
        self._quarantined_counter = self.metrics.counter(
            "Notary.Quarantined"
        )
        self.quarantined: list = []        # poison tx ids, boot-scoped
        self.metrics.gauge(
            "Notary.DegradedMode", lambda: 1 if self._degraded else 0
        )
        # -- sharded commit plane --------------------------------------------
        self.n_shards = max(1, int(shards))
        self._shards: Optional[list[_NotaryShard]] = None
        self._completions = None       # worker mode: (future, outcome)
        self._workers: list[threading.Thread] = []
        self._stop_workers = False
        self._gc_lock = locks.make_lock("BatchingNotaryService._gc_lock")
        self._gc_depth = 0
        self._gc_reenable = False
        if self.n_shards > 1:
            if not getattr(self.uniqueness, "batch_synchronous", False):
                raise ValueError(
                    "sharded commit plane requires a batch_synchronous "
                    "uniqueness provider (distributed providers resolve "
                    "on consensus, not on the shard flush)"
                )
            bound = shard_queue_depth or 4 * max_batch
            self._shards = [
                _NotaryShard(k, bound, self.metrics)
                for k in range(self.n_shards)
            ]
            self.metrics.gauge("Notary.Shards", lambda: self.n_shards)
            if shard_workers:
                self._completions = deque()
                for shard in self._shards:
                    t = threading.Thread(
                        target=self._shard_worker,
                        args=(shard,),
                        name=f"notary-shard-{shard.id}",
                        daemon=True,
                    )
                    self._workers.append(t)
                    t.start()

    # -- views over the registry-backed metrics ------------------------------

    @property
    def batches_dispatched(self) -> int:
        return self._batches_counter.count

    @property
    def requests_batched(self) -> int:
        return self._requests_counter.count

    @property
    def phase_seconds(self) -> Optional[dict]:
        """The CORDA_TPU_NOTARY_PROFILE accumulation dict, phase name ->
        wall seconds summed over flushes (None when profiling is off) —
        the live object, so callers may clear() it between passes."""
        return self._phase_profile

    def process(
        self,
        stx: SignedTransaction,
        requester: Party,
        deadline: Optional[int] = None,
        trace=None,
    ):
        """The service flow's entry (a generator: see `run_process`).
        `deadline` is ignored: no QoS plane (see SimpleNotaryService)."""
        del deadline
        if stx.wtx.notary != self.identity:
            return NotaryError(
                "wrong-notary",
                f"tx names notary {stx.wtx.notary}, I am {self.identity}",
            )
        fut = FlowFuture()
        # a root span per notarisation; with a propagated `trace`
        # context it JOINS the requester's trace
        tracer = tracing.get_tracer()
        span = None
        if tracer.enabled:
            span = tracer.start_trace(
                "notarise.request", parent=trace,
                tx_id=str(stx.id), requester=requester.name,
            )
        self.enqueue_pending(_PendingNotarisation(stx, requester, fut, span=span))
        if self._shards is None and len(self._pending) >= self.max_batch:
            self.flush()
        result = yield from wait_future(fut)
        return result

    def submit(self, stx: SignedTransaction, requester: Party):
        """Queue one notarisation WITHOUT the flow machinery and return
        its FlowFuture (bench rigs, tests, embedded drivers). Routes to
        the owning shard on the sharded plane. The future resolves on
        flush; unlike `process`, no notary check runs at intake (a tx
        naming another notary fails its signature checks instead)."""
        fut = FlowFuture()
        self.enqueue_pending(_PendingNotarisation(stx, requester, fut))
        return fut

    def enqueue_pending(self, p: _PendingNotarisation) -> None:
        """THE queue-routing step every intake path shares: the owning
        shard on the sharded plane, the single pending queue — with its
        oldest-arrival stamp — otherwise. Full-batch flush triggers stay
        with the callers: process() flushes the unsharded queue at
        max_batch, the shard router flushes a full shard itself,
        submit() never flushes."""
        if self._shards is not None:
            self._enqueue_sharded(p)
            return
        if not self._pending:
            self._oldest_arrival = self.services.clock.now_micros()
        self._pending.append(p)

    # -- shard routing -------------------------------------------------------

    def shard_of(self, stx) -> int:
        """The shard a transaction routes to (state-ref-prefix of its
        first input; pure and restart-stable — see shard_of_tx)."""
        return shard_of_tx(stx, self.n_shards)

    def _enqueue_sharded(self, p: _PendingNotarisation):
        shard = self._shards[shard_of_tx(p.stx, self.n_shards)]
        if self._completions is not None:
            # worker mode: the flush runs on the shard's thread, but
            # FlowFutures must resolve on the pump thread — proxy the
            # outcome through the completion queue
            p.future = _ShardAnswer(p.future, self._completions)
        flush_now = False
        with shard.cond:
            if not shard.pending:
                shard.oldest_arrival = self.services.clock.now_micros()
            shard.pending.append(p)
            depth = len(shard.pending)
            if depth >= self.max_batch or depth >= shard.queue_bound:
                # full batch (or full bounded queue): flush THIS shard —
                # the others keep accumulating their own batches
                if self._workers:
                    shard.wake = True
                    shard.cond.notify_all()
                else:
                    flush_now = True
        if flush_now:
            self._flush_one_shard(shard)
        return shard

    def attach_ingest(self, ring) -> None:
        """Wire the pipelined wire-ingest seam (node/ingest.py): the
        ring carries batches of _PendingNotarisation whose stx was
        decoded, Merkle-id'd and signature-staged by the ingest
        pipeline — the flush drains them directly, and its stage phase
        reuses the memoised staging instead of re-staging. The ring is
        BOUNDED: when this notary falls behind, the producer's `put`
        blocks, which is the backpressure that keeps the decode pool
        from running unboundedly ahead of the card's dispatch."""
        self._ingest_ring = ring
        # depth + high-water gauges on this notary's registry, so the
        # ring filling up shows BEFORE it stalls the producer
        register_ring_gauges(self.metrics, "notary", ring)

    def _drain_ingest(self) -> None:
        """Move every batch waiting on the ingest ring into the queue:
        per shard on the sharded plane (a full shard flushes, as at
        intake), else onto the pending queue, which the caller (tick
        or flush) flushes next."""
        ring = self._ingest_ring
        if ring is None:
            return
        if self._shards is not None:
            for batch in ring.drain():
                for p in batch:
                    self._enqueue_sharded(p)
            return
        for batch in ring.drain():
            self._pending.extend(batch)
        if self._pending and self._oldest_arrival is None:
            self._oldest_arrival = self.services.clock.now_micros()

    def backlog(self) -> int:
        """Live pending depth across the commit plane."""
        if self._shards is not None:
            return sum(shard.depth() for shard in self._shards)
        return len(self._pending)

    def tick(self) -> int:
        """Pump hook: flush whatever accumulated since the last tick —
        unless a batching deadline is set and neither it nor max_batch
        has been reached yet. Returns requests answered (0 = held or
        quiescent)."""
        if self._shards is not None:
            return self._tick_sharded()
        self._drain_ingest()
        n = len(self._pending)
        if not n:
            return 0
        if self.max_wait_micros and n < self.max_batch:
            age = (
                self.services.clock.now_micros()
                - (self._oldest_arrival or 0)
            )
            if age < self.max_wait_micros:
                return 0   # held while a batch forms
        self.flush()
        return n

    def _tick_sharded(self) -> int:
        """One pump round over the sharded commit plane: flush every
        shard whose batch is due — inline as a dispatch-all-then-consume
        wave (device compute for shard k overlaps host work for shard
        j), or by waking each due shard's worker thread. Completions
        from worker flushes resolve HERE, on the pump thread. Ingest
        arrivals route to their shards first."""
        self._drain_ingest()
        now = self.services.clock.now_micros()
        due: list[_NotaryShard] = []
        for shard in self._shards:
            with shard.cond:
                n = len(shard.pending)
                if not n:
                    continue
                wait = self.max_wait_micros
                if wait and n < self.max_batch:
                    if now - (shard.oldest_arrival or 0) < wait:
                        continue   # held while a batch forms
                if self._workers:
                    shard.wake = True
                    shard.cond.notify_all()
                else:
                    due.append(shard)
        answered = self._flush_wave(due) if due else 0
        return answered + self._drain_completions()

    def _drain_completions(self) -> int:
        """Resolve worker-flushed answers on the calling (pump) thread."""
        q = self._completions
        if not q:
            return 0
        n = 0
        while True:
            try:
                fut, outcome = q.popleft()
            except IndexError:
                break
            fut.set_result(outcome)
            n += 1
        return n

    def stop(self) -> None:
        """Stop shard worker threads (no-op without them)."""
        if not self._workers:
            return
        self._stop_workers = True
        for shard in self._shards or ():
            with shard.cond:
                shard.cond.notify_all()
        for t in self._workers:
            t.join(timeout=5)
        self._workers = []
        self._drain_completions()

    def _mark(
        self, phase: str, t_prev: float, marks: Optional[list] = None
    ) -> float:
        """Phase boundary: charge now - t_prev to `phase` on the
        registry timer (always), the profile dict (when
        CORDA_TPU_NOTARY_PROFILE is set), and `marks` (the per-flush
        interval list trace-span emission consumes). Returns now."""
        now = time.perf_counter()
        dt = now - t_prev
        timer = self._phase_timers.get(phase)
        if timer is None:
            timer = self._phase_timers[phase] = self.metrics.timer(
                "Notary.FlushPhase." + phase
            )
        timer.update(dt)
        if self._phase_profile is not None:
            self._phase_profile[phase] = (
                self._phase_profile.get(phase, 0.0) + dt
            )
        if marks is not None:
            marks.append((phase, t_prev, now))
        return now

    def _gc_pause(self) -> None:
        # A flush allocates O(batch) objects that stay reachable until
        # the scatter at the end: a generational collection mid-flush
        # walks the whole staged heap for nothing. Suspend automatic GC
        # for the bounded flush body; collection resumes between ticks.
        # Refcounted: concurrent shard-worker flushes share one pause.
        with self._gc_lock:
            self._gc_depth += 1
            if self._gc_depth == 1:
                self._gc_reenable = gc.isenabled()
                if self._gc_reenable:
                    gc.disable()

    def _gc_resume(self) -> None:
        with self._gc_lock:
            self._gc_depth -= 1
            if self._gc_depth == 0 and self._gc_reenable:
                gc.enable()

    def flush(self) -> None:
        """Drain everything pending NOW. On the sharded plane this
        flushes every shard: inline as one dispatch-all-then-consume
        wave, or — with worker threads — by waking every shard and
        blocking until they go idle, then resolving the completions on
        the calling thread (which acts as the pump)."""
        self._drain_ingest()   # pre-ingested arrivals join this flush
        if self._shards is not None:
            if self._workers:
                for shard in self._shards:
                    with shard.cond:
                        if shard.pending:
                            shard.wake = True
                            shard.cond.notify_all()
                for shard in self._shards:
                    with shard.cond:
                        # bounded waits: a stopped plane must not park
                        # this caller forever
                        while not shard.cond.wait_for(
                            lambda: not shard.pending and not shard.busy,
                            timeout=0.5,
                        ):
                            if self._stop_workers or not any(
                                t.is_alive() for t in self._workers
                            ):
                                break
                self._drain_completions()
            else:
                self._flush_wave(
                    [s for s in self._shards if s.pending]
                )
            return
        self._gc_pause()
        try:
            self._flush_inner()
        finally:
            self._gc_resume()

    # -- sharded flush machinery --------------------------------------------

    def _take_pending(self, shard) -> list[_PendingNotarisation]:
        with shard.cond:
            pending, shard.pending = shard.pending, []
            shard.oldest_arrival = None
            if pending:
                shard.busy = True
            return pending

    def _flush_wave(self, shards: list) -> int:
        """Inline sharded flush: phase A stages + dispatches EVERY due
        shard's verify batch (async), phase B consumes them in shard
        order — so while shard k's host validate/commit runs, shards
        k+1..N's device compute is already in flight. One GC pause
        spans the wave."""
        if not shards:
            return 0
        total = 0
        self._gc_pause()
        try:
            staged = []
            for shard in shards:
                pending = self._take_pending(shard)
                if not pending:
                    continue
                marks: list[tuple[str, float, float]] = []
                ctx = self._stage_and_dispatch(pending, marks)
                staged.append((shard, pending, marks, ctx))
            for shard, pending, marks, ctx in staged:
                try:
                    if ctx is not None:
                        self._consume_flush(ctx, marks)
                finally:
                    self._emit_flush_trace(pending, marks, shard)
                    self._shard_done(shard, len(pending))
                total += len(pending)
        finally:
            self._gc_resume()
        return total

    def _flush_one_shard(self, shard) -> int:
        """Full flush pipeline for ONE shard (worker threads; also the
        queue-full inline trigger)."""
        pending = self._take_pending(shard)
        if not pending:
            return 0
        self._gc_pause()
        try:
            marks: list[tuple[str, float, float]] = []
            try:
                ctx = self._stage_and_dispatch(pending, marks)
                if ctx is not None:
                    self._consume_flush(ctx, marks)
            finally:
                self._emit_flush_trace(pending, marks, shard)
                self._shard_done(shard, len(pending))
            return len(pending)
        finally:
            self._gc_resume()

    def _shard_done(self, shard, answered: int) -> None:
        shard.flushes.inc()
        if answered:
            shard.requests.inc(answered)
            shard.answered.inc(answered)
        with shard.cond:
            shard.busy = False
            shard.cond.notify_all()

    def _shard_worker(self, shard) -> None:
        """One shard's dedicated flush loop: wait for work (or a wake
        from the router/tick), honour the batching deadline, flush.
        Never dies — every flush path answers its futures on error, and
        an unexpected exception here logs rather than wedging the
        shard."""
        clock = self.services.clock
        while not self._stop_workers:
            with shard.cond:
                shard.cond.wait_for(
                    lambda: shard.wake or shard.pending or self._stop_workers,
                    timeout=0.05,
                )
                if self._stop_workers:
                    return
                woken, shard.wake = shard.wake, False
                n = len(shard.pending)
                if not n:
                    continue
                if not woken:
                    wait = self.max_wait_micros
                    if wait and n < self.max_batch:
                        if clock.now_micros() - (shard.oldest_arrival or 0) < wait:
                            continue
            try:
                self._flush_one_shard(shard)
            except Exception:   # noqa: BLE001 - keep the shard serving
                logging.getLogger("corda_tpu_torch.notary").exception(
                    "shard %d flush failed", shard.id
                )
                with shard.cond:
                    shard.busy = False
                    shard.cond.notify_all()

    def _flush_inner(self) -> None:
        pending, self._pending = self._pending, []
        self._oldest_arrival = None
        if not pending:
            return
        # `marks` collects this flush's phase intervals; the finally
        # attributes them to every member's trace and ENDS the
        # per-request root spans on every exit path
        marks: list[tuple[str, float, float]] = []
        try:
            ctx = self._stage_and_dispatch(pending, marks)
            if ctx is not None:
                self._consume_flush(ctx, marks)
        finally:
            self._emit_flush_trace(pending, marks)

    def _emit_flush_trace(self, pending, marks, shard=None) -> None:
        """Per-request trace assembly: the flush phases ran batched, so
        each interval is stamped into every traced member's tree (batch
        size as an attribute; the owning shard too on the sharded
        plane), on the tracer that OWNS the request's root span."""
        n = len(pending)
        sid = shard.id if shard is not None else None
        for p in pending:
            span = p.span
            if not span or span.ended:
                continue
            tracer = span._tracer
            attrs = {"batch": n} if sid is None else {"batch": n, "shard": sid}
            if sid is not None:
                span.set_attribute("shard", sid)
            for phase, t0, t1 in marks:
                tracer.span_at("notary." + phase, span, t0, t1, **attrs)
            # the root ends when the request is ANSWERED: a provider
            # whose commit resolves later ends it from a done callback
            fut = p.future
            if getattr(fut, "done", True) or not hasattr(
                fut, "add_done_callback"
            ):
                span.end()
            else:
                fut.add_done_callback(lambda f, s=span: s.end())

    def _stage_and_dispatch(self, pending, marks):
        """Phase A of a flush: stage every pending transaction's
        signature requests and launch the (async) SPI dispatch on the
        hub's verifier. Returns the flush context for _consume_flush, or
        None when there is nothing left to consume (every future
        already answered)."""
        t = time.perf_counter()
        # Staging is per-tx-protected: one malformed transaction must
        # answer ITS future and leave the rest of the batch alive
        reqs: list = []
        spans: list[tuple[int, int]] = []
        live: list[_PendingNotarisation] = []
        for p in pending:
            try:
                rs = p.stx.signature_requests()
            except Exception as e:
                p.future.set_result(
                    NotaryError("invalid-transaction", str(e))
                )
                continue
            missing = {r.key.scheme_id for r in rs} - SCHEME_KERNELS - HOST_SCHEMES
            if missing:
                # no path verifies these rows: answer the transaction
                # here, before the dispatch, instead of failing its flush
                names = ", ".join(
                    sorted(CODE_NAMES.get(m, str(m)) for m in missing)
                )
                p.future.set_result(
                    NotaryError(
                        "unsupported-scheme",
                        f"signature scheme {names} has no verification path",
                    )
                )
                continue
            spans.append((len(reqs), len(rs)))
            reqs.extend(rs)
            live.append(p)
        pending = live
        if not pending:
            return None
        t = self._mark("stage", t, marks)
        verifier = self.services.batch_verifier
        poison: set = set()
        try:
            collector: Optional[threading.Thread] = None
            box: dict = {}
            handle = None
            results = None
            try:
                # a named region in a torch.profiler capture, so the
                # host span lines up with the card's kernels
                with tracing.annotate(
                    "corda_tpu_torch.notary.batch_verify_dispatch"
                ):
                    if hasattr(verifier, "verify_batch_async"):
                        handle = verifier.verify_batch_async(reqs)
                    else:
                        results = verifier.verify_batch(reqs)
                if self._degraded and results is not None:
                    # the recovery probe: only a synchronous dispatch
                    # proves the device here; an async handle's fault
                    # surfaces at consume time, which owns that exit
                    self._exit_degraded()
            except Exception as first_err:
                if not self.degraded_fallback:
                    raise
                handle = None
                if not self._degraded:
                    # transient blip? one device retry before degrading
                    try:
                        results = verifier.verify_batch(reqs)
                    except Exception:
                        results, poison = self._degraded_verify(
                            pending, spans, reqs, first_err
                        )
                else:
                    # already degraded: the probe above just failed —
                    # no second device attempt, straight to the CPU
                    results, poison = self._degraded_verify(
                        pending, spans, reqs, first_err
                    )
            # STREAMING tail: when the handle's per-chunk results were
            # queued at dispatch and the uniqueness provider commits
            # synchronously, chunk k's transactions validate + commit
            # while the device still runs chunk k+1. Commit order stays
            # exactly arrival order (a monotonic pointer), so intra-batch
            # first-wins semantics are unchanged.
            stream_ok = (
                handle is not None
                and getattr(handle, "streamed", False)
                and getattr(self.uniqueness, "batch_synchronous", False)
            )
            if handle is not None and not stream_ok:
                # collect on a worker thread, overlapping the contract
                # pass below
                def _collect() -> None:
                    try:
                        box["results"] = handle.result()
                    except Exception as e:   # noqa: BLE001 - rethrown below
                        box["error"] = e

                collector = threading.Thread(
                    target=_collect, name="notary-collect", daemon=True
                )
                collector.start()
            t = self._mark("dispatch", t, marks)
        except Exception as e:
            # a failed dispatch (unsupported scheme in the batch, device
            # unavailable) must answer every waiting requester, not
            # strand them and crash the pump tick
            for p in pending:
                p.future.set_result(
                    NotaryError("verification-unavailable", str(e))
                )
            return None
        return {
            "pending": pending,
            "spans": spans,
            "handle": handle,
            "results": results,
            "collector": collector,
            "box": box,
            "stream_ok": stream_ok,
            "t": t,
            "reqs": reqs,
            "poison": poison,
        }

    # -- degraded-mode verify ------------------------------------------------

    @property
    def degraded(self) -> bool:
        """True while the device verify path is distrusted (the last
        flush fell back to the CPU reference and no probe has
        succeeded since)."""
        return self._degraded

    @property
    def degraded_evidence(self) -> dict:
        return dict(self._degraded_last)

    def _cpu_ref(self):
        if self._cpu_reference is None:
            self._cpu_reference = CpuBatchVerifier()
        return self._cpu_reference

    def _enter_degraded(self, error) -> None:
        self._degraded_counter.inc()
        self._degraded_last = {
            "error": f"{type(error).__name__}: {error}",
            "at_micros": self.services.clock.now_micros(),
            "degraded_flushes": self._degraded_counter.count,
        }
        self._degraded = True

    def _exit_degraded(self) -> None:
        if self._degraded:
            self._degraded = False
            self._degraded_last = dict(
                self._degraded_last,
                recovered_at_micros=self.services.clock.now_micros(),
            )

    def _degraded_verify(self, pending, spans, reqs, error):
        """One flush's CPU-reference fallback after the device path
        failed twice: bit-exact semantics, so the degraded flush commits
        EXACTLY the answers the device path would. When even the CPU
        pass raises — the failure is deterministic, a poison
        transaction, not a dead device — bisect by transaction to
        isolate it: the poison indices are returned for quarantine and
        every other transaction still gets real results. Returns
        (results, poison_tx_indices)."""
        self._enter_degraded(error)
        cpu = self._cpu_ref()
        try:
            return list(cpu.verify_batch(reqs)), set()
        except Exception:
            pass
        results: list = [False] * len(reqs)
        poison: set[int] = set()

        def attempt(lo: int, hi: int) -> None:
            o0 = spans[lo][0]
            o1 = spans[hi - 1][0] + spans[hi - 1][1]
            if o1 == o0:
                return   # no signature rows: cannot be the poison
            try:
                sub = cpu.verify_batch(reqs[o0:o1])
            except Exception:
                if hi - lo == 1:
                    poison.add(lo)
                    return
                mid = (lo + hi) // 2
                attempt(lo, mid)
                attempt(mid, hi)
                return
            results[o0:o1] = sub

        # seed with the two halves: the full range just FAILED above
        n = len(pending)
        if n == 1:
            poison.add(0)
        else:
            attempt(0, n // 2)
            attempt(n // 2, n)
        return results, poison

    def _quarantine(self, p: _PendingNotarisation) -> None:
        """Answer a poison transaction with its typed error and record
        it — the rest of its batch commits normally around it."""
        self._quarantined_counter.inc()
        self.quarantined.append(p.stx.id)
        p.future.set_result(
            NotaryError(
                "poison-quarantined",
                f"transaction {p.stx.id} deterministically crashed the "
                f"batch verifier and was quarantined "
                f"({self._degraded_last.get('error', 'no detail')})",
            )
        )

    def _consume_flush(self, ctx, marks) -> None:
        """Phase B of a flush: host-side resolve+contract pass, then
        consume the verify results (streamed or joined), validate,
        commit against the (possibly partitioned) uniqueness provider,
        sign and scatter replies. Runs while OTHER shards' device
        batches are still computing — the sharded plane's wave."""
        pending = ctx["pending"]
        spans = ctx["spans"]
        handle = ctx["handle"]
        results = ctx["results"]
        collector = ctx["collector"]
        box = ctx["box"]
        stream_ok = ctx["stream_ok"]
        t = ctx["t"]
        poison = ctx["poison"]
        contract_errs = deferred_ltx = None
        try:
            # overlap: contract execution (host Python) runs while the
            # device computes the signature batch. ONE batched
            # resolve+verify pass (services.resolve_verify_batch):
            # asset-shaped transactions take the object-less sweep; the
            # SPI seam is honoured only for SYNCHRONOUS verifier
            # services (an async pool resolves via the pump this flush
            # runs ON, so blocking on it here would deadlock)
            tv = self.services.transaction_verifier
            tv_sync = getattr(tv, "synchronous", False)
            contract_errs, deferred_ltx = self.services.resolve_verify_batch(
                [p.stx for p in pending],
                spi=tv if tv_sync else None,
            )
            t = self._mark("resolve_verify", t, marks)
            if stream_ok:
                self._stream_tail(
                    pending, spans, contract_errs, deferred_ltx,
                    handle, tv, tv_sync, t, marks,
                    reqs=ctx["reqs"], poison=poison,
                )
                return
            if collector is not None:
                collector.join()
                if "error" in box:
                    raise box["error"]
                results = box["results"]
                if self._degraded:
                    # async probe success: the handle's results really
                    # came back from the device — NOW it has recovered
                    self._exit_degraded()
            t = self._mark("link_wait", t, marks)
        except Exception as e:
            # the device batch died AFTER dispatch: same degraded seam
            # as the dispatch guard, minus the retry. Host-side resolve
            # failures (contract_errs still unset) are NOT a device
            # fault — re-verifying signatures cannot fix them.
            if self.degraded_fallback and contract_errs is not None:
                try:
                    results, late_poison = self._degraded_verify(
                        pending, spans, ctx["reqs"], e
                    )
                    poison = poison | late_poison
                    t = self._mark("link_wait", t, marks)
                except Exception as e2:   # noqa: BLE001 - answer, not strand
                    for p in pending:
                        p.future.set_result(
                            NotaryError("verification-unavailable", str(e2))
                        )
                    return
            else:
                for p in pending:
                    p.future.set_result(
                        NotaryError("verification-unavailable", str(e))
                    )
                return
        self._batches_counter.inc()
        self._requests_counter.inc(len(pending))
        # phase 2 — per-tx validation in arrival order
        eligible: list[_PendingNotarisation] = []
        for i, (p, (off, n), cerr) in enumerate(
            zip(pending, spans, contract_errs)
        ):
            if i in poison:
                # deterministic verifier crash isolated to THIS tx: a
                # typed quarantine answer; its batchmates commit
                self._quarantine(p)
                continue
            if not self._validate_one(p, results[off : off + n], cerr):
                continue
            if not self._run_deferred(p, deferred_ltx.get(i), tv, tv_sync):
                continue
            eligible.append(p)
        t = self._mark("validate", t, marks)
        if not eligible:
            return
        conflict_error = self._conflict_error
        finalize = self._finalize_sign

        # phase 3 — uniqueness commit. A synchronous provider takes the
        # WHOLE flush through one commit_many; a distributed provider
        # keeps the per-tx future path since each commit resolves on
        # consensus.
        if getattr(self.uniqueness, "batch_synchronous", False):
            try:
                outcomes = self.uniqueness.commit_many(
                    [
                        (list(p.stx.wtx.inputs), p.stx.id, p.requester)
                        for p in eligible
                    ]
                )
            except Exception as e:
                # a failed batch write must answer every waiting
                # requester, not strand them
                for p in eligible:
                    p.future.set_result(
                        NotaryError("commit-unavailable", str(e))
                    )
                return
            committed: dict[int, _PendingNotarisation] = {}
            for i, (p, err) in enumerate(zip(eligible, outcomes)):
                if err is None:
                    committed[i] = p
                elif isinstance(err, UniquenessConflict):
                    p.future.set_result(conflict_error(err))
                else:
                    p.future.set_result(
                        NotaryError("commit-unavailable", str(err))
                    )
            t = self._mark("commit", t, marks)
            finalize(committed)
            self._mark("sign_scatter", t, marks)
            return

        committed_async: dict[int, _PendingNotarisation] = {}
        remaining = [len(eligible)]

        def on_commit(f, i: int, p: _PendingNotarisation) -> None:
            try:
                f.result()
            except UniquenessConflict as e:
                p.future.set_result(conflict_error(e))
            except Exception as e:
                p.future.set_result(NotaryError("commit-unavailable", str(e)))
            else:
                committed_async[i] = p
            remaining[0] -= 1
            if remaining[0] == 0:
                finalize(committed_async)

        for i, p in enumerate(eligible):
            fut = self.uniqueness.commit_async(
                list(p.stx.wtx.inputs), p.stx.id, p.requester,
                trace=(
                    tuple(p.span.context)
                    if p.span and not p.span.ended else None
                ),
            )
            fut.add_done_callback(lambda f, i=i, p=p: on_commit(f, i, p))
        self._mark("sign_scatter", t, marks)

    def _run_deferred(self, p, dltx, tv, tv_sync) -> bool:
        """A transaction whose contract could not run before its
        signatures were known-good runs it now — through the SPI when it
        resolves inline, in-process otherwise. Answers the future and
        returns False on failure."""
        if dltx is None:
            return True
        try:
            if tv_sync:
                tv.verify(dltx).result()
            else:
                dltx.verify()
        except Exception as e:
            p.future.set_result(NotaryError("invalid-transaction", str(e)))
            return False
        return True

    def _conflict_error(self, e: UniquenessConflict) -> NotaryError:
        return NotaryError(
            "conflict",
            str(e),
            conflict={str(r): h for r, h in e.conflict.items()},
        )

    def _finalize_sign(
        self, committed: dict[int, _PendingNotarisation]
    ) -> None:
        # ONE Merkle-batch notary signature over all committed ids,
        # scattered with per-tx inclusion proofs
        if not committed:
            return
        order = sorted(committed)
        try:
            sigs = self.services.key_management.sign_batch(
                [committed[i].stx.id for i in order],
                self.identity.owning_key,
            )
        except Exception as e:
            for i in order:
                committed[i].future.set_result(
                    NotaryError("commit-unavailable", str(e))
                )
            return
        for i, sig in zip(order, sigs):
            committed[i].future.set_result(sig)

    def _stream_tail(
        self, pending, spans, contract_errs, deferred_ltx,
        handle, tv, tv_sync, t, marks, reqs, poison,
    ) -> None:
        """Streaming validate+commit: consume the SPI's per-chunk results
        as each chunk's device compute completes, validating and
        committing chunk k's transactions while the device still runs
        chunk k+1. The pointer over `pending` is monotonic and a
        transaction only passes it when EVERY one of its signature rows
        is resolved, so validation and commit happen in exact arrival
        order — intra-batch first-wins double-spend semantics are
        identical to the join path's one commit_many over the flush."""
        results = handle.skeleton()
        committed: dict[int, _PendingNotarisation] = {}
        state = {"ptr": 0}
        n_pend = len(pending)
        poison = set(poison)
        # counted at dispatch like the join path: a batch that later
        # fails mid-stream was still dispatched
        self._batches_counter.inc()
        self._requests_counter.inc(n_pend)

        def drain() -> bool:
            """Advance over fully-resolved transactions: validate, then
            commit the ready group. False = batch write failed (every
            requester answered)."""
            ready: list[tuple[int, _PendingNotarisation]] = []
            ptr = state["ptr"]
            while ptr < n_pend:
                off, n = spans[ptr]
                row = results[off : off + n]
                if any(r is None for r in row):
                    break
                i, p = ptr, pending[ptr]
                ptr += 1
                if i in poison:
                    self._quarantine(p)   # typed answer, batchmates live
                    continue
                if not self._validate_one(p, row, contract_errs[i]):
                    continue
                if not self._run_deferred(p, deferred_ltx.get(i), tv, tv_sync):
                    continue
                ready.append((i, p))
            state["ptr"] = ptr
            if not ready:
                return True
            try:
                outcomes = self.uniqueness.commit_many(
                    [
                        (list(p.stx.wtx.inputs), p.stx.id, p.requester)
                        for _, p in ready
                    ]
                )
            except Exception as e:   # noqa: BLE001 - answer all
                # failed batch write: answer every unanswered requester
                # (set_result on an answered future is a no-op)
                for p in pending:
                    p.future.set_result(
                        NotaryError("commit-unavailable", str(e))
                    )
                return False
            for (i, p), err in zip(ready, outcomes):
                if err is None:
                    committed[i] = p
                elif isinstance(err, UniquenessConflict):
                    p.future.set_result(self._conflict_error(err))
                else:
                    p.future.set_result(
                        NotaryError("commit-unavailable", str(err))
                    )
            return True

        try:
            for idxs, vals in handle.chunks():
                for j, ok in zip(idxs, vals):
                    results[j] = ok
                if not drain():
                    return
            # a handle with no device chunks: drain once more
            if state["ptr"] < n_pend and not drain():
                return
            if self._degraded:
                # streamed probe success: every chunk consumed from
                # the device — the degraded path has recovered
                self._exit_degraded()
        except Exception as e:   # noqa: BLE001 - device/link failure
            recovered = False
            if self.degraded_fallback:
                # mid-stream device failure: transactions already
                # committed keep their answers (the monotonic pointer
                # never revisits them); the CPU reference fills every
                # UNRESOLVED row bit-exact and the drain completes the
                # flush in the same arrival order
                try:
                    fb, late_poison = self._degraded_verify(
                        pending, spans, reqs, e
                    )
                    poison.update(late_poison)
                    for j, v in enumerate(results):
                        if v is None:
                            results[j] = fb[j]
                    recovered = drain()
                except Exception:   # noqa: BLE001 - fall through to answer
                    recovered = False
            if not recovered:
                for p in pending:
                    p.future.set_result(
                        NotaryError("verification-unavailable", str(e))
                    )
                return
        t = self._mark("stream_commit", t, marks)
        self._finalize_sign(committed)
        self._mark("sign_scatter", t, marks)

    def _validate_one(
        self,
        p: _PendingNotarisation,
        sig_results: list[bool],
        contract_err: Optional[Exception] = None,
    ) -> bool:
        """Pre-commit checks; answers the future and returns False on
        failure, True when the tx may proceed to uniqueness commit."""
        stx = p.stx
        try:
            # signature errors take precedence over the (overlapped)
            # contract result, matching the reference's check order
            # (SignedTransaction.kt:143-149)
            stx.raise_on_invalid(sig_results)
            except_keys = self.__dict__.get("_except_keys")
            if except_keys is None:
                except_keys = frozenset((self.identity.owning_key,))
                self._except_keys = except_keys
            stx.verify_required_signatures(except_keys)
            if contract_err is not None:
                raise contract_err
        except Exception as e:
            p.future.set_result(NotaryError("invalid-transaction", str(e)))
            return False
        if not self.time_window_checker.is_valid(stx.wtx.time_window):
            p.future.set_result(
                NotaryError(
                    "time-window-invalid",
                    f"window {stx.wtx.time_window} outside notary clock "
                    "tolerance",
                )
            )
            return False
        return True


class ValidatingNotaryService(NotaryService):
    """Validating: fully resolves and verifies the transaction —
    signatures through the batch SPI, then contracts — before
    committing (ValidatingNotaryFlow.kt:17-46)."""

    validating = True

    def process(
        self,
        stx: SignedTransaction,
        requester: Party,
        deadline: Optional[int] = None,
        trace=None,
    ):
        del deadline   # see SimpleNotaryService.process
        if stx.wtx.notary != self.identity:
            return NotaryError(
                "wrong-notary", f"tx names notary {stx.wtx.notary}, I am "
                f"{self.identity}"
            )
        try:
            stx.verify(
                self.services,
                check_sufficient_signatures=False,   # ours is still missing
                verifier=self.services.batch_verifier,
            )
        except Exception as e:
            return NotaryError("invalid-transaction", str(e))
        return (
            yield from self.commit_and_sign(
                stx.id, list(stx.wtx.inputs), stx.wtx.time_window, requester,
                trace=trace,
            )
        )


def run_process(gens) -> list:
    """Drive notary `process` generators without the flow state machine:
    start each (an immediate answer, e.g. `wrong-notary`, comes back at
    once), leave the rest suspended on their futures, and return a list
    whose entries are either an answer or a pending generator step.
    Call `finish_process` on it after the flush."""
    out = []
    for gen in gens:
        try:
            step = next(gen)
        except StopIteration as stop:
            out.append(stop.value)
            continue
        if not isinstance(step, _WaitFuture):
            raise TypeError(f"notary process yielded {step!r}")
        out.append((gen, step.future))
    return out


def finish_process(started: list) -> list:
    """Resume every generator `run_process` left suspended with its
    future's result (or its exception, thrown in, as the flow state
    machine does); returns one answer per request (a
    TransactionSignature or a NotaryError)."""
    answers = []
    for entry in started:
        if isinstance(entry, tuple):
            gen, fut = entry
            try:
                try:
                    value = fut.result()
                except Exception as e:   # noqa: BLE001 - handed to the flow
                    gen.throw(e)
                else:
                    gen.send(value)
            except StopIteration as stop:
                answers.append(stop.value)
                continue
            raise RuntimeError("notary process suspended twice")
        answers.append(entry)
    return answers
