"""StateMachineManager: drives flows, checkpoints them, routes sessions.

Port of corda_tpu/flows/statemachine.py. Class tags in SessionInit
frames and checkpoint records are the reference's module paths
(api.class_tag), so the port's frames and checkpoints equal the
reference's bytes, and a restore resolves them in this package
(api.class_from_tag) without importing corda_tpu.

Reference: node/.../statemachine/StateMachineManager.kt:74 (start :166,
restore :226, onSessionMessage :276, resumeFiber :508) and
FlowStateMachineImpl.kt:35 (suspend/parkAndSerialize :384-392).

Durability design (TPU-first divergence): the reference pickles live
Quasar fiber stacks into checkpoints. Python has no fiber serializer,
so durability is *event-sourced*: a checkpoint is
    (flow class, constructor-state snapshot, journal, emission count,
     session snapshot)
where the journal records every nondeterministic value the generator
absorbed (received payloads, session errors, `record()` results). On
restore the generator re-runs from the top; journaled steps replay with
all session machinery and emissions suppressed, then execution
continues live from the checkpointed emission counter. Sends in the
post-checkpoint tail re-emit with *deterministic* message ids —
sha256(flow_id, seq) — so receivers dedupe anything the pre-crash
process already delivered; this gives the same effectively-once
delivery the reference gets from transactional checkpoint+send
(NodeMessagingClient send dedupe, SURVEY §5).

Session protocol: SessionInit/Data/End/Reject, matching the reference's
SessionMessage.kt:15-36 minus Confirm — unnecessary here because the
session id is initiator-chosen and shared by both directions, so the
initiator never waits to learn a peer id. Sessions are keyed by
(protocol tag, counterparty): an @initiating_flow sub-flow opens its
own session under its own tag; non-initiating sub-flows (the Receive/
Send*TransactionFlow family) inherit the state machine's root session
with that party, mirroring the reference's session sharing
(FlowLogic.kt:211 subFlow semantics).
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..core import serialization as ser
from ..core.identity import Party
from ..node import messaging as msglib
from ..utils import tracing as tracelib
from .api import (
    FlowException,
    FlowLogic,
    FlowSessionException,
    FlowTimeoutException,
    _Receive,
    _Record,
    _Send,
    _SendAndReceive,
    _TrackStep,
    _WaitFuture,
    _WaitLedgerCommit,
    as_generator,
    class_from_tag,
    class_tag,
    initiating_tag_of,
    registered_initiated_flows,
)

# -- wire messages -----------------------------------------------------------


@ser.serializable
@dataclass(frozen=True)
class SessionInit:
    session_id: bytes
    flow_tag: str
    initiator: Party
    has_payload: bool
    payload: Any


@ser.serializable
@dataclass(frozen=True)
class SessionData:
    session_id: bytes
    payload: Any


@ser.serializable
@dataclass(frozen=True)
class SessionEnd:
    session_id: bytes
    error: Optional[str]


@ser.serializable
@dataclass(frozen=True)
class SessionReject:
    session_id: bytes
    error: str


# -- machine state -----------------------------------------------------------


@dataclass
class SessionState:
    id: bytes
    party: Party
    tag: str                         # protocol tag announced in Init
    init_sent: bool = False          # initiator side: Init emitted
    initiated_here: bool = False     # True if created from inbound Init
    buffer: list = field(default_factory=list)
    ended: Optional[str] = None      # "" = clean end, else error text
    rejected: Optional[str] = None

    @property
    def key(self) -> tuple[str, str]:
        return (self.tag, self.party.name)

    def closed_error(self) -> Optional[str]:
        """Error text if the session can no longer carry traffic
        (buffered data is checked by the caller first)."""
        if self.rejected is not None:
            return f"session rejected by {self.party}: {self.rejected}"
        if self.ended:
            return f"counter-flow of {self.party} errored: {self.ended}"
        if self.ended == "":
            return f"session with {self.party} already ended"
        return None


class FlowStateMachine:
    """One running flow: generator + journal + sessions."""

    def __init__(
        self, flow_id: bytes, logic: FlowLogic, snapshot: dict, root_tag: str
    ):
        self.id = flow_id
        self.logic = logic
        self.snapshot = snapshot            # constructor-state for restore
        self.root_tag = root_tag            # default session protocol tag
        # optional trace context (utils/tracing wire header): adopted
        # from the initiating session message, or set by the flow
        # itself (NotaryFlow opens a client root span). Every emission
        # carries it, so a flow conversation — and the consensus round
        # it triggers — assembles as ONE cross-node trace.
        # Observability only: never checkpointed, never consensus input
        # (a restored flow simply continues untraced).
        self.trace: Optional[tuple] = None
        self.gen = as_generator(logic.call())
        self.journal: list = []
        self.replay_pos = 0
        self.sessions: dict[tuple[str, str], SessionState] = {}
        self.send_seq = 0
        self.waiting: Optional[tuple] = None  # ("recv", sid) | ("commit", txid)
        self.done = False
        self.result: Any = None
        self.exception: Optional[BaseException] = None
        self.resume_value: Any = None
        self.throw_exc: Optional[BaseException] = None

    @property
    def replaying(self) -> bool:
        return self.replay_pos < len(self.journal)

    def next_msg_id(self) -> int:
        h = hashlib.sha256(
            self.id + self.send_seq.to_bytes(8, "big")
        ).digest()
        self.send_seq += 1
        return (1 << 63) | (int.from_bytes(h[:8], "big") >> 1)

    # -- handle surface (what callers hold) ---------------------------------

    def result_or_throw(self) -> Any:
        if not self.done:
            raise RuntimeError(f"flow {self.id.hex()[:8]} still running")
        if self.exception is not None:
            raise self.exception
        return self.result


class CheckpointCorruption(Exception):
    pass


# Bump whenever the checkpoint record or journal-entry layout changes
# (e.g. v2: flow-scoped lock ids removed the journaled lock-id record).
# Restore refuses other versions instead of replaying shifted entries.
CHECKPOINT_FORMAT = 2


class StateMachineManager:
    """Runs flows over a MessagingService against a ServiceHub.

    Synchronous core: message handlers resume flows inline (the fabric
    pump or the asyncio node loop provides the outer concurrency), the
    moral equivalent of the reference's single serverThread
    AffinityExecutor (node/.../utilities/AffinityExecutor.kt).
    """

    def __init__(self, services, messaging: msglib.MessagingService, rng=None):
        import random as _random

        self.services = services
        self.messaging = messaging
        self.rng = rng or _random.Random()
        self.flows: dict[bytes, FlowStateMachine] = {}
        self.sessions_by_id: dict[bytes, tuple[FlowStateMachine, SessionState]] = {}
        self.tx_waiters: dict[Any, list[FlowStateMachine]] = {}
        self.initiated_factories: dict[str, Callable] = {}
        self.changes: list[Callable[[FlowStateMachine, str], None]] = []
        # lifecycle observers: cb(kind, fsm) with kind "added"/"removed"
        # (the CordaRPCOps.stateMachinesFeed source — RPCServer hangs
        # flow-result streaming off "removed")
        self.lifecycle: list[Callable[[str, FlowStateMachine], None]] = []
        self.stopped = False
        messaging.add_handler(msglib.TOPIC_SESSION, self._on_session_message)
        tx_store = getattr(services, "validated_transactions", None)
        if tx_store is not None:
            tx_store.observers.append(self._notify_tx_recorded)
        # flow-end soft-lock release rides the lifecycle seam (the
        # VaultSoftLockManager role): a FAILED spend must not leave its
        # coins unspendable. Registered here so every assembly gets it;
        # replaceable/removable like any other lifecycle observer.
        vault = getattr(services, "vault", None)
        if vault is not None:
            def _release_locks(kind: str, fsm: FlowStateMachine) -> None:
                if kind == "removed":
                    vault.release_soft_locks(fsm.id)

            self.lifecycle.append(_release_locks)

    def stop(self) -> None:
        """Detach from the fabric and services. A node restart MUST stop
        the old manager before building a new one over the same
        services, or both will process every session message."""
        if self.stopped:
            return
        self.stopped = True
        remove = getattr(self.messaging, "remove_handler", None)
        if remove is not None:
            remove(msglib.TOPIC_SESSION, self._on_session_message)
        tx_store = getattr(self.services, "validated_transactions", None)
        if tx_store is not None and self._notify_tx_recorded in tx_store.observers:
            tx_store.observers.remove(self._notify_tx_recorded)

    # -- registration -------------------------------------------------------

    def register_initiated_flow(self, initiating_cls, responder_factory) -> None:
        self.initiated_factories[initiating_tag_of(initiating_cls)] = (
            responder_factory
        )

    def _responder_factory(self, tag: str):
        f = self.initiated_factories.get(tag)
        if f is None:
            f = registered_initiated_flows().get(tag)
        return f

    # -- starting & restoring ----------------------------------------------

    def start_flow(self, logic: FlowLogic) -> FlowStateMachine:
        flow_id = self.rng.getrandbits(128).to_bytes(16, "big")
        fsm = FlowStateMachine(
            flow_id, logic, _state_snapshot(logic), _root_tag_of(logic)
        )
        self._bind(fsm)
        self.flows[flow_id] = fsm
        self._checkpoint(fsm)      # initial checkpoint (reference: smm.add)
        self._notify_lifecycle("added", fsm)
        self._run(fsm)
        return fsm

    def _notify_lifecycle(self, kind: str, fsm: FlowStateMachine) -> None:
        for cb in list(self.lifecycle):
            try:
                cb(kind, fsm)
            except Exception:
                logging.getLogger("corda_tpu_torch.smm").exception(
                    "lifecycle observer raised; continuing"
                )

    def restore_checkpoints(self) -> int:
        """Re-animate every checkpointed flow (StateMachineManager.kt:
        226-252). Returns the number restored."""
        restored = []
        for flow_id, record in self.services.checkpoint_storage.all():
            fsm = self._restore_one(flow_id, ser.decode(record))
            self.flows[flow_id] = fsm
            restored.append(fsm)
            self._notify_lifecycle("added", fsm)
        for fsm in restored:
            if not fsm.done:
                self._run(fsm)
        return len(restored)

    def _restore_one(self, flow_id: bytes, rec: Any) -> FlowStateMachine:
        if not rec or rec[0] != CHECKPOINT_FORMAT:
            # a checkpoint from a different journal layout must fail
            # loudly at restore, not wedge mid-replay with shifted
            # journal entries masquerading as each other
            raise CheckpointCorruption(
                f"checkpoint format {rec[0] if rec else '?'} != "
                f"{CHECKPOINT_FORMAT}; cannot resume flows written by a "
                f"different framework version"
            )
        _version, tag, root_tag, snapshot, journal, send_seq, sess_snap = rec
        logic = _reconstruct_logic(tag, snapshot)
        fsm = FlowStateMachine(flow_id, logic, snapshot, root_tag)
        fsm.journal = journal
        fsm.send_seq = send_seq
        for s in sess_snap:
            sess = SessionState(
                id=s["id"],
                party=s["party"],
                tag=s["tag"],
                init_sent=s["init_sent"],
                initiated_here=s["initiated_here"],
                buffer=list(s["buffer"]),
                ended=s["ended"],
                rejected=s["rejected"],
            )
            fsm.sessions[sess.key] = sess
            self.sessions_by_id[sess.id] = (fsm, sess)
        self._bind(fsm)
        return fsm

    def _bind(self, fsm: FlowStateMachine) -> None:
        fsm.logic._machine = fsm
        fsm.logic.services = self.services

    # -- checkpointing ------------------------------------------------------

    def _checkpoint(self, fsm: FlowStateMachine) -> None:
        sess_snap = [
            {
                "id": s.id,
                "party": s.party,
                "tag": s.tag,
                "init_sent": s.init_sent,
                "initiated_here": s.initiated_here,
                "buffer": list(s.buffer),
                "ended": s.ended,
                "rejected": s.rejected,
            }
            for s in fsm.sessions.values()
        ]
        rec = ser.encode([
            CHECKPOINT_FORMAT,
            class_tag(type(fsm.logic)),
            fsm.root_tag,
            fsm.snapshot,
            fsm.journal,
            fsm.send_seq,
            sess_snap,
        ])
        self.services.checkpoint_storage.add(fsm.id, rec)

    # -- the drive loop -----------------------------------------------------

    def _run(self, fsm: FlowStateMachine) -> None:
        while True:
            try:
                if fsm.throw_exc is not None:
                    exc, fsm.throw_exc = fsm.throw_exc, None
                    req = fsm.gen.throw(exc)
                else:
                    val, fsm.resume_value = fsm.resume_value, None
                    req = fsm.gen.send(val)
            except StopIteration as e:
                self._finish(fsm, e.value, None)
                return
            except BaseException as e:  # flow failed
                self._finish(fsm, None, e)
                return

            if isinstance(req, _Send):
                err = self._handle_send(fsm, req.party, req.payload, req.logic)
                if err is not None:
                    fsm.throw_exc = FlowSessionException(err)
                continue
            if isinstance(req, (_Receive, _SendAndReceive)):
                if isinstance(req, _SendAndReceive):
                    err = self._handle_send(
                        fsm, req.party, req.payload, req.logic
                    )
                    if err is not None:
                        fsm.throw_exc = FlowSessionException(err)
                        continue
                if not self._try_receive(
                    fsm, req.party, req.logic, req.timeout_micros
                ):
                    return  # suspended (checkpointed inside)
                continue
            if isinstance(req, _Record):
                if fsm.replaying:
                    kind, value = self._journal_next(
                        fsm, ("rec", "rec_err", "rec_err_opaque")
                    )
                    if kind == "rec_err":
                        fsm.throw_exc = value   # CTS round-tripped exception
                        continue
                    if kind == "rec_err_opaque":
                        tag, message = value
                        fsm.throw_exc = FlowException(f"{tag}: {message}")
                        continue
                else:
                    try:
                        value = req.fn()
                    except Exception as e:
                        # Journal the failure so a replay deterministically
                        # re-raises instead of re-running the side effect.
                        # Exception types registered with the canonical
                        # codec replay faithfully (attributes intact);
                        # anything else replays as an opaque FlowException.
                        try:
                            ser.encode(e)
                            _journal_add(fsm, ["rec_err", e])
                        except ser.SerializationError:
                            _journal_add(
                                fsm,
                                [
                                    "rec_err_opaque",
                                    [class_tag(type(e)), str(e)],
                                ],
                            )
                        fsm.throw_exc = e
                        continue
                    _journal_add(fsm, ["rec", value])
                fsm.resume_value = value
                continue
            if isinstance(req, _WaitLedgerCommit):
                if not self._try_commit_wait(fsm, req.tx_id):
                    return
                continue
            if isinstance(req, _WaitFuture):
                if not self._try_future_wait(fsm, req.future):
                    return   # suspended until the future resolves
                continue
            if isinstance(req, _TrackStep):
                tracker = fsm.logic.progress_tracker
                if tracker is not None:
                    tracker.set_step(req.label)
                for cb in self.changes:
                    cb(fsm, req.label)
                continue
            self._finish(
                fsm, None, FlowException(
                    f"flow yielded {req!r}; use the FlowLogic helpers "
                    f"with `yield from`"
                )
            )
            return

    # -- request handlers ---------------------------------------------------

    def _session_for(
        self, fsm: FlowStateMachine, party: Party, logic: FlowLogic,
        for_send: bool,
    ) -> SessionState:
        tag = getattr(type(logic), "_initiating_tag", None) or fsm.root_tag
        key = (tag, party.name)
        sess = fsm.sessions.get(key)
        if sess is not None and for_send and sess.ended == "":
            # sequential sub-flow reuse (e.g. notarising a second tx):
            # the old counter-flow ended cleanly; open a fresh session
            self.sessions_by_id.pop(sess.id, None)
            sess = None
        if sess is None:
            sid = self.rng.getrandbits(128).to_bytes(16, "big")
            sess = SessionState(id=sid, party=party, tag=tag)
            fsm.sessions[key] = sess
            self.sessions_by_id[sid] = (fsm, sess)
        return sess

    def _open_if_needed(self, fsm, sess: SessionState, has_payload, payload):
        """Emit SessionInit on first use; returns True if an Init was
        emitted (carrying the payload when has_payload)."""
        if sess.init_sent or sess.initiated_here:
            return False
        sess.init_sent = True
        self._emit(
            fsm,
            SessionInit(
                sess.id, sess.tag, self._our_party(), has_payload, payload
            ),
            sess.party,
        )
        return True

    def _handle_send(self, fsm, party, payload, logic) -> Optional[str]:
        """Send payload on the flow's session with party; returns error
        text if the session is no longer usable. Every live emission is
        journaled as a ["sent"] marker so replay suppresses it without
        burning a message-id sequence slot."""
        if fsm.replaying:
            self._journal_next(fsm, "sent")   # already emitted pre-crash
            return None
        sess = self._session_for(fsm, party, logic, for_send=True)
        err = sess.closed_error()
        if err is not None:
            return err
        if not self._open_if_needed(fsm, sess, True, payload):
            self._emit(fsm, SessionData(sess.id, payload), party)
        _journal_add(fsm, ["sent"])
        return None

    def _try_receive(self, fsm, party: Party, logic, timeout_micros=None) -> bool:
        """Returns True if the flow got a value (or error) and should
        continue; False if it suspended."""
        if fsm.replaying:
            # a bare first receive may have emitted an Init pre-crash;
            # any "sent" at the cursor here can only be that Init (a
            # suspended receive is always the journal's last word)
            if fsm.journal[fsm.replay_pos][0] == "sent":
                fsm.replay_pos += 1
        if fsm.replaying:
            kind, value = self._journal_next(
                fsm, ("recv", "err", "recv_timeout")
            )
            if kind == "recv":
                fsm.resume_value = value
            elif kind == "recv_timeout":
                fsm.throw_exc = FlowTimeoutException("receive timed out")
            else:
                fsm.throw_exc = FlowSessionException(value)
            return True
        # live (possibly falling through right after a replayed Init)
        sess = self._session_for(fsm, party, logic, for_send=False)
        if self._open_if_needed(fsm, sess, False, None):
            _journal_add(fsm, ["sent"])
        return self._try_receive_on(fsm, sess, timeout_micros)

    def _try_receive_on(self, fsm, sess: SessionState, timeout_micros=None) -> bool:
        """Receive on a known session (no tag resolution — also the
        resume path when a waited-for message arrives)."""
        if sess.buffer:
            value = sess.buffer.pop(0)
            _journal_add(fsm, ["recv", value])
            fsm.resume_value = value
            return True
        err = sess.closed_error()
        if err is not None:
            _journal_add(fsm, ["err", err])
            fsm.throw_exc = FlowSessionException(err)
            return True
        deadline = (
            None
            if timeout_micros is None
            else self.services.clock.now_micros() + timeout_micros
        )
        fsm.waiting = ("recv", sess.id, deadline)
        self._checkpoint(fsm)
        return False

    def tick(self) -> int:
        """Expire timed receives (driven from the node pump loop /
        MockNetwork.run — the timer thread role of the reference's
        fiber scheduler). Returns number of flows resumed."""
        now = self.services.clock.now_micros()
        fired = 0
        for fsm in list(self.flows.values()):
            w = fsm.waiting
            if (
                not fsm.done
                and w is not None
                and w[0] == "recv"
                and len(w) > 2
                and w[2] is not None
                and now >= w[2]
            ):
                fsm.waiting = None
                _journal_add(fsm, ["recv_timeout"])
                fsm.throw_exc = FlowTimeoutException("receive timed out")
                fired += 1
                self._run(fsm)
        return fired

    def _try_commit_wait(self, fsm, tx_id) -> bool:
        store = self.services.validated_transactions
        if fsm.replaying:
            self._journal_next(fsm, "commit")
            fsm.resume_value = store.get(tx_id)
            return True
        stx = store.get(tx_id)
        if stx is not None:
            _journal_add(fsm, ["commit"])
            fsm.resume_value = stx
            return True
        fsm.waiting = ("commit", tx_id)
        self.tx_waiters.setdefault(tx_id, []).append(fsm)
        self._checkpoint(fsm)
        return False

    def _try_future_wait(self, fsm, future) -> bool:
        """_WaitFuture: journal the outcome like _Record — a replayed
        flow re-submits the (idempotent) operation only if the journal
        has no recorded outcome yet."""
        if fsm.replaying:
            kind, value = self._journal_next(
                fsm, ("fut", "fut_err", "fut_err_opaque")
            )
            if kind == "fut":
                fsm.resume_value = value
            elif kind == "fut_err":
                fsm.throw_exc = value
            else:
                tag, message = value
                fsm.throw_exc = FlowException(f"{tag}: {message}")
            return True
        if future.done:
            self._settle_future(fsm, future)
            return True
        fsm.waiting = ("future",)
        self._checkpoint(fsm)

        def on_done(fut):
            if fsm.done or self.stopped:
                return
            fsm.waiting = None
            self._settle_future(fsm, fut)
            self._run(fsm)

        future.add_done_callback(on_done)
        return False

    def _settle_future(self, fsm, future) -> None:
        try:
            value = future.result()
        except BaseException as e:
            try:
                ser.encode(e)
                _journal_add(fsm, ["fut_err", e])
            except ser.SerializationError:
                _journal_add(
                    fsm, ["fut_err_opaque", [class_tag(type(e)), str(e)]]
                )
            fsm.throw_exc = e
            return
        _journal_add(fsm, ["fut", value])
        fsm.resume_value = value

    def _journal_next(self, fsm, expect) -> tuple:
        entry = fsm.journal[fsm.replay_pos]
        fsm.replay_pos += 1
        kinds = (expect,) if isinstance(expect, str) else expect
        if entry[0] not in kinds:
            raise CheckpointCorruption(
                f"journal expected {kinds}, found {entry[0]!r}"
            )
        return entry[0], entry[1] if len(entry) > 1 else None

    # -- completion ---------------------------------------------------------

    def _finish(self, fsm, result, exc: Optional[BaseException]) -> None:
        fsm.done = True
        fsm.result = result
        fsm.exception = exc
        error_text = None
        if exc is not None:
            error_text = (
                str(exc) if isinstance(exc, FlowException)
                else f"counter-flow failed: {type(exc).__name__}"
            )
        for sess in fsm.sessions.values():
            if (sess.init_sent or sess.initiated_here) and sess.ended is None \
                    and sess.rejected is None:
                self._emit(fsm, SessionEnd(sess.id, error_text), sess.party)
            self.sessions_by_id.pop(sess.id, None)
        self.services.checkpoint_storage.remove(fsm.id)
        self._notify_lifecycle("removed", fsm)

    # -- inbound ------------------------------------------------------------

    def _on_session_message(self, msg: msglib.Message) -> None:
        if self.stopped:
            return
        decoded = ser.decode(msg.payload)
        if isinstance(decoded, SessionInit):
            self._on_init(decoded, msg.trace)
            return
        entry = self.sessions_by_id.get(decoded.session_id)
        if entry is None:
            return  # flow finished or duplicate — drop
        fsm, sess = entry
        if msg.trace is not None and fsm.trace is None:
            # late adoption: a counter-flow that started untraced joins
            # the peer's trace on its first traced frame
            fsm.trace = tuple(msg.trace)
        if isinstance(decoded, SessionData):
            sess.buffer.append(decoded.payload)
        elif isinstance(decoded, SessionEnd):
            sess.ended = decoded.error if decoded.error is not None else ""
        elif isinstance(decoded, SessionReject):
            sess.rejected = decoded.error
        else:
            return
        if fsm.waiting is not None and fsm.waiting[0] == "recv" \
                and fsm.waiting[1] == sess.id:
            fsm.waiting = None
            if self._try_receive_on(fsm, sess):
                self._run(fsm)

    def _on_init(self, init: SessionInit, trace=None) -> None:
        if init.session_id in self.sessions_by_id:
            return  # duplicate Init (redelivery) — drop
        factory = self._responder_factory(init.flow_tag)
        if factory is None:
            self.messaging.send(
                msglib.TOPIC_SESSION,
                ser.encode(SessionReject(
                    init.session_id, f"no responder for {init.flow_tag}"
                )),
                self._address_of(init.initiator),
            )
            return
        logic = factory(init.initiator)
        flow_id = self.rng.getrandbits(128).to_bytes(16, "big")
        fsm = FlowStateMachine(
            flow_id, logic, _state_snapshot(logic), init.flow_tag
        )
        if trace is not None:
            fsm.trace = tuple(trace)   # responder joins the initiator's trace
        sess = SessionState(
            id=init.session_id,
            party=init.initiator,
            tag=init.flow_tag,
            initiated_here=True,
        )
        if init.has_payload:
            sess.buffer.append(init.payload)
        fsm.sessions[sess.key] = sess
        self.sessions_by_id[sess.id] = (fsm, sess)
        self._bind(fsm)
        self.flows[flow_id] = fsm
        self._checkpoint(fsm)
        self._notify_lifecycle("added", fsm)
        self._run(fsm)

    def _notify_tx_recorded(self, stx) -> None:
        waiters = self.tx_waiters.pop(stx.id, [])
        for fsm in waiters:
            if fsm.done:
                continue
            fsm.waiting = None
            _journal_add(fsm, ["commit"])
            fsm.resume_value = stx
            self._run(fsm)

    # -- plumbing -----------------------------------------------------------

    def _emit(self, fsm: FlowStateMachine, message, party: Party) -> None:
        self.messaging.send(
            msglib.TOPIC_SESSION,
            ser.encode(message),
            self._address_of(party),
            unique_id=fsm.next_msg_id(),
            trace=tracelib.wire_trace(fsm.trace),   # None when untraced
        )

    def _address_of(self, party: Party) -> str:
        cache = getattr(self.services, "network_map_cache", None)
        if cache is not None:
            addr = cache.address_of(party)
            if addr is not None:
                return addr
        return party.name

    def _our_party(self) -> Party:
        return self.services.my_info.legal_identity


# -- helpers -----------------------------------------------------------------


def _journal_add(fsm: FlowStateMachine, entry: list) -> None:
    """Append a live journal entry, keeping the replay cursor at the
    end (replaying is only true while the cursor lags the journal —
    i.e. after a restore)."""
    fsm.journal.append(entry)
    fsm.replay_pos = len(fsm.journal)


def _root_tag_of(logic: FlowLogic) -> str:
    return getattr(type(logic), "_initiating_tag", None) or class_tag(
        type(logic)
    )


def _state_snapshot(logic: FlowLogic) -> dict:
    out = {}
    for k, v in vars(logic).items():
        if k.startswith("_") or k in ("services", "progress_tracker"):
            continue
        out[k] = v
    return out


def _class_from_tag(tag: str):
    try:
        return class_from_tag(tag)
    except ImportError:
        raise CheckpointCorruption(f"cannot import flow class {tag!r}")


def _reconstruct_logic(tag: str, snapshot: dict) -> FlowLogic:
    """FlowLogicRef equivalent (core/.../flows/FlowLogicRef.kt): rebuild
    the flow object from its class tag + state snapshot, bypassing the
    constructor (checkpoint restore: the snapshot IS the full state)."""
    cls = _class_from_tag(tag)
    logic = cls.__new__(cls)
    for k, v in snapshot.items():
        setattr(logic, k, v)
    return logic


def construct_logic(tag: str, kwargs: dict) -> FlowLogic:
    """Build a flow through its CONSTRUCTOR (RPC/shell/web starts:
    partial kwargs rely on parameter defaults — snapshot-style
    reconstruction would leave them unset)."""
    cls = _class_from_tag(tag)
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise FlowException(f"cannot construct {tag}: {e}")
