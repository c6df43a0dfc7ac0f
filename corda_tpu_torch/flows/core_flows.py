"""The core flow set: notarise, finalise, resolve, collect signatures.

Port of corda_tpu/flows/core_flows.py, with the reference's wire
classes, class names and call structure: every verify below is one call
of the node's batch verifier (CudaBatchVerifier on the card by
default): FinalityFlow's pre-notary check, one per transaction a
backchain resolution fetches, and the recipient's check. NotaryServiceFlow's
QoS branch stays behind `getattr(service, "qos", None)`, as in the
reference; no notary of this package has a QoS plane, so it is inert.

Reference (SURVEY §2.4, core/.../flows/): NotaryFlow (NotaryFlow.kt:
34-130), FinalityFlow (FinalityFlow.kt), BroadcastTransactionFlow,
CollectSignaturesFlow + SignTransactionFlow (CollectSignaturesFlow.kt),
ResolveTransactionsFlow (core/.../internal/ResolveTransactionsFlow.kt:
167) and FetchDataFlow (core/.../internal/FetchDataFlow.kt:179) with
the node's standing data-vending handlers.

Signature verification throughout drains into the node's
BatchSignatureVerifier rather than per-signature host calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..core import serialization as ser
from ..core.contracts import StateRef, TimeWindow
from ..core.identity import AnonymousParty, Party
from ..core.transactions import (
    FilteredTransaction,
    SignedTransaction,
)
from ..crypto import composite as comp
from ..crypto import schemes
from ..crypto.hashes import SecureHash
from ..crypto.tx_signature import TransactionSignature
from ..node.notary import NotaryError, NotaryException
from ..utils import tracing
from .api import (
    FlowException,
    FlowLogic,
    FlowSessionException,
    FlowTimeoutException,
    initiated_by,
    initiating_flow,
)

MAX_RESOLUTION_TXS = 5_000   # backchain size guard (reference limit)


# ---------------------------------------------------------------------------
# data vending: fetch transactions / attachments by hash


@ser.serializable
@dataclass(frozen=True)
class FetchTxRequest:
    tx_ids: tuple[SecureHash, ...]


@ser.serializable
@dataclass(frozen=True)
class FetchTxResponse:
    txs: tuple[SignedTransaction, ...]
    missing: tuple[SecureHash, ...]


@ser.serializable
@dataclass(frozen=True)
class FetchAttRequest:
    ids: tuple[SecureHash, ...]


@ser.serializable
@dataclass(frozen=True)
class FetchAttResponse:
    blobs: tuple[bytes, ...]
    missing: tuple[SecureHash, ...]


@initiating_flow
class FetchTransactionsFlow(FlowLogic):
    """Ask a peer for transactions by id (FetchDataFlow.kt:179)."""

    def __init__(self, tx_ids, other_party: Party):
        self.tx_ids = tuple(tx_ids)
        self.other_party = other_party

    def call(self):
        if not self.tx_ids:
            return []
        resp = yield from self.send_and_receive(
            self.other_party, FetchTxRequest(self.tx_ids), FetchTxResponse
        )
        if resp.missing:
            raise FlowException(
                f"{self.other_party} is missing {len(resp.missing)} "
                f"requested transaction(s)"
            )
        by_id = {stx.id: stx for stx in resp.txs}
        if set(by_id) != set(self.tx_ids):
            raise FlowException(
                f"{self.other_party} answered with wrong transactions"
            )
        return [by_id[h] for h in self.tx_ids]


@initiated_by(FetchTransactionsFlow)
class FetchTransactionsHandler(FlowLogic):
    """Standing vending handler every node installs (the reference's
    DataVending service; installCoreFlows AbstractNode.kt:199-210).
    Serves any number of requests on one session — a resolve walks the
    backchain in rounds over the same session — until the requester's
    SessionEnd."""

    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        while True:
            try:
                req = yield from self.receive(
                    self.other_party, FetchTxRequest
                )
            except FlowSessionException:
                return None     # requester finished
            txs, missing = [], []
            for h in req.tx_ids:
                stx = self.services.validated_transactions.get(h)
                if stx is None:
                    missing.append(h)
                else:
                    txs.append(stx)
            yield from self.send(
                self.other_party, FetchTxResponse(tuple(txs), tuple(missing))
            )


@initiating_flow
class FetchAttachmentsFlow(FlowLogic):
    def __init__(self, ids, other_party: Party):
        self.ids = tuple(ids)
        self.other_party = other_party

    def call(self):
        if not self.ids:
            return []
        resp = yield from self.send_and_receive(
            self.other_party, FetchAttRequest(self.ids), FetchAttResponse
        )
        if resp.missing:
            raise FlowException(
                f"{self.other_party} missing {len(resp.missing)} attachment(s)"
            )
        out = []
        for blob, want in zip(resp.blobs, self.ids):
            got = self.services.attachments.import_attachment(blob)
            if got != want:
                raise FlowException("attachment content/hash mismatch")
            out.append(got)
        return out


@initiated_by(FetchAttachmentsFlow)
class FetchAttachmentsHandler(FlowLogic):
    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        while True:
            try:
                req = yield from self.receive(
                    self.other_party, FetchAttRequest
                )
            except FlowSessionException:
                return None
            blobs, missing = [], []
            for h in req.ids:
                att = self.services.attachments.open_attachment(h)
                if att is None:
                    missing.append(h)
                else:
                    blobs.append(att.data)
            yield from self.send(
                self.other_party, FetchAttResponse(tuple(blobs), tuple(missing))
            )


class ResolveTransactionsFlow(FlowLogic):
    """Walk the dependency backchain of `tx_ids`, fetching unknown
    transactions from `other_party`, then verify + record them in
    topological order (ResolveTransactionsFlow.kt:167). Not an
    initiating flow itself — the fetches open their own sessions.

    `head_attachments` are attachment ids of the transaction being
    received (not itself part of the backchain) to fetch alongside."""

    def __init__(self, tx_ids, other_party: Party, head_attachments=()):
        self.tx_ids = tuple(tx_ids)
        self.other_party = other_party
        self.head_attachments = tuple(head_attachments)

    def call(self):
        store = self.services.validated_transactions
        fetched: dict[SecureHash, SignedTransaction] = {}
        frontier = [h for h in self.tx_ids if h not in store]
        while frontier:
            if len(fetched) + len(frontier) > MAX_RESOLUTION_TXS:
                raise FlowException(
                    f"backchain exceeds {MAX_RESOLUTION_TXS} transactions"
                )
            batch = yield from self.sub_flow(
                FetchTransactionsFlow(frontier, self.other_party)
            )
            next_frontier: list[SecureHash] = []
            for stx in batch:
                fetched[stx.id] = stx
                for ref in stx.wtx.inputs:
                    h = ref.txhash
                    if h not in store and h not in fetched \
                            and h not in next_frontier:
                        next_frontier.append(h)
            frontier = next_frontier
        # attachments referenced anywhere in the chain + by the head tx
        att_missing = []
        wanted = list(self.head_attachments)
        for stx in fetched.values():
            wanted.extend(stx.wtx.attachments)
        for att_id in wanted:
            if att_id not in self.services.attachments \
                    and att_id not in att_missing:
                att_missing.append(att_id)
        if att_missing:
            yield from self.sub_flow(
                FetchAttachmentsFlow(att_missing, self.other_party)
            )
        # verify + record dependencies-first
        for stx in _topo_sort(fetched):
            stx.verify(
                self.services, verifier=self.services.batch_verifier
            )
            self.services.record_transactions([stx])
        return len(fetched)


def _topo_sort(txs: dict[SecureHash, SignedTransaction]):
    """Dependencies before dependents (iterative DFS)."""
    order, seen = [], set()
    for root in txs:
        stack = [(root, False)]
        while stack:
            h, expanded = stack.pop()
            if expanded:
                order.append(txs[h])
                continue
            if h in seen or h not in txs:
                continue
            seen.add(h)
            stack.append((h, True))
            for ref in txs[h].wtx.inputs:
                stack.append((ref.txhash, False))
    return order


# ---------------------------------------------------------------------------
# send / receive whole transactions


@initiating_flow
class SendTransactionFlow(FlowLogic):
    """Send a transaction to a peer who records it after resolving and
    verifying (reference: SendTransactionFlow/BroadcastTransactionFlow).
    The receiver pulls the backchain from us via the data-vending
    handlers."""

    def __init__(self, other_party: Party, stx: SignedTransaction):
        self.other_party = other_party
        self.stx = stx

    def call(self):
        # send, then wait for an ack so our flow outlives the peer's
        # backchain fetches (which need our vending handlers alive is
        # NOT required — they are separate top-level flows — but the ack
        # confirms delivery before finality reports success)
        ack = yield from self.send_and_receive(
            self.other_party, self.stx, str
        )
        if ack != "ok":
            raise FlowException(f"{self.other_party} rejected tx: {ack}")
        return None


@initiated_by(SendTransactionFlow)
class ReceiveTransactionFlow(FlowLogic):
    """Receive, resolve, verify, record, ack."""

    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        stx = yield from self.receive(self.other_party, SignedTransaction)
        yield from self.sub_flow(
            ResolveTransactionsFlow(
                [r.txhash for r in stx.wtx.inputs],
                self.other_party,
                head_attachments=stx.wtx.attachments,
            )
        )
        stx.verify(self.services, verifier=self.services.batch_verifier)
        self.services.record_transactions([stx])
        yield from self.send(self.other_party, "ok")
        return stx.id


# ---------------------------------------------------------------------------
# notarisation


@ser.serializable
@dataclass(frozen=True)
class NotarisationResponse:
    signatures: tuple[TransactionSignature, ...]
    error: Optional[NotaryError]


@ser.serializable
@dataclass(frozen=True)
class NotarisationRequest:
    """Deadline-carrying notarisation envelope (node/qos.py): `tx` is
    the plain payload (SignedTransaction or FilteredTransaction) and
    `deadline_micros` the absolute wall-clock microseconds after which
    the requester no longer wants the answer — a QoS-enabled notary
    sheds the request at its cheapest point (before backchain
    resolution, pre-stage at the flush) into a typed `shed` error.

    Only sent when the client SET a deadline, so deadline-less traffic
    keeps the bare payload shape on the wire. Deadlines cross nodes as
    absolute wall-clock values: meaningful to the tolerance of cluster
    clock sync, like the notary time-window check itself."""

    tx: Any
    deadline_micros: int


@initiating_flow
class NotaryFlow(FlowLogic):
    """Client side of notarisation (NotaryFlow.Client, NotaryFlow.kt:
    34-96): pre-check signatures except the notary's, send the full tx
    (validating) or a Merkle tear-off of inputs+timewindow
    (non-validating), verify the returned signature(s)."""

    def __init__(
        self,
        stx: SignedTransaction,
        deadline_micros: Optional[int] = None,
    ):
        """`deadline_micros`: optional absolute wall-clock deadline —
        set it and the request ships in a NotarisationRequest envelope
        so a QoS-enabled notary can shed it once expired instead of
        burning batch-verify work on an answer nobody is waiting for."""
        self.stx = stx
        self.deadline_micros = deadline_micros

    def call(self):
        notary = self.stx.wtx.notary
        if notary is None:
            raise FlowException("transaction has no notary")
        # the trace is BORN here when tracing is on: a client-side root
        # span whose context rides every session message (and, notary-
        # side, the consensus protocol messages), so one notarisation
        # assembles as one cross-node tree via GET /cluster/trace/<id>.
        # Replayed (checkpoint-restored) flows stay untraced — a second
        # root span joined to a finished trace would orphan it.
        tracer = tracing.get_tracer()
        machine = getattr(self, "_machine", None)
        span = None
        if (
            tracer.enabled
            and machine is not None
            and machine.trace is None
            and not machine.replaying
        ):
            span = tracer.start_trace(
                "notarise.client", tx_id=str(self.stx.id)
            )
            machine.trace = tuple(span.context)
        try:
            result = yield from self._notarise(notary)
            return result
        finally:
            if span is not None:
                span.end()

    def _notarise(self, notary):
        self.stx.verify_required_signatures(
            except_keys={notary.owning_key}
        )
        if self.services.network_map_cache.is_validating_notary(notary):
            payload: Any = self.stx
        else:
            # tear-off reveals only StateRefs, the notary and the time
            # window (NotaryFlow.kt:68-77); those are exactly the
            # component types of groups INPUTS/NOTARY/TIMEWINDOW
            payload = self.stx.wtx.build_filtered_transaction(
                lambda c: isinstance(c, (StateRef, Party, TimeWindow))
            )
        if self.deadline_micros is not None:
            payload = NotarisationRequest(payload, self.deadline_micros)
        members = self.services.network_map_cache.cluster_members(notary)
        if members:
            resp = yield from self._request_from_cluster(
                members, payload
            )
        else:
            resp = yield from self.send_and_receive(
                notary, payload, NotarisationResponse
            )
        if resp.error is not None:
            raise NotaryException(resp.error)
        sigs = resp.signatures
        if not sigs:
            raise NotaryException(
                NotaryError("protocol", "notary returned no signatures")
            )
        signer_keys = {s.by for s in sigs}
        if not comp.is_fulfilled_by(notary.owning_key, signer_keys):
            raise NotaryException(
                NotaryError("protocol", "response not signed by the notary")
            )
        for s in sigs:
            s.verify(self.stx.id)
        return list(sigs)

    # per-attempt timeout before trying the next cluster member
    # (sendAndReceiveWithRetry, FlowLogic.kt:108 / NotaryFlow.kt:159)
    retry_timeout_micros = 3_000_000

    def _request_from_cluster(self, members, payload):
        """Distributed notary: each attempt opens a session to a
        DIFFERENT member (sessions key per member party, so a retry is
        a fresh session, not a resend into a dead one). Commits are
        idempotent cluster-side, so a slow member answering late is
        harmless."""
        last_exc = None
        for member in members * 2:
            member_party = member.legal_identity
            try:
                return (
                    yield from self.send_and_receive(
                        member_party,
                        payload,
                        NotarisationResponse,
                        timeout_micros=self.retry_timeout_micros,
                    )
                )
            except (FlowTimeoutException, FlowSessionException) as e:
                last_exc = e
        raise NotaryException(
            NotaryError(
                "unavailable",
                f"no notary cluster member responded: {last_exc}",
            )
        )


@initiated_by(NotaryFlow)
class NotaryServiceFlow(FlowLogic):
    """Service side (NotaryFlow.Service + Non/ValidatingNotaryFlow):
    dispatches to the node's installed NotaryService. The service object
    is looked up from the ServiceHub at run time so restored checkpoints
    re-bind to it (the reference's SingletonSerializeAsToken pattern,
    core/.../serialization/SerializationToken.kt)."""

    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        service = getattr(self.services, "notary_service", None)
        if service is None:
            raise FlowException("this node is not a notary")
        payload = yield from self.receive(self.other_party)
        deadline = None
        if isinstance(payload, NotarisationRequest):
            deadline = payload.deadline_micros
            payload = payload.tx
        qos = getattr(service, "qos", None)
        if deadline is not None and qos is not None:
            # cheapest service-side point: an already-expired request
            # sheds BEFORE backchain resolution pulls the whole history
            from ..node import qos as qoslib

            if qoslib.expired(deadline, self.services.clock.now_micros()):
                qos.count_shed(qoslib.SHED_EXPIRED_INGRESS)
                yield from self.send(
                    self.other_party,
                    NotarisationResponse(
                        (),
                        NotaryError(
                            qoslib.SHED_KIND,
                            "deadline expired before service dispatch",
                        ),
                    ),
                )
                return None
        if service.validating:
            if not isinstance(payload, SignedTransaction):
                raise FlowException("validating notary needs the full tx")
            # pull the backchain from the requester before validating
            yield from self.sub_flow(
                ResolveTransactionsFlow(
                    [r.txhash for r in payload.wtx.inputs],
                    self.other_party,
                    head_attachments=payload.wtx.attachments,
                )
            )
        elif not isinstance(payload, FilteredTransaction):
            raise FlowException("non-validating notary takes a tear-off")
        result = yield from service.process(
            payload, self.other_party, deadline=deadline,
            trace=getattr(self._machine, "trace", None),
        )
        if isinstance(result, NotaryError):
            resp = NotarisationResponse((), result)
        elif isinstance(result, (list, tuple)):
            # distributed notaries return one signature per agreeing
            # replica; the requester checks them against the cluster's
            # composite threshold identity (BFTSMaRt.kt ClusterResponse)
            resp = NotarisationResponse(tuple(result), None)
        else:
            resp = NotarisationResponse((result,), None)
        yield from self.send(self.other_party, resp)
        return None


# ---------------------------------------------------------------------------
# finality


@initiating_flow
class FinalityFlow(FlowLogic):
    """Verify -> notarise -> record -> broadcast to participants
    (FinalityFlow.kt). Returns the fully-signed transaction."""

    def __init__(self, stx: SignedTransaction, extra_recipients=()):
        self.stx = stx
        self.extra_recipients = tuple(extra_recipients)

    def call(self):
        yield from self.step("verifying")
        stx = self.stx
        notary = stx.wtx.notary
        stx.verify(
            self.services,
            check_sufficient_signatures=False,
            verifier=self.services.batch_verifier,
        )
        yield from self.step("notarising")
        needs_notary = notary is not None and (
            len(stx.wtx.inputs) > 0 or stx.wtx.time_window is not None
        )
        if needs_notary:
            notary_sigs = yield from self.sub_flow(NotaryFlow(stx))
            stx = stx.with_additional_signatures(notary_sigs)
        stx.verify_required_signatures()
        yield from self.step("recording")
        self.services.record_transactions([stx])
        yield from self.step("broadcasting")
        for party in self._recipients(stx):
            yield from self.sub_flow(SendTransactionFlow(party, stx))
        return stx

    def _recipients(self, stx) -> list[Party]:
        us = self.our_identity
        out: dict[str, Party] = {}
        for ts in stx.wtx.outputs:
            for participant in ts.data.participants:
                p = self.services.identity.well_known_party(
                    _as_party_or_key(participant, self.services)
                )
                if p is not None and p.name != us.name:
                    out[p.name] = p
        for p in self.extra_recipients:
            if p.name != us.name:
                out[p.name] = p
        return [out[k] for k in sorted(out)]


def _as_party_or_key(participant, services):
    if isinstance(participant, Party) or isinstance(participant, AnonymousParty):
        return participant
    return AnonymousParty(participant)  # bare key


# ---------------------------------------------------------------------------
# signature collection


@initiating_flow
class CollectSignaturesFlow(FlowLogic):
    """Gather counterparty signatures over a partially-signed tx
    (CollectSignaturesFlow.kt): for every required signer we can't sign
    for, send the tx and collect a signature back."""

    def __init__(self, stx: SignedTransaction):
        self.stx = stx

    def call(self):
        stx = self.stx
        notary_key = (
            stx.wtx.notary.owning_key if stx.wtx.notary is not None else None
        )
        have = {s.by for s in stx.sigs}
        ours = self.services.key_management.keys
        for key in sorted(
            stx.wtx.required_signing_keys - {notary_key},
            key=lambda k: k.fingerprint() if hasattr(k, "fingerprint") else b"",
        ):
            if comp.is_fulfilled_by(key, have | ours):
                continue
            party = self.services.identity.party_from_key(key)
            if party is None:
                raise FlowException(f"no identity known for signer {key}")
            sig = yield from self.send_and_receive(
                party, stx, TransactionSignature
            )
            if not comp.is_fulfilled_by(key, have | {sig.by}):
                raise FlowException(f"{party} signed with the wrong key")
            sig.verify(stx.id)
            stx = stx.with_additional_signature(sig)
            have.add(sig.by)
        return stx


@initiated_by(CollectSignaturesFlow)
class SignTransactionFlow(FlowLogic):
    """Counterparty side: resolve + verify the proposal, run the
    node-installed acceptance check, sign (SignTransactionFlow in
    CollectSignaturesFlow.kt — abstract checkTransaction there; here a
    per-node `sign_transaction_check` hook on the ServiceHub)."""

    def __init__(self, other_party: Party):
        self.other_party = other_party

    def call(self):
        stx = yield from self.receive(self.other_party, SignedTransaction)
        yield from self.sub_flow(
            ResolveTransactionsFlow(
                [r.txhash for r in stx.wtx.inputs],
                self.other_party,
                head_attachments=stx.wtx.attachments,
            )
        )
        # the proposal is signed by the initiator but not us/notary yet:
        # check what's there is valid + contracts pass
        stx.check_signatures_are_valid(self.services.batch_verifier)
        ltx = stx.to_ledger_transaction(self.services)
        self.services.transaction_verifier.verify(ltx).result()
        check = getattr(self.services, "sign_transaction_check", None)
        if check is not None:
            check(stx, self.other_party)   # raises to refuse
        key = self.services.key_management.our_first_key_for(
            stx.wtx.required_signing_keys
        )
        if key is None:
            raise FlowException("we are not a required signer")
        sig = self.services.key_management.sign(stx.id, key)
        yield from self.send(self.other_party, sig)
        return None


# ---------------------------------------------------------------------------
# confidential identities


@ser.serializable
@dataclass(frozen=True)
class AnonymousIdentity:
    """A freshly-minted anonymous key claimed by a well-known party.
    TWO signatures bind the pair (the certificate's role in the
    reference's TransactionKeyFlow): the well-known key endorses the
    fresh key, and the fresh key proves POSSESSION — without the
    latter, a counterparty could claim someone else's key and hijack
    that key's identity mapping at every peer."""

    well_known: Party
    fresh_key: Any                      # PublicKey
    signature: bytes                    # by well_known over the bind
    fresh_signature: bytes              # by fresh_key over the bind

    def bind_bytes(self) -> bytes:
        return b"confidential-identity" + ser.encode(
            [self.well_known, self.fresh_key]
        )

    def verify(self) -> bool:
        bind = self.bind_bytes()
        return schemes.verify_one(
            self.well_known.owning_key, self.signature, bind
        ) and schemes.verify_one(
            self.fresh_key, self.fresh_signature, bind
        )


@initiating_flow
class SwapIdentitiesFlow(FlowLogic):
    """TransactionKeyFlow: both sides mint fresh (anonymous) keys for
    one transaction and exchange them with ownership proofs, recording
    the key->party mapping in their identity services. Returns
    {party: AnonymousParty} for us and the counterparty."""

    def __init__(self, other: Party):
        self.other = other

    def call(self):
        ours = yield from self.record(
            lambda: _minted_identity(self.services)
        )
        # our own mapping too: we must resolve our own anonymous key
        # when it later appears as a signer/participant
        self.services.identity.register_anonymous(
            AnonymousParty(ours.fresh_key), self.our_identity
        )
        theirs = yield from self.send_and_receive(
            self.other, ours, AnonymousIdentity
        )
        _accept_identity(self.services, theirs, expected=self.other)
        return {
            self.our_identity: AnonymousParty(ours.fresh_key),
            self.other: AnonymousParty(theirs.fresh_key),
        }


@initiated_by(SwapIdentitiesFlow)
class SwapIdentitiesHandler(FlowLogic):
    def __init__(self, other: Party):
        self.other = other

    def call(self):
        theirs = yield from self.receive(self.other, AnonymousIdentity)
        _accept_identity(self.services, theirs, expected=self.other)
        ours = yield from self.record(
            lambda: _minted_identity(self.services)
        )
        self.services.identity.register_anonymous(
            AnonymousParty(ours.fresh_key), self.our_identity
        )
        yield from self.send(self.other, ours)
        return None


def _minted_identity(services) -> AnonymousIdentity:
    """Mint + self-certify a fresh key (journaled: replays reuse it)."""
    me = services.my_info.legal_identity
    fresh = services.key_management.fresh_key()
    bind = AnonymousIdentity(me, fresh, b"", b"").bind_bytes()
    sig = services.key_management.sign_bytes(bind, me.owning_key)
    fresh_sig = services.key_management.sign_bytes(bind, fresh)
    return AnonymousIdentity(me, fresh, sig, fresh_sig)


def _accept_identity(services, ident: AnonymousIdentity, expected: Party):
    """Validate + register a counterparty's anonymous identity."""
    if ident.well_known != expected:
        raise FlowException(
            f"identity claims {ident.well_known}, session is with {expected}"
        )
    try:
        ok = ident.verify()
    except Exception:
        # fresh_key is attacker-controlled wire data: a composite key
        # or non-key value makes verify_one raise (UnsupportedScheme /
        # AttributeError) rather than return False — same verdict
        ok = False
    if not ok:
        raise FlowException("anonymous identity proof failed verification")
    try:
        services.identity.register_anonymous(
            AnonymousParty(ident.fresh_key), ident.well_known
        )
    except ValueError as e:
        raise FlowException(f"identity registration refused: {e}")
