"""Fleet soak: a deterministic, simulated-time fleet simulator.

The serving control plane grew piecewise — deadlines/admission/brownout
(node/qos.py), watchdogs/SLO alerts//cluster (utils/health.py), the
sharded commit plane (node/notary.py), perf attribution (utils/perf.py)
— but nothing drove them TOGETHER at production shape. This module is
that driver, the ROADMAP's "acceptance bar for 'millions of users'
claims, runnable in CI": thousands of client identities multiplexed
against a multi-node notary cluster in all three flavours (batching
single-node, Raft, BFT), with churn injected through first-class fabric
hooks and the ledger reconciled bit-exact against a model afterwards.

Reference shape: `tools/loadtest` (LoadTest.kt's generate/apply/gather/
reconcile loop, Disruption.kt's kill/restart/slow interleavings,
CrossCashTest's invariant) — but where the reference drives real
processes over SSH for minutes, this runs on the shared `TestClock`:
a thousand-node-second soak executes in CI seconds, deterministically.

Three cooperating pieces:

  `FleetSim` — the scenario engine. A declarative `FleetScenario`
      (client count, phases of ramp/steady/spike traffic, a
      `TrafficMix` of deadline distributions, bulk traffic, injected
      double-spends and cross-shard conflicts) executes round by
      round: each round submits through the REAL notary entry points
      (`NotaryService.process` generators, stepped exactly the way the
      flow state machine steps them), pumps the fabric to quiescence,
      beats/ticks every member's health plane, samples the
      healthz//cluster story into a timeline, and advances the clock.

  `ChaosPlane` — fault scheduling at stream fractions (the
      `Disruption.at_fraction` idiom). Faults act through the
      first-class seams — `messaging.FabricFaults` for partitions/
      slow links/drops, member kill+rebuild for crash-restart — never
      by monkeypatching. Every application/revert is logged with its
      simulated-time window: the "injected reality" the invariant
      checker reconciles the control plane's story against.

  `InvariantChecker` — reconciliation. After the soak: every alive
      replica's committed map must agree; every injected double-spend
      must have exactly one winner ON THE LEDGER; signed answers must
      match the ledger exactly (no phantom commits, no lost value);
      nothing admitted-then-expired; the steady-state admitted p99
      must hold the SLO; brownout must have shed ONLY bulk/
      deadline-less traffic; and the health plane must have told the
      truth — healthz flipped while the fault was live, /cluster
      marked the victim, both recovered after the heal.

Throughput with reconciliation is a claim; without it, just a number.

Port of corda_tpu/testing/fleet.py. The fleet's MockNetwork verifies on
the card unless a verifier is passed (`batch_verifier=None` is a
CudaBatchVerifier, as every entry point of the port), so every notary
flush of a soak goes through the card's kernels. Two differences from
the reference (divergence D10):

  * Degraded mode: where the fleet's verifier runs off the card, every
    batching notary it builds serves with `degraded_fallback=True` (the
    reference's default); on the card the port's notary leaves it off
    (divergence D2: no flush moves to the CPU), so a `device_fault`
    chaos event over a card verifier is refused with ValueError at
    construction instead of soaking into answers the checker rejects.
  * The verifier pool's workers verify on the fleet's verifier, where
    the reference builds each a CpuBatchVerifier: on the card a pool
    soak verifies on the card; over a CpuBatchVerifier the answers are
    the reference's.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..core.contracts import StateRef
from ..core.identity import Party
from ..core.transactions import WireTransaction
from ..crypto import schemes
from ..crypto.hashes import SecureHash
from ..node import qos as qoslib
from ..node.messaging import FabricFaults, Message
from ..node.notary import NotaryError, verifier_on_card
from ..utils import tracing as tracelib
from ..utils.health import (
    AlertRule,
    ClusterHealth,
    HealthMonitor,
    HealthPolicy,
    IncidentRecorder,
)
from .mock_network import MockNetwork


def _metric_count(registry, name: str) -> int:
    """Read a counter/meter total WITHOUT registering it: the fleet
    reconciles against series OWNED by the services it drives, and a
    `registry.counter(name)` read would create the series when the
    owner has not — a second registration site for every dashboard
    name the checker touches (tools/lint metrics pass)."""
    m = registry.get(name)
    return m.count if m is not None else 0

# outcome vocabulary — one set for records, reports and assertions
OUT_SIGNED = "signed"
OUT_CONFLICT = "conflict"
OUT_SHED = "shed"
OUT_UNAVAILABLE = "unavailable"
OUT_LOST = "lost"          # future never resolved (in flight at a kill)

FLAVOURS = ("batching", "raft", "bft", "distributed")


# ---------------------------------------------------------------------------
# scenario DSL


@dataclass(frozen=True)
class TrafficMix:
    """What one phase's offered traffic looks like.

    `bulk_fraction` of the offer is deadline-less bulk (resolution-
    flood-shaped) traffic routed through the QoS lane seam (batching
    flavour only — cluster flavours have no lane router and ignore
    it). `conflict_fraction` of interactive spends ALSO submit a rival
    transaction claiming the same input — the injected double-spends
    the ledger must resolve to exactly one winner. `cross_shard_
    fraction` of spends carry two inputs routed to different commit-
    plane shards (sharded batching only)."""

    deadline_micros: int = 60_000
    deadline_jitter_micros: int = 0
    bulk_fraction: float = 0.0
    conflict_fraction: float = 0.0
    cross_shard_fraction: float = 0.0


@dataclass(frozen=True)
class Phase:
    """One traffic phase: `offered_per_round` requests injected each of
    `rounds` rounds. Ramp/steady/spike arcs are just phase sequences."""

    name: str
    rounds: int
    offered_per_round: int
    mix: Optional[TrafficMix] = None     # None = the scenario default


@dataclass(frozen=True)
class FleetScenario:
    """The declarative soak: who offers how much, when, for how long.

    `clients` identities are minted up front (names `fleet-c<k>` over a
    small keypair pool — non-validating notaries authenticate requesters
    by name, so the pool keeps thousand-client fleets cheap) and
    round-robined through the traffic, so a long enough stream touches
    EVERY identity. `round_micros` is the simulated wall step between
    delivery rounds; total simulated soak time is
    sum(phase rounds) * round_micros."""

    clients: int = 1000
    phases: tuple[Phase, ...] = (
        Phase("ramp", 4, 8),
        Phase("steady", 12, 16),
        Phase("spike", 4, 48),
        Phase("steady2", 8, 16),
    )
    mix: TrafficMix = field(default_factory=TrafficMix)
    round_micros: int = 20_000
    drain_rounds: int = 60
    # rounds run AFTER the last answer lands: consensus followers
    # apply the replicated tail (raft commit-index propagation, BFT
    # checkpoint execution) so the replica-agreement reconciliation
    # reads converged ledgers, and health alerts get room to resolve
    settle_rounds: int = 10
    seed: int = 0
    key_pool: int = 8

    def total_offered(self) -> int:
        return sum(p.rounds * p.offered_per_round for p in self.phases)

    def mix_of(self, phase: Phase) -> TrafficMix:
        return phase.mix or self.mix


@dataclass
class FleetClient:
    name: str
    party: Party
    submitted: int = 0


@dataclass
class RequestRecord:
    """One request's life, model-side: what was asked, what came back,
    when — the reconciliation input."""

    rid: int
    client: str
    tx_id: Any
    inputs: tuple
    kind: str                  # "interactive" | "rival"
    phase: str
    member: str                # gateway member it was submitted to
    deadline: Optional[int]
    submitted_at: int
    answered_at: Optional[int] = None
    outcome: Optional[str] = None
    shed_reason: Optional[str] = None
    rival_of: Optional[int] = None   # rid of the spend this one contests
    trace_id: Optional[int] = None   # tracing-enabled runs: the root trace


# ---------------------------------------------------------------------------
# chaos plane


@dataclass
class ChaosEvent:
    """One fault: `apply(sim)` fires when the offered stream crosses
    `at_fraction` (Disruption.kt's scheduling), `revert(sim)` when it
    crosses `revert_at_fraction` (None = never — one-shot actions).
    `member` names the victim by cluster index; the plane resolves it
    to a member name in the injected-reality log."""

    name: str
    kind: str                  # "kill" | "partition" | "slow" | custom
    at_fraction: float
    apply: Callable[["FleetSim"], None]
    revert_at_fraction: Optional[float] = None
    revert: Optional[Callable[["FleetSim"], None]] = None
    member: Optional[int] = None


def kill_restart(member: int, at: float, restart_at: float) -> ChaosEvent:
    """SIGKILL member `member` (by cluster index) at `at` of the
    stream; boot a replacement over the same fabric endpoint at
    `restart_at`. The replacement starts EMPTY and must be restored by
    the cluster's own state transfer; the endpoint's dedupe set
    survives, so frames redelivered across the outage are absorbed."""

    return ChaosEvent(
        f"kill-restart[{member}]", "kill", at,
        lambda sim: sim.kill_member(member),
        restart_at,
        lambda sim: sim.restart_member(member),
        member=member,
    )


def partition(member: int, at: float, heal_at: float) -> ChaosEvent:
    """Split member `member` away from the rest of the fleet (minority
    partition) at `at`; heal at `heal_at`. Queued frames redeliver on
    heal — nothing is lost, consensus just waited."""

    def apply(sim: "FleetSim") -> None:
        victim = sim.members[member].name
        rest = {n.name for n in sim.net.nodes if n.name != victim}
        sim.faults.partition({victim}, rest)
        sim._partitioned = victim

    def revert(sim: "FleetSim") -> None:
        sim.faults.heal()
        sim._partitioned = None

    return ChaosEvent(
        f"partition[{member}]", "partition", at, apply, heal_at, revert,
        member=member,
    )


def freeze(member: int, at: float, until: float) -> ChaosEvent:
    """Wedge member `member`'s serving loop (the SIGSTOP/stuck-flush
    analogue): the node stays reachable and consensus keeps running,
    but its pump heartbeat stops beating — the watchdog must flip its
    /healthz to unhealthy within one deadline and recover after."""

    def apply(sim: "FleetSim") -> None:
        sim.frozen.add(sim.members[member].name)

    def thaw(sim: "FleetSim") -> None:
        sim.frozen.discard(sim.members[member].name)

    return ChaosEvent(
        f"freeze[{member}]", "freeze", at, apply, until, thaw, member=member
    )


def slow_peer(
    member: int, at: float, until: float, delay_micros: int = 60_000
) -> ChaosEvent:
    """Add `delay_micros` of per-frame latency on every link touching
    member `member` between `at` and `until` of the stream — the
    straggler replica that lags consensus without ever dying."""

    return ChaosEvent(
        f"slow-peer[{member}]", "slow", at,
        lambda sim: sim.faults.slow_peer(
            sim.members[member].name, delay_micros
        ),
        until,
        lambda sim: sim.faults.slow_peer(sim.members[member].name, 0),
        member=member,
    )


def kill_verifier(worker: int, at: float, revive_at: Optional[float] = None) -> ChaosEvent:
    """Kill out-of-process verifier worker `worker` (by pool index) at
    `at` of the stream, mid-batch — its in-flight nonces must
    re-dispatch to a survivor via the lease/redispatch machinery
    (node/verifier.py round 9) and every verify future still resolve.
    `revive_at` optionally brings the worker back (re-attaching under
    the same name; stale answers from before the kill are rejected by
    the attempt binding). Requires FleetSim(verifier_pool=N>=2)."""

    return ChaosEvent(
        f"kill-verifier[{worker}]", "kill_verifier", at,
        lambda sim: sim.kill_verifier_worker(worker),
        revive_at,
        (lambda sim: sim.revive_verifier_worker(worker))
        if revive_at is not None else None,
        member=0,
    )


def device_fault(
    at: float, heal_at: Optional[float] = None, flushes: int = 2
) -> ChaosEvent:
    """Inject a device failure into the notary's verify dispatch
    for the next `flushes` dispatches (the DispatchFaultInjector seam,
    crypto/batch_verifier.py) — the degraded-mode guard must retry,
    fall back to the CPU reference bit-exact, fire
    `notary.degraded_mode`, and auto-recover once the injector drains.
    `heal_at` bounds the logged fault window (disarming any leftover
    failures) so the checker can reconcile the alert story against it.
    Batching flavour only, and only off the card (D10: the port's notary
    never falls back from the card to the CPU)."""

    return ChaosEvent(
        f"device-fault[x{flushes}]", "device_fault", at,
        lambda sim: sim.inject_device_fault(flushes),
        heal_at,
        (lambda sim: sim.device_injector.disarm())
        if heal_at is not None else None,
        member=0,
    )


def kill_notary_mid_flush(at: float, restart_at: float) -> ChaosEvent:
    """SIGKILL the (single-node batching) notary with a non-empty
    pending queue at `at`; boot a replacement over the same persistent
    state at `restart_at`. In-flight requests die with the process —
    the intent WAL (FleetSim(intent_wal=True)) replays them through
    the replacement's normal flush path, and the re-attached futures
    resolve every still-waiting client: zero admitted-then-lost."""

    return ChaosEvent(
        f"kill-notary", "kill_notary", at,
        lambda sim: sim.kill_notary(),
        restart_at,
        lambda sim: sim.restart_notary(),
        member=0,
    )


class ChaosPlane:
    """Applies scheduled faults as the stream crosses their fractions
    and records each one's simulated-time window — the injected-reality
    log `InvariantChecker.check_health_story` reconciles against."""

    def __init__(self, events: tuple[ChaosEvent, ...] = ()):
        self.events = sorted(events, key=lambda e: e.at_fraction)
        self.log: list[dict] = []
        self._applied: list[tuple[ChaosEvent, dict]] = []

    def step(self, sim: "FleetSim", fraction: float) -> None:
        while self.events and fraction >= self.events[0].at_fraction:
            ev = self.events.pop(0)
            ev.apply(sim)
            entry = {
                "name": ev.name,
                "kind": ev.kind,
                "target": (
                    sim.members[ev.member].name
                    if ev.member is not None else None
                ),
                "applied_at_micros": sim.now(),
                "applied_round": sim.round_no,
                "reverted_at_micros": None,
                "reverted_round": None,
                "revert_at_fraction": ev.revert_at_fraction,
            }
            self.log.append(entry)
            if ev.revert is not None:
                self._applied.append((ev, entry))
        for ev, entry in list(self._applied):
            revert_at = (
                ev.revert_at_fraction
                if ev.revert_at_fraction is not None else float("inf")
            )
            if fraction >= revert_at:
                ev.revert(sim)
                entry["reverted_at_micros"] = sim.now()
                entry["reverted_round"] = sim.round_no
                self._applied.remove((ev, entry))

    def finish(self, sim: "FleetSim") -> None:
        """Revert anything still live (drain must run on a healed
        fleet) and apply anything never reached."""
        self.step(sim, float("inf"))


# ---------------------------------------------------------------------------
# traffic sources


class TearOffSource:
    """Synthetic non-validating traffic: per-client coins as fabricated
    StateRefs, spent via minimal WireTransactions torn off for the
    notary (inputs + notary + meta revealed — everything a
    non-validating flavour checks). Cheap enough to mint thousands in
    CI; the uniqueness semantics are EXACTLY production's, because the
    notary never sees more than the tear-off either way."""

    def __init__(self, notary_party: Party, seed: int = 0):
        self.notary = notary_party
        self._counter = 0
        self._rng = random.Random(seed)

    def _wtx(self, ref: StateRef, nonce: bytes) -> WireTransaction:
        return WireTransaction(
            inputs=(ref,),
            outputs=(),
            commands=(),
            # the attachment hash is a pure nonce: two rivals spending
            # the same ref need DIFFERENT transaction ids
            attachments=(SecureHash.sha256(nonce),),
            notary=self.notary,
            time_window=None,
        )

    def spend(self, client: FleetClient):
        """(ftx, inputs, tx_id) consuming a fresh client-owned coin."""
        self._counter += 1
        ref = StateRef(
            SecureHash.sha256(
                f"fleet:{client.name}:coin:{client.submitted}".encode()
            ),
            0,
        )
        wtx = self._wtx(ref, b"spend:%d" % self._counter)
        return (
            wtx.build_filtered_transaction(lambda c: True),
            wtx.inputs,
            wtx.id,
        )

    def rival(self, inputs: tuple):
        """A DIFFERENT transaction claiming the same inputs — the
        injected double-spend."""
        self._counter += 1
        wtx = WireTransaction(
            inputs=tuple(inputs),
            outputs=(),
            commands=(),
            attachments=(SecureHash.sha256(b"rival:%d" % self._counter),),
            notary=self.notary,
            time_window=None,
        )
        return (
            wtx.build_filtered_transaction(lambda c: True),
            wtx.inputs,
            wtx.id,
        )


class CashSpendSource:
    """Real signed cash spends for the VALIDATING batching flavour —
    issues recorded at the notary, spends signed by the owner, rivals
    built against the same issue (tests/test_qos.py's `_rig`
    discipline), plus two-input cross-shard spends for the sharded
    commit plane."""

    def __init__(
        self,
        net: MockNetwork,
        notary_node,
        count: int,
        cross_shard_fraction: float = 0.0,
        seed: int = 0,
        extra_record_nodes=(),
        notary_party: Optional[Party] = None,
    ):
        from ..core.contracts import Amount, Issued
        from ..core.identity import PartyAndReference
        from ..core.transactions import TransactionBuilder
        from ..finance.cash import CASH_CONTRACT, CashIssue, CashState

        self._rng = random.Random(seed)
        self._notary_party = notary_party
        bank = net.create_node(
            "FleetBank", scheme_id=schemes.ECDSA_SECP256R1_SHA256
        )
        owner = net.create_node(
            "FleetOwner", scheme_id=schemes.ECDSA_SECP256R1_SHA256
        )
        self.bank, self.owner = bank, owner
        self.notary_node = notary_node
        token = Issued(PartyAndReference(bank.party, b"\x01"), "USD")
        self._token = token
        self._issues = []
        # a two-input (cross-shard) spend consumes TWO issues for one
        # request: provision the extras up front
        n_cross = int(count * cross_shard_fraction) // 2
        count = count + n_cross
        for i in range(count):
            ib = TransactionBuilder(self.notary_party)
            ib.add_output_state(
                CashState(Amount(100 + i, token), owner.party.owning_key),
                CASH_CONTRACT,
            )
            ib.add_command(CashIssue(i + 1), bank.party.owning_key)
            issue = bank.services.sign_initial_transaction(ib)
            notary_node.services.record_transactions([issue])
            owner.services.record_transactions([issue])
            for extra in extra_record_nodes:
                # distributed flavour: every member validates, so the
                # backchain must resolve on all of them
                extra.services.record_transactions([issue])
            self._issues.append(issue)
        self._next = 0
        self._cross_budget = n_cross

    @property
    def notary_party(self) -> Party:
        """The party transactions name as notary: the cluster service
        identity when one was passed (distributed flavour), the notary
        node's own otherwise."""
        return self._notary_party or self.notary_node.party

    def _spend_of(self, issues: list):
        from ..core.contracts import Amount
        from ..core.transactions import TransactionBuilder
        from ..finance.cash import CASH_CONTRACT, CashMove, CashState

        sb = TransactionBuilder(self.notary_party)
        total = 0
        for issue in issues:
            sb.add_input_state(
                self.owner.vault.state_and_ref(StateRef(issue.id, 0))
            )
            total += issue.wtx.outputs[0].data.amount.quantity
        sb.add_output_state(
            CashState(
                Amount(total, self._token), self.bank.party.owning_key
            ),
            CASH_CONTRACT,
            self.notary_party,
        )
        sb.add_command(CashMove(), self.owner.party.owning_key)
        return self.owner.services.sign_initial_transaction(sb)

    def spend(self, client: FleetClient):
        """(stx, inputs, tx_id): the next prebuilt issue spent — a
        two-input spend while the cross-shard budget lasts."""
        take = 2 if self._cross_budget > 0 and self._next + 1 < len(
            self._issues
        ) and self._rng.random() < 0.5 else 1
        if self._next + take > len(self._issues):
            raise RuntimeError(
                "CashSpendSource exhausted: size the fixture to the "
                "scenario's total interactive offer"
            )
        issues = self._issues[self._next:self._next + take]
        self._next += take
        if take == 2:
            self._cross_budget -= 1
        stx = self._spend_of(issues)
        return stx, stx.wtx.inputs, stx.id

    def rival(self, inputs: tuple):
        """A contract-VALID double spend: same inputs, value conserved,
        but paid back to the owner instead of the bank — a different
        transaction id claiming the same states, so only the
        uniqueness layer can reject it."""
        from ..core.contracts import Amount
        from ..core.transactions import TransactionBuilder
        from ..finance.cash import CASH_CONTRACT, CashMove, CashState

        sb = TransactionBuilder(self.notary_party)
        total = 0
        for ref in inputs:
            sar = self.owner.vault.state_and_ref(ref)
            sb.add_input_state(sar)
            total += sar.state.data.amount.quantity
        sb.add_output_state(
            CashState(
                Amount(total, self._token), self.owner.party.owning_key
            ),
            CASH_CONTRACT,
            self.notary_party,
        )
        sb.add_command(CashMove(), self.owner.party.owning_key)
        stx = self.owner.services.sign_initial_transaction(sb)
        return stx, stx.wtx.inputs, stx.id


class SyntheticSpendSource:
    """Unsigned, command-less spends over an always-pass contract —
    the ten-thousand-identity scale source. A command-less transaction
    has no required signers, so the validating flush accepts it with
    zero signatures; per-spend pure-python ECDSA (~10 ms each) would
    otherwise dominate a 10k-request soak wall a hundred to one. The
    uniqueness semantics under test — cross-shard routing, two-phase
    reserve→commit, double-spend rivalry — depend only on the input
    refs, which are as real as the cash source's."""

    def __init__(
        self,
        members,
        notary_party: Party,
        count: int,
        cross_shard_fraction: float = 0.0,
        seed: int = 0,
    ):
        from ..core.contracts import UniqueIdentifier, register_contract
        from ..core.contracts import StateAndRef
        from ..core.transactions import (
            SignedTransaction,
            TransactionBuilder,
        )
        from .flows import (
            DUMMY_LINEAR_CONTRACT,
            DummyLinearState,
            _DummyLinearContract,
        )

        register_contract(DUMMY_LINEAR_CONTRACT, _DummyLinearContract())
        self._rng = random.Random(seed)
        self.notary_party = notary_party
        self._contract = DUMMY_LINEAR_CONTRACT
        self._state_cls = DummyLinearState
        self._uid_cls = UniqueIdentifier
        self._sar_cls = StateAndRef
        self._builder_cls = TransactionBuilder
        self._stx_cls = SignedTransaction
        # one well-known key as every synthetic state's owner: states
        # carry participants but nothing signs, and nothing needs to
        owner_kp = schemes.generate_keypair(
            schemes.ECDSA_SECP256R1_SHA256, seed=seed * 31 + 5
        )
        self._owner_key = owner_kp.public
        n_cross = int(count * cross_shard_fraction) // 2
        total = count + n_cross
        self._issues = []
        batch = []
        for i in range(total):
            b = TransactionBuilder(notary_party)
            b.add_output_state(
                DummyLinearState(
                    UniqueIdentifier(seed.to_bytes(8, "big")
                                     + i.to_bytes(8, "big")),
                    f"issue-{i}",
                    self._owner_key,
                ),
                DUMMY_LINEAR_CONTRACT,
            )
            stx = SignedTransaction(b.to_wire_transaction(), ())
            batch.append(stx)
            self._issues.append(stx)
        for m in members:
            m.services.record_transactions(batch)
        # rival() looks issues up by their output ref; build the index
        # ONCE — at 10k+ issues a per-call rebuild would cost millions
        # of dict inserts across a soak's injected double-spends
        self._by_ref = {
            StateRef(issue.id, 0): issue for issue in self._issues
        }
        self._next = 0
        self._cross_budget = n_cross
        self._seq = 0

    def _spend_of(self, issues, info: str):
        b = self._builder_cls(self.notary_party)
        for issue in issues:
            b.add_input_state(
                self._sar_cls(
                    issue.wtx.outputs[0], StateRef(issue.id, 0)
                )
            )
        self._seq += 1
        b.add_output_state(
            self._state_cls(
                self._uid_cls(b"synth-out" + self._seq.to_bytes(7, "big")),
                info,
                self._owner_key,
            ),
            self._contract,
        )
        return self._stx_cls(b.to_wire_transaction(), ())

    def spend(self, client: FleetClient):
        take = 2 if self._cross_budget > 0 and self._next + 1 < len(
            self._issues
        ) and self._rng.random() < 0.5 else 1
        if self._next + take > len(self._issues):
            raise RuntimeError(
                "SyntheticSpendSource exhausted: size the fixture to "
                "the scenario's total interactive offer"
            )
        issues = self._issues[self._next:self._next + take]
        self._next += take
        if take == 2:
            self._cross_budget -= 1
        stx = self._spend_of(issues, f"spend-by-{client.name}")
        return stx, stx.wtx.inputs, stx.id

    def rival(self, inputs: tuple):
        """Contract-valid double spend: the same input refs, a
        different output — a different id claiming the same states."""
        issues = [self._by_ref[ref] for ref in inputs]
        stx = self._spend_of(issues, "rival")
        return stx, stx.wtx.inputs, stx.id


# ---------------------------------------------------------------------------
# the simulator


@dataclass
class FleetReport:
    """Everything the invariant checker (and bench) reads."""

    flavour: str
    scenario: FleetScenario
    records: list
    timeline: list
    chaos_log: list
    ledgers: dict            # member name -> {StateRef: tx_id}
    members: list            # member names, cluster order
    monitors: dict           # member name -> HealthMonitor
    qos: Optional[qoslib.NotaryQos]
    started_micros: int
    finished_micros: int
    bulk_offered: int = 0
    bulk_shed_brownout: int = 0
    bulk_served: int = 0
    distinct_clients: int = 0
    # round-9 fault plane: intent-WAL + verifier-pool reconciliation
    intent_wal: bool = False
    intent_unresolved: int = 0
    intent_replayed: int = 0
    verify_offered: int = 0
    verify_resolved: int = 0
    verify_failed: int = 0
    verify_redispatched: int = 0
    verify_workers_lost: int = 0
    device_faults: int = 0
    degraded_flushes: int = 0
    # round-15 device plane: the end-of-run GET /device-shaped
    # snapshot from the member plane (None when the fault arc never
    # built one) — the telemetry side of the device_fault story
    device_telemetry: Any = None
    # round-17 wire plane: the end-of-run GET /wire-shaped snapshot
    # from the notary's fabric seam (None when the fault arc never
    # built one) — per-link accounting under the same chaos schedule
    wire_telemetry: Any = None
    # round-11 tracing plane: per-member tracers, the cross-node
    # assembler and the incident recorder (None when not enabled)
    tracers: dict = field(default_factory=dict)
    cluster_traces: Any = None
    incidents: Any = None
    # round-13 provenance plane: the shared TxStory lifecycle ledger
    # (None when FleetSim(txstory=True) was not requested) — the
    # lifecycle-ledger reconciliation's input
    txstory: Any = None
    # round-12 distributed uniqueness: the ownership map, the shared
    # decision log (true serialisation order — the serial-replay
    # reference), and end-of-run reservation/orphan depths per member
    # (the reservation-ledger reconciliation inputs)
    cluster_shards: int = 0
    shard_map: dict = field(default_factory=dict)
    xshard_decisions: list = field(default_factory=list)
    reservations_live: dict = field(default_factory=dict)
    xshard_orphans: dict = field(default_factory=dict)

    @property
    def sim_seconds(self) -> float:
        return (self.finished_micros - self.started_micros) / 1e6

    def outcomes(self, kind: Optional[str] = None) -> dict:
        out: dict[str, int] = {}
        for r in self.records:
            if kind is not None and r.kind != kind:
                continue
            out[r.outcome or "?"] = out.get(r.outcome or "?", 0) + 1
        return out


class FleetSim:
    """Scenario engine: one soak = `FleetSim(scenario, flavour,
    chaos=...).run()` -> FleetReport. See the module docstring."""

    def __init__(
        self,
        scenario: FleetScenario,
        flavour: str = "batching",
        chaos: tuple[ChaosEvent, ...] = (),
        cluster_size: Optional[int] = None,
        notary_shards: int = 1,
        qos_policy: Optional[qoslib.QosPolicy] = None,
        heartbeat_deadline_rounds: int = 3,
        lag_alert_threshold: int = 8,
        verifier_pool: int = 0,
        intent_wal: bool = False,
        txstory: bool = False,
        tracing: bool = False,
        incident_dir: Optional[str] = None,
        cluster_shards: int = 8,
        batch_verifier=None,
        spend_source: str = "cash",
        statestore: str = "sqlite",
        statestore_dir: Optional[str] = None,
    ):
        """`verifier_pool` (batching only): attach N out-of-process
        VerifierWorkers on the fabric and an
        OutOfProcessTransactionVerifierService on the notary — one
        spend per round additionally round-trips the pool, so
        kill_verifier() chaos drives the lease/redispatch machinery at
        fleet shape. `intent_wal` (batching only): a NotaryIntentJournal
        under the notary's intake, which is what lets
        kill_notary_mid_flush() complete with ZERO lost admitted
        requests and tightens the checker's loss bound to an equality
        (check_exact_accounting).

        `tracing` (cluster flavours): every member gets its OWN
        enabled Tracer, each submitted request opens a root span whose
        context rides the consensus protocol, and `cluster_traces`
        assembles any request's cross-node tree over a simulated
        /traces pull. `incident_dir`: an IncidentRecorder under it —
        firing member alerts snapshot forensics bundles (assembled
        cross-node traces included when tracing is on) and failed
        reconciliations cite a bundle id."""
        if flavour not in FLAVOURS:
            raise ValueError(f"unknown fleet flavour {flavour!r}")
        if verifier_pool and flavour != "batching":
            raise ValueError("verifier_pool is a batching-flavour seam")
        if intent_wal and flavour not in ("batching", "distributed"):
            raise ValueError(
                "intent_wal needs a batching-notary intake "
                "(batching or distributed flavour)"
            )
        if txstory and flavour != "batching":
            raise ValueError(
                "txstory is a batching-flavour seam (the lifecycle "
                "ledger reconciliation rides the batching intake)"
            )
        # round 19: the distributed flavour can swap its members'
        # committed-state registry from the sqlite tables to the
        # commit-log store (node/statestore.py) — per-member store
        # DIRECTORIES play the role the per-member NodeDatabase plays
        # for sqlite (durable state surviving kill/restart), so
        # restart_member() becomes a real boot replay over segments +
        # snapshot and a joiner can install a member's snapshot file
        # set
        if statestore not in ("sqlite", "commitlog"):
            raise ValueError(
                f"unknown statestore backend {statestore!r} "
                "(sqlite | commitlog)"
            )
        if statestore == "commitlog":
            if flavour != "distributed":
                raise ValueError(
                    "statestore='commitlog' is a distributed-flavour "
                    "seam"
                )
            if not statestore_dir:
                raise ValueError(
                    "statestore='commitlog' needs statestore_dir: the "
                    "per-member store directories must survive "
                    "kill/restart"
                )
        on_card = verifier_on_card(batch_verifier)
        if on_card and any(e.kind == "device_fault" for e in chaos):
            raise ValueError(
                "device_fault chaos needs the notary's degraded fallback, "
                "which the port refuses while the verifier runs on the card "
                "(divergence D2: no flush moves to the CPU); pass a CPU "
                "verifier to soak the degraded-mode arc"
            )
        # D10: off the card the batching notaries serve with the
        # reference's degraded fallback; on the card it stays off (D2)
        self._degraded_fallback = not on_card
        self.statestore = statestore
        self._statestore_dir = statestore_dir
        self._member_stores: dict = {}
        self.scenario = scenario
        self.flavour = flavour
        self.chaos = ChaosPlane(chaos)
        self.faults = FabricFaults(seed=scenario.seed)
        self.net = MockNetwork(
            seed=scenario.seed, faults=self.faults,
            batch_verifier=batch_verifier,
        )
        self.round_no = 0
        self._partitioned: Optional[str] = None
        self._rng = random.Random(scenario.seed ^ 0x5EED)
        scheme = schemes.ECDSA_SECP256R1_SHA256

        # -- per-member tracing (cluster-wide trace assembly) ---------------
        self._tracing = bool(tracing)
        self.tracers: dict[str, tracelib.Tracer] = {}
        self._spans: dict[int, Any] = {}   # rid -> open root span

        def tracer_for(name: str) -> tracelib.Tracer:
            # memoized: a kill/restart rebuild re-attaches the SAME
            # member tracer (the sim's stand-in for a node's recorder
            # surviving in the assembly story). Recorders are sized to
            # the soak: each consensus phase span completes as its own
            # recorder entry, and a 64-deep recent ring would evict a
            # follower's µs-scale spans long before the incident
            # bundle pulls them.
            t = self.tracers.get(name)
            if t is None:
                t = tracelib.Tracer(
                    enabled=True,
                    recorder=tracelib.FlightRecorder(
                        keep_recent=4096, keep_slowest=64
                    ),
                )
                self.tracers[name] = t
            return t

        self._tracer_for = tracer_for

        # -- the cluster ----------------------------------------------------
        if flavour == "batching":
            notary = self.net.create_notary(
                "FleetNotary", batching=True, shards=notary_shards
            )
            self.members = [notary]
            self.service_party = notary.party
            svc = notary.services.notary_service
            svc.degraded_fallback = self._degraded_fallback
            self.qos = qoslib.NotaryQos(
                qos_policy or qoslib.QosPolicy(), clock=self.net.clock
            )
            if notary_shards > 1:
                self.qos.ensure_shards(notary_shards)
            svc.qos = self.qos
            # THE capacity model: the sim's round is the pump tick.
            # MockNetwork.run()'s tick-until-quiescent loop would hand
            # the notary unbounded flushes per simulated instant —
            # infinite hardware, no backlog, no overload, nothing for
            # the QoS plane to do. Pull the tick out of the run loop
            # and drive it ONCE per round instead (the loadtest.md
            # overload-scenario discipline): served depth per round is
            # then the adaptive controller's batch, and sustained
            # over-offer builds the real backlog brownout walks on.
            notary.ticks = [t for t in notary.ticks if t != svc.tick]
            self._drive_tick = svc.tick
        elif flavour == "raft":
            self.service_party, self.members = (
                self.net.create_raft_notary_cluster(
                    cluster_size or 3, scheme_id=scheme,
                    tracer_factory=self._tracer_for if tracing else None,
                )
            )
            self.qos = None
            self._drive_tick = None
            self.net.elect(self.members)
        elif flavour == "bft":
            self.service_party, self.members = (
                self.net.create_bft_notary_cluster(
                    cluster_size or 4, scheme_id=scheme,
                    tracer_factory=self._tracer_for if tracing else None,
                )
            )
            self.qos = None
            self._drive_tick = None
        else:
            # distributed sharded uniqueness (round 12): N members,
            # each a batching notary over a
            # DistributedUniquenessProvider — the state-ref space
            # partitioned ACROSS the members, cross-member commits
            # riding the fabric two-phase reserve→commit under the
            # same FabricFaults plane the chaos events drive. Durable
            # state (store, coordinator WAL, reservation journal,
            # intent WAL) lives on a per-member NodeDatabase that
            # SURVIVES kill/restart, exactly like a real process's
            # sqlite file.
            self.cluster_shards = max(1, int(cluster_shards))
            self.xshard_decisions: list = []
            self._xshard_dbs: dict = {}
            self._xshard_providers: dict = {}
            self._member_intents: dict = {}
            n = cluster_size or 3
            R = scenario.round_micros
            from ..node.distributed_uniqueness import XShardPolicy

            self._xshard_policy = XShardPolicy(
                timeout_micros=4 * R,
                backoff_base_micros=max(R // 4, 1),
                backoff_cap_micros=2 * R,
                reservation_ttl_micros=6 * R,
            )
            member_names = [f"DistNotary-{i}" for i in range(n)]
            # one shared service identity, the raft-cluster discipline:
            # every member holds the cluster key and answers (and
            # signs) for the cluster party the clients name as notary
            shared_kp = schemes.generate_keypair(
                scheme, seed=self._rng.getrandbits(256)
            )
            self.service_party = Party("DistNotary", shared_kp.public)
            self.members = []
            for mname in member_names:
                node = self.net.create_node(mname, scheme_id=scheme)
                node.services.key_management.register_keypair(shared_kp)
                from ..node.persistence import NodeDatabase

                self._xshard_dbs[mname] = NodeDatabase(":memory:")
                node.rebuild_cluster_member = (
                    lambda _node=node, _names=member_names:
                    self._build_distributed_member(
                        _node, _names, wal=intent_wal
                    )
                )
                node.rebuild_cluster_member()
                self.members.append(node)
            self.qos = None
            self._drive_tick = None
        self.alive = {m.name: True for m in self.members}
        self.frozen: set[str] = set()   # wedged-pump members (freeze())

        # -- client identities ----------------------------------------------
        # a small keypair pool shared across many NAMED identities:
        # non-validating notaries record the requester by identity, and
        # admission gates key on the name, so the pool keeps a
        # thousand-client fleet's keygen cost negligible
        pool = [
            schemes.generate_keypair(scheme, seed=scenario.seed * 7919 + k)
            for k in range(max(1, scenario.key_pool))
        ]
        self.clients = [
            FleetClient(
                f"fleet-c{k:04d}", Party(f"fleet-c{k:04d}", pool[k % len(pool)].public)
            )
            for k in range(scenario.clients)
        ]

        # -- traffic source -------------------------------------------------
        if spend_source == "synthetic" and flavour == "distributed":
            # the 10k-identity scale source: command-less unsigned
            # spends (no per-spend ECDSA) with fully real input refs
            self.source = SyntheticSpendSource(
                self.members,
                self.service_party,
                self._interactive_budget(),
                cross_shard_fraction=max(
                    scenario.mix_of(p).cross_shard_fraction
                    for p in scenario.phases
                ),
                seed=scenario.seed,
            )
        elif flavour in ("batching", "distributed"):
            self.source = CashSpendSource(
                self.net,
                self.members[0],
                self._interactive_budget(),
                cross_shard_fraction=max(
                    scenario.mix_of(p).cross_shard_fraction
                    for p in scenario.phases
                ),
                seed=scenario.seed,
                # every distributed member validates: the backchain
                # must resolve wherever the gateway round-robin lands,
                # and transactions name the shared cluster identity
                extra_record_nodes=(
                    self.members[1:] if flavour == "distributed" else ()
                ),
                notary_party=(
                    self.service_party if flavour == "distributed"
                    else None
                ),
            )
        else:
            self.source = TearOffSource(self.service_party, scenario.seed)

        # -- health plane ---------------------------------------------------
        hb_deadline = heartbeat_deadline_rounds * scenario.round_micros
        policy = HealthPolicy(
            heartbeat_deadline_micros=hb_deadline,
            livelock_deadline_micros=4 * hb_deadline,
            alert_for_micros=scenario.round_micros,
            alert_clear_for_micros=scenario.round_micros,
        )
        self.monitors: dict[str, HealthMonitor] = {}
        self._beats = {}
        for m in self.members:
            mon = HealthMonitor(
                clock=self.net.clock, policy=policy,
                # with tracing on, alert evidence cites the member's
                # OWN slowest traces — what the incident bundle's
                # cross-node assembly starts from
                tracer=self.tracers.get(m.name),
            )
            self.monitors[m.name] = mon
            self._beats[m.name] = mon.heartbeat(f"{m.name}.pump")
            if self.flavour in ("raft", "bft"):
                mon.add_rule(
                    AlertRule(
                        "consensus.lag",
                        check=(
                            lambda now, _name=m.name: self._lag_check(
                                _name, lag_alert_threshold
                            )
                        ),
                        for_micros=scenario.round_micros,
                        clear_for_micros=scenario.round_micros,
                        # evidence: traces that actually carry this
                        # flavour's consensus phase spans
                        trace_filter=self.flavour,
                    )
                )
        if flavour == "distributed":
            # per-member serving heartbeat + the distributed-plane
            # rules (shard.unreachable, reservation.orphaned) — so a
            # partitioned owner and an orphaned reservation show in
            # the same alert story the checker reconciles
            for m in self.members:
                m.services.notary_service.attach_health(
                    self.monitors[m.name]
                )
                self._xshard_providers[m.name].attach_health(
                    self.monitors[m.name]
                )
        rollup_home = self.members[0].name
        self.cluster = ClusterHealth(
            rollup_home,
            local_summary=lambda: self.monitors[rollup_home].snapshot(
                summary=True
            ),
            peers_fn=lambda: {
                m.name: f"fleet://{m.name}/health?summary=1"
                for m in self.members
            },
            fetch=self._fetch_peer_summary,
            clock_fn=self.net.clock.now_micros,
            cache_ttl_micros=0,      # every sample is a fresh pull
        )

        # -- cross-node trace assembly + incident forensics -----------------
        self.cluster_traces = None
        if self._tracing:
            home = self.members[0].name
            self.cluster_traces = tracelib.ClusterTraces(
                home,
                self._tracer_for(home),
                peers_fn=lambda: {
                    m.name: f"fleet://{m.name}" for m in self.members
                },
                fetch=self._fetch_peer_traces,
            )
        self.incidents = None
        if incident_dir is not None:
            self.incidents = IncidentRecorder(
                incident_dir,
                clock_fn=self.net.clock.now_micros,
                assemble=(
                    self.cluster_traces.assemble
                    if self.cluster_traces is not None else None
                ),
                chaos_log=lambda: self.chaos.log,
            )
            for m in self.members:
                self.monitors[m.name].attach_incidents(
                    self.incidents, node=m.name
                )

        # -- round-9 fault plane (batching seams) ---------------------------
        self._fault_arc = bool(verifier_pool or intent_wal) or any(
            e.kind in ("kill_verifier", "device_fault", "kill_notary")
            for e in self.chaos.events
        )
        self.device_injector = None
        self.device_plane = None
        self.wire_plane = None
        self.intent_journal = None
        self.verify_pool = None
        self._verify_workers: list = []
        self._verify_worker_alive: list[bool] = []
        self.verify_futures: list = []
        self._notary_down = False
        self._degraded_flushes_base = 0   # carried across notary restarts
        if flavour == "batching" and self._fault_arc:
            notary = self.members[0]
            svc = notary.services.notary_service
            # device-fault seam: the injector IS the installed hub
            # verifier — disarmed it is a passthrough, armed it raises
            # exactly where a real device failure would
            from ..crypto.batch_verifier import DispatchFaultInjector

            self.device_injector = DispatchFaultInjector(
                notary.services.batch_verifier
            )
            notary.services._batch_verifier = self.device_injector
            if intent_wal:
                from ..node.persistence import (
                    NodeDatabase,
                    NotaryIntentJournal,
                )

                self.intent_journal = NotaryIntentJournal(
                    NodeDatabase(":memory:")
                )
                svc.attach_intent_journal(self.intent_journal)
            # flush heartbeat + the degraded-mode alert land on the
            # member's monitor, so kill/device faults show in the same
            # healthz/alert story the checker reconciles
            svc.attach_health(self.monitors[notary.name])
            # device-telemetry plane (round 15): the fleet reads the
            # plane the production node serves at GET /device, so the
            # device_fault chaos events assert the TELEMETRY story too
            # — device.fallback_active fires with device evidence
            # while the degraded flush serves off the CPU reference,
            # and resolves when the recovery probe re-arms the chip.
            # Lambdas read THROUGH to the current notary service: a
            # kill/restart replaces the service object under the same
            # plane.
            from ..utils.device_telemetry import (
                DevicePlane,
                DevicePolicy,
                DeviceSampler,
                host_devices,
            )

            self.device_plane = DevicePlane(
                clock=self.net.clock,
                policy=DevicePolicy(
                    sample_gap_micros=0, live_buffer_census=False
                ),
                # the card's sampler where the notary verifies on it,
                # the host's where it verifies on the CPU (as a node's)
                sampler=(DeviceSampler() if on_card
                         else DeviceSampler(host_devices)),
                install_default_accounting=False,
            )
            self.device_plane.attach_queues(
                [lambda: self._notary_service().backlog()], [None]
            )
            self.device_plane.watch_fallback(
                lambda: self._notary_service().degraded,
                lambda: self._notary_service().degraded_evidence,
            )
            self.monitors[notary.name].watch_device(self.device_plane)
            # wire plane (round 17): the same accounting the node
            # serves at GET /wire, attached to the notary's in-memory
            # fabric seam — the chaos arcs exercise frame/dedupe/
            # backlog bookkeeping under faults, and the wire alerts
            # ride the member's monitor
            from ..utils.wire_telemetry import WirePlane, WirePolicy

            self.wire_plane = WirePlane(
                clock=self.net.clock,
                policy=WirePolicy(sample_gap_micros=0),
            )
            self.wire_plane.attach_fabric(notary.messaging)
            self.monitors[notary.name].watch_wire(self.wire_plane)
            if verifier_pool:
                from ..node.verifier import (
                    OutOfProcessTransactionVerifierService,
                    RedispatchPolicy,
                    VerifierWorker,
                )

                R = scenario.round_micros
                self.verify_pool = OutOfProcessTransactionVerifierService(
                    notary.messaging,
                    clock=self.net.clock,
                    policy=RedispatchPolicy(
                        lease_micros=3 * R,
                        request_timeout_micros=60 * R,
                        backoff_base_micros=max(R // 2, 1),
                        backoff_cap_micros=4 * R,
                        max_attempts=6,
                    ),
                )
                self.verify_pool.watch_health(self.monitors[notary.name])
                for k in range(verifier_pool):
                    ep = self.net.fabric.endpoint(f"fleet-verifier-w{k}")
                    self._verify_workers.append(
                        VerifierWorker(
                            ep,
                            notary.name,
                            # D10: the fleet's verifier (the card by
                            # default), never the injector the notary sees
                            batch_verifier=self.net.batch_verifier,
                            clock=self.net.clock,
                            heartbeat_micros=R,
                        )
                    )
                    self._verify_worker_alive.append(True)
                self.net.run()   # deliver the WorkerReady attaches

        # -- round-13 provenance plane (lifecycle ledger) -------------------
        self.txstory_plane = None
        if txstory:
            from ..utils.txstory import TxStory

            notary = self.members[0]
            svc = notary.services.notary_service
            # the ledger is an OBSERVER that survives kill/restart
            # (like the monitors): sized so a whole soak's stories
            # stay resident for the end-of-run reconciliation
            cap = max(4096, 2 * scenario.total_offered())
            self.txstory_plane = TxStory(
                metrics=svc.metrics,
                clock=self.net.clock,
                max_open=cap,
                keep_done=cap,
            )
            svc.attach_txstory(self.txstory_plane)
            if self.qos is not None:
                self.qos.txstory = self.txstory_plane
            if self.verify_pool is not None:
                self.verify_pool.txstory = self.txstory_plane

        # -- bookkeeping ----------------------------------------------------
        self.records: list[RequestRecord] = []
        self.timeline: list[dict] = []
        self._live: list[list] = []   # [generator, parked _WaitFuture, record]
        self._next_rid = 0
        self._next_uid = 1
        # interactive traffic round-robins the WHOLE fleet: a stream at
        # least `clients` long touches every identity exactly once per
        # lap (rivals draw from a shifted cursor so they never skew it)
        self._client_cursor = 0
        self.bulk_offered = 0
        self.bulk_served = 0

    # -- plumbing ------------------------------------------------------------

    def _build_distributed_member(self, node, member_names, wal=False):
        """(Re)build one distributed-uniqueness member over its
        surviving durable state: a fresh DistributedUniquenessProvider
        + BatchingNotaryService on the member's own NodeDatabase (the
        store, coordinator WAL, reservation journal and intent WAL all
        live there, like a real process's sqlite file). The kill/
        restart seam: recovery re-drives commit-marked intents,
        presumed-aborts the rest, reloads journaled reservations, and
        replays the intent WAL with futures re-attached to
        still-waiting clients by transaction id."""
        from ..node.distributed_uniqueness import (
            DistributedUniquenessProvider,
        )
        from ..node.notary import BatchingNotaryService
        from ..node.persistence import (
            NotaryIntentJournal,
            ShardedPersistentUniquenessProvider,
            XShardCoordinatorJournal,
            XShardReservationJournal,
        )

        db = self._xshard_dbs[node.name]
        old = self._xshard_providers.get(node.name)
        if old is not None:
            old.stop()
        if self.statestore == "commitlog":
            # close the dead incarnation's handles, then reopen the
            # SAME directory: recovery replays manifest + snapshot +
            # segment tail — the boot-replay path, under fleet chaos.
            # Tiny segments so a soak actually seals, compacts and
            # replays multi-segment logs; fsync off matches the
            # simulated-time discipline (writes survive like the
            # per-member NodeDatabase does).
            import os as _os

            from ..node.statestore import (
                ShardedCommitLogUniquenessProvider,
            )

            old_store = self._member_stores.pop(node.name, None)
            if old_store is not None:
                old_store.close()
            store = ShardedCommitLogUniquenessProvider(
                _os.path.join(self._statestore_dir, node.name),
                self.cluster_shards,
                segment_max_records=16,
                compact_min_segments=4,
                fsync=False,
            )
            self._member_stores[node.name] = store
        else:
            store = ShardedPersistentUniquenessProvider(
                db, self.cluster_shards
            )
        provider = DistributedUniquenessProvider(
            node.name,
            member_names,
            node.messaging,
            self.net.clock,
            n_partitions=self.cluster_shards,
            store=store,
            journal=XShardCoordinatorJournal(db),
            reservations=XShardReservationJournal(db),
            policy=self._xshard_policy,
            seed=(self.scenario.seed << 8) ^ (hash(node.name) & 0xFFFF),
            decision_log=self.xshard_decisions,
            tracer=self._tracer_for(node.name) if self._tracing else None,
        )
        self._xshard_providers[node.name] = provider
        journal = self._member_intents.get(node.name)
        if wal and journal is None:
            journal = self._member_intents[node.name] = NotaryIntentJournal(
                db
            )
        old_svc = getattr(node.services, "notary_service", None)
        svc = BatchingNotaryService(
            node.services, provider, intent_journal=journal,
            service_identity=self.service_party,
            degraded_fallback=self._degraded_fallback,
        )
        node.services.notary_service = svc
        node.ticks = [
            t for t in node.ticks
            if getattr(t, "__self__", None) not in (old_svc, old)
        ]
        node.ticks.append(svc.tick)
        node.ticks.append(provider.tick)
        monitor = getattr(self, "monitors", {}).get(node.name)
        if monitor is not None:
            svc.attach_health(monitor)
            provider.attach_health(monitor)
        provider.recover()
        if journal is not None:
            replayed = svc.replay_intents()
            by_tx = {tx_id: fut for _seq, tx_id, fut in replayed}
            for entry in getattr(self, "_live", []):
                gen, _wait, rec = entry
                if gen is None and rec.outcome is None:
                    fut = by_tx.get(rec.tx_id)
                    if fut is not None:
                        entry[1] = fut
        return svc

    def now(self) -> int:
        return self.net.clock.now_micros()

    def _interactive_budget(self) -> int:
        """Upper bound of interactive spends the scenario can ask for
        (sizes the batching cash fixture; rivals reuse rival-builders,
        not fresh issues)."""
        s = self.scenario
        total = 0
        for p in s.phases:
            mix = s.mix_of(p)
            total += p.rounds * max(
                0, p.offered_per_round - int(
                    p.offered_per_round * mix.bulk_fraction
                )
            )
        return total + 2

    def _fetch_peer_summary(self, url: str) -> dict:
        """The /cluster transport, simulated: a down or partitioned-
        away peer is unreachable exactly as HTTP would be."""
        name = url.split("//", 1)[1].split("/", 1)[0]
        home = self.cluster.self_name
        if not self.alive.get(name, False):
            raise ConnectionError(f"{name} is down")
        if self.faults.blocked(home, name) or self.faults.blocked(name, home):
            raise ConnectionError(f"{name} unreachable from {home}")
        return self.monitors[name].snapshot(summary=True)

    def _fetch_peer_traces(self, url: str) -> dict:
        """The /cluster/trace transport, simulated: the peer's filtered
        GET /traces payload, with the same reachability rules as the
        health pull."""
        from urllib.parse import parse_qs, urlparse

        parsed = urlparse(url)
        name = parsed.netloc
        home = self.cluster_traces.self_name
        if not self.alive.get(name, False):
            raise ConnectionError(f"{name} is down")
        if self.faults.blocked(home, name) or self.faults.blocked(name, home):
            raise ConnectionError(f"{name} unreachable from {home}")
        tid = tracelib.parse_trace_id(
            parse_qs(parsed.query).get("trace_id", [None])[0]
        )
        return self._tracer_for(name).export(trace_id=tid)

    def _lag_check(self, name: str, threshold: int):
        lag = self.consensus_lag(name)
        return lag is not None and lag > threshold, {"lag": lag}

    def consensus_lag(self, name: str) -> Optional[int]:
        """How far member `name`'s applied state trails the fleet's
        front — entries for raft, executed sequence numbers for BFT."""
        node = next(m for m in self.members if m.name == name)
        if self.flavour == "raft":
            front = max(
                m.raft.commit_index
                for m in self.members
                if self.alive[m.name]
            )
            return front - node.raft.last_applied
        if self.flavour == "bft":
            front = max(
                m.bft.exec_seq for m in self.members if self.alive[m.name]
            )
            return front - node.bft.exec_seq
        return None

    # -- chaos actions (called by ChaosEvents) --------------------------------

    def kill_member(self, idx: int) -> None:
        if self.flavour == "batching":
            raise ValueError(
                "kill_restart needs a cluster flavour (raft/bft/"
                "distributed): the batching sim is single-node — use "
                "freeze() for the wedged-pump fault"
            )
        node = self.members[idx]
        self.faults.kill(node.name)
        node.messaging.running = False
        if self.flavour == "distributed":
            # process death mid-serving: queued-but-unflushed requests
            # die with the heap, in-flight coordinator state machines
            # die (their WAL survives), unflushed intent-WAL
            # resolutions die (those intents replay + dedupe), and the
            # member stops ticking — the durable NodeDatabase is the
            # only thing that survives, like a real sqlite file
            svc = node.services.notary_service
            svc._pending.clear()
            journal = self._member_intents.get(node.name)
            if journal is not None:
                journal.lose_unflushed_resolutions()
            provider = self._xshard_providers[node.name]
            provider.stop()
            node.ticks = [
                t for t in node.ticks
                if getattr(t, "__self__", None) not in (svc, provider)
            ]
        if getattr(node, "raft", None) is not None:
            node.raft.stop()
        if getattr(node, "bft", None) is not None:
            node.bft.stop()
        self.alive[node.name] = False

    def restart_member(self, idx: int) -> None:
        """Boot a replacement state machine over the same endpoint: the
        consensus layer restores it (AppendEntries/InstallSnapshot for
        raft, checkpoint catch-up for BFT, WAL recovery + intent
        replay for the distributed uniqueness plane); the endpoint's
        dedupe set absorbs frames redelivered across the outage."""
        node = self.members[idx]
        rebuild = getattr(node, "rebuild_cluster_member", None)
        if rebuild is None:
            raise ValueError(
                f"{node.name} is not a cluster member — only cluster "
                f"members carry a rebuild seam"
            )
        old = getattr(node, "raft", None) or getattr(node, "bft", None)
        if old is not None:
            node.ticks = [
                t for t in node.ticks
                if getattr(t, "__self__", None) is not old
            ]
        # revive the endpoint BEFORE recovery: the rebuild's WAL
        # re-drives send protocol frames that must queue for delivery
        node.messaging.running = True
        self.faults.revive(node.name)
        rebuild()
        self.alive[node.name] = True
        # a restarted process reports live from its first pump
        self._beats[node.name].beat()

    # -- round-9 fault-plane actions ------------------------------------------

    def _notary_service(self):
        """The CURRENT batching notary service — read through on every
        call, so the device plane's fallback/backlog lambdas survive a
        kill_notary/restart_notary swap of the service object."""
        return self.members[0].services.notary_service

    def _worker_name(self, idx: int) -> str:
        return f"fleet-verifier-w{idx}"

    def kill_verifier_worker(self, idx: int) -> None:
        """SIGKILL one pool worker mid-batch: its endpoint stops
        pumping and the fault plane blackholes it — the node-side lease
        expires, the worker detaches, and its in-flight nonces
        re-dispatch to a survivor."""
        if self.verify_pool is None:
            raise ValueError(
                "kill_verifier needs FleetSim(verifier_pool=N>=2)"
            )
        name = self._worker_name(idx)
        self.faults.kill(name)
        self.net.fabric.endpoint(name).running = False
        self._verify_worker_alive[idx] = False

    def revive_verifier_worker(self, idx: int) -> None:
        """Bring a killed worker back under the SAME name: revive the
        endpoint and re-announce WorkerReady. Answers it computed
        before the kill were re-dispatched away in the meantime; the
        attempt binding rejects them as a stale incarnation."""
        name = self._worker_name(idx)
        self.faults.revive(name)
        self.net.fabric.endpoint(name).running = True
        self._verify_worker_alive[idx] = True
        self._verify_workers[idx]._send_ready()

    def inject_device_fault(self, flushes: int = 2) -> None:
        """Arm the dispatch-seam injector: the next `flushes` verify
        dispatches raise a DeviceFaultError; after that the device
        path serves again (which is what the notary's recovery probe
        re-arms on)."""
        if self.device_injector is None:
            raise ValueError(
                "device_fault needs the batching flavour (the injector "
                "wraps the notary hub's batch verifier)"
            )
        self.device_injector.arm(flushes)

    def kill_notary(self) -> None:
        """Process death for the single-node batching notary, mid
        serving: every queued-but-unflushed request vanishes with the
        heap, the journal's unflushed resolution buffer is lost (those
        intents will REPLAY and dedupe), and the pump freezes — the
        watchdog flips healthz exactly as a real crash would."""
        if self.flavour == "distributed":
            # the distributed fleet's "kill the notary mid-flush" is a
            # full member kill of the round-robin home member — the
            # coordinator most in-flight cross-shard reserves ran on
            self.kill_member(0)
            return
        if self.flavour != "batching":
            raise ValueError("kill_notary is the batching-flavour crash")
        node = self.members[0]
        svc = node.services.notary_service
        if getattr(svc, "_shards", None) is not None:
            for shard in svc._shards:
                with shard.cond:
                    shard.pending.clear()
        else:
            svc._pending.clear()
        if self.intent_journal is not None:
            self.intent_journal.lose_unflushed_resolutions()
        self.frozen.add(node.name)
        self._notary_down = True

    def restart_notary(self) -> None:
        """Boot a replacement notary over the same durable state (the
        uniqueness provider and intent WAL survive the process), replay
        unresolved intents through its normal flush path, and re-attach
        every still-waiting client future to its replayed twin by
        transaction id — the restarted service answers requests the
        dead one admitted."""
        from ..node.notary import BatchingNotaryService

        if self.flavour == "distributed":
            self.restart_member(0)
            return
        node = self.members[0]
        old = node.services.notary_service
        self._degraded_flushes_base += _metric_count(
            old.metrics, "Notary.DegradedFlushes"
        )
        had_workers = bool(old._workers)
        old.stop()   # dead worker threads must not keep flushing
        svc = BatchingNotaryService(
            node.services,
            old.uniqueness,
            max_batch=old.max_batch,
            max_wait_micros=old.max_wait_micros,
            qos=self.qos,
            # the replacement boots with the SAME plane shape the dead
            # process ran — a sharded scenario must stay sharded or the
            # post-restart half of the soak tests a different notary
            shards=old.n_shards,
            shard_workers=had_workers,
            degraded_fallback=old.degraded_fallback,
            intent_journal=self.intent_journal,
        )
        node.services.notary_service = svc
        self._drive_tick = svc.tick
        svc.attach_health(self.monitors[node.name])
        # the lifecycle ledger survives the restart (observer plane):
        # attach BEFORE replay so every replayed intent stamps its
        # wal.replay event onto the story the dead process admitted
        svc.attach_txstory(self.txstory_plane)
        replayed = svc.replay_intents()
        by_tx = {tx_id: fut for _seq, tx_id, fut in replayed}
        for entry in self._live:
            gen, _wait, rec = entry
            if gen is None and rec.outcome is None:
                fut = by_tx.get(rec.tx_id)
                if fut is not None:
                    entry[1] = fut
        self.frozen.discard(node.name)
        self._notary_down = False
        self._beats[node.name].beat()

    # -- submission ----------------------------------------------------------

    def _gateway(self, k: int):
        alive = [m for m in self.members if self.alive[m.name]]
        return alive[k % len(alive)]

    def _submit(self, client, kind, phase, deadline, payload, rival_of=None):
        ftx, inputs, tx_id = payload
        member = self._gateway(self._next_rid)
        rec = RequestRecord(
            rid=self._next_rid,
            client=client.name,
            tx_id=tx_id,
            inputs=tuple(inputs),
            kind=kind,
            phase=phase,
            member=member.name,
            deadline=deadline,
            submitted_at=self.now(),
            rival_of=rival_of,
        )
        self._next_rid += 1
        self.records.append(rec)
        if self.flavour in ("batching", "distributed"):
            # the embedded-driver entry: enqueue without the flow
            # machinery (the flow-path entry gates are pinned by
            # tests/test_qos.py; here the round-rationed tick IS the
            # capacity model, and process()'s flush-at-full-batch
            # fast path would defeat it in zero-cost simulated time)
            fut = member.services.notary_service.submit(
                ftx, client.party,
                deadline=deadline, arrival_micros=self.now(),
            )
            self._live.append([None, fut, rec])
        else:
            trace = None
            if self._tracing:
                # the trace is born at the gateway member (the fleet's
                # stand-in for the client node): a root span whose
                # context the consensus layer threads to every member
                span = self._tracer_for(member.name).start_trace(
                    "notarise.fleet",
                    tx_id=str(tx_id), requester=client.name,
                )
                self._spans[rec.rid] = span
                rec.trace_id = span.trace_id
                trace = tuple(span.context)
            gen = member.services.notary_service.process(
                ftx, client.party, deadline=deadline, trace=trace
            )
            self._live.append([gen, None, rec])
        client.submitted += 1
        return rec

    def _inject_round(self, phase: Phase) -> None:
        s = self.scenario
        mix = s.mix_of(phase)
        n_bulk = int(phase.offered_per_round * mix.bulk_fraction)
        n_interactive = phase.offered_per_round - n_bulk
        now = self.now()
        for i in range(n_interactive):
            client = self.clients[self._client_cursor % len(self.clients)]
            self._client_cursor += 1
            jitter = (
                self._rng.randrange(mix.deadline_jitter_micros + 1)
                if mix.deadline_jitter_micros else 0
            )
            deadline = now + mix.deadline_micros + jitter
            payload = self.source.spend(client)
            if self.verify_pool is not None and i == 0:
                # one spend per round additionally round-trips the
                # out-of-process pool (the verification sidecar the
                # kill_verifier chaos acts on): EVERY one of these
                # futures must resolve, worker churn or not
                stx = payload[0]
                ltx = self.source.owner.services.resolve_transaction(
                    stx.wtx
                )
                self.verify_futures.append(
                    self.verify_pool.verify(ltx, stx)
                )
            rec = self._submit(client, "interactive", phase.name, deadline, payload)
            # deterministic injection: every floor(1/fraction)-th spend
            # gets a rival, so the double-spend count never flakes
            if mix.conflict_fraction and (
                self._next_rid % max(1, round(1 / mix.conflict_fraction)) == 0
            ):
                rival_client = self.clients[
                    (self._next_rid * 31 + 7) % len(self.clients)
                ]
                self._submit(
                    rival_client, "rival", phase.name, deadline,
                    self.source.rival(payload[1]), rival_of=rec.rid,
                )
        for _ in range(n_bulk):
            self._offer_bulk(phase)

    def _offer_bulk(self, phase: Phase) -> None:
        """Bulk (resolution-flood-shaped) traffic enters at the QoS
        lane seam — deadline-less by definition, so brownout level 1
        sheds it there. Batching flavour only."""
        if self.qos is None:
            return
        client = self.clients[self._rng.randrange(len(self.clients))]
        self.bulk_offered += 1
        self._next_uid += 1
        self.qos.lanes.offer(
            Message("tx.resolution", b"", client.name, self._next_uid)
        )

    # -- the loop ------------------------------------------------------------

    def _step_generators(self) -> None:
        from ..flows.api import _WaitFuture

        still = []
        for entry in self._live:
            gen, wait, rec = entry
            if gen is None:
                # future-parked (batching submit path)
                if wait.done:
                    try:
                        self._record_answer(rec, wait.result())
                    except Exception as e:   # noqa: BLE001
                        self._record_answer(
                            rec, NotaryError("unavailable", repr(e))
                        )
                else:
                    still.append(entry)
                continue
            try:
                if wait is None:
                    step = gen.send(None)
                elif wait.future.done:
                    try:
                        value = wait.future.result()
                    except Exception as e:   # noqa: BLE001 - flow-shaped
                        step = gen.throw(e)
                    else:
                        step = gen.send(value)
                else:
                    still.append(entry)
                    continue
                if isinstance(step, _WaitFuture):
                    entry[1] = step
                    still.append(entry)
                else:
                    # notary process() generators only ever park on
                    # futures; anything else is a service bug
                    gen.close()
                    self._record_answer(
                        rec,
                        NotaryError(
                            "unavailable", f"unexpected yield {step!r}"
                        ),
                    )
            except StopIteration as stop:
                self._record_answer(rec, stop.value)
            except Exception as e:   # noqa: BLE001 - service-side failure
                self._record_answer(
                    rec, NotaryError("unavailable", repr(e))
                )
        self._live = still

    def _record_answer(self, rec: RequestRecord, value) -> None:
        rec.answered_at = self.now()
        span = self._spans.pop(rec.rid, None)
        if span is not None:
            span.end()
        if isinstance(value, NotaryError):
            if value.kind == qoslib.SHED_KIND:
                rec.outcome = OUT_SHED
                # ONE canonicalizer (utils/txstory.shed_reason): the
                # model's attribution and the ledger's terminal reason
                # derive from the same function, so a reworded shed
                # message cannot fork the reconciliation
                from ..utils.txstory import shed_reason

                rec.shed_reason = shed_reason(value.message)
            elif value.kind == "conflict":
                rec.outcome = OUT_CONFLICT
            else:
                rec.outcome = OUT_UNAVAILABLE
                rec.shed_reason = value.kind
        elif value is None:
            rec.outcome = OUT_UNAVAILABLE
        else:
            # TransactionSignature (simple/raft) or [sigs] (bft)
            rec.outcome = OUT_SIGNED

    def _sample(self, phase_name: str) -> None:
        healthz = {}
        alerts = {}
        for name, mon in self.monitors.items():
            if self.alive[name]:
                ok, _ = mon.healthz()
                healthz[name] = ok
                alerts[name] = mon.alerts_firing()
            else:
                healthz[name] = False     # a dead node serves nothing
                alerts[name] = None
        rollup = self.cluster.snapshot()
        self.timeline.append({
            "round": self.round_no,
            "at_micros": self.now(),
            "phase": phase_name,
            "healthz": healthz,
            "alerts_firing": alerts,
            "cluster_worst": rollup["worst"],
            "cluster_stale": rollup["stale_peers"],
            "cluster_alerts": rollup["alerts_firing"],
            "brownout_level": (
                self.qos.brownout_level if self.qos is not None else None
            ),
            "lag": {
                m.name: self.consensus_lag(m.name) for m in self.members
            } if self.flavour != "batching" else {},
        })

    def _round(self, phase_name: str) -> None:
        self._step_generators()
        if self._drive_tick is not None and (
            self.members[0].name not in self.frozen
        ):
            # the batching notary's pump tick, exactly once per round
            # (see __init__: the round IS the pump cadence); a frozen
            # pump flushes nothing — requests queue, and anything whose
            # deadline passes while wedged sheds at the thaw
            self._drive_tick()
        self.net.run()
        if self.verify_pool is not None:
            # worker pump round: drain (which heartbeats), deliver the
            # answers, then walk the pool's lease/redispatch state
            for alive, w in zip(
                self._verify_worker_alive, self._verify_workers
            ):
                if alive:
                    w.drain()
            self.net.run()
            self.verify_pool.tick()
        self._step_generators()
        if self.qos is not None:
            # the lane consumer: drain what a real ring consumer would
            self.bulk_served += len(self.qos.lanes.drain(budget=64))
        for name, hb in self._beats.items():
            if self.alive[name] and name not in self.frozen:
                hb.beat(progress=1)
        if self.device_plane is not None and (
            self.alive[self.members[0].name] and not self._notary_down
        ):
            # sample BEFORE the monitor walk so the device rules judge
            # this round's state (sample_gap 0: every round samples)
            self.device_plane.tick()
        if self.wire_plane is not None and (
            self.alive[self.members[0].name] and not self._notary_down
        ):
            self.wire_plane.tick()
        for name, mon in self.monitors.items():
            if self.alive[name]:
                mon.tick()
        self._sample(phase_name)
        self.net.clock.advance(self.scenario.round_micros)
        self.round_no += 1

    def run(self) -> FleetReport:
        s = self.scenario
        started = self.now()
        total = float(s.total_offered())
        offered = 0
        for phase in s.phases:
            for _ in range(phase.rounds):
                self.chaos.step(self, offered / total)
                self._inject_round(phase)
                offered += phase.offered_per_round
                self._round(phase.name)
        self.chaos.finish(self)
        for _ in range(s.drain_rounds):
            self._round("drain")
            if not self._live:
                break
        for gen, wait, rec in self._live:
            rec.outcome = OUT_LOST
            span = self._spans.pop(rec.rid, None)
            if span is not None:
                span.end()
        self._live = []
        for _ in range(s.settle_rounds):
            self._round("settle")
        shed_brownout = 0
        if self.qos is not None:
            shed_brownout = self.qos.snapshot()["shed"].get(
                qoslib.SHED_BROWNOUT_BULK, 0
            )
        verify_resolved = verify_failed = 0
        for fut in self.verify_futures:
            if fut.done:
                try:
                    fut.result()
                    verify_resolved += 1
                except Exception:   # noqa: BLE001 - reconciled below
                    verify_failed += 1
        intent_unresolved = intent_replayed = 0
        if self.intent_journal is not None:
            self.intent_journal.flush_resolved()
            intent_unresolved = self.intent_journal.unresolved_count
            intent_replayed = self.intent_journal.replayed
        has_member_wals = bool(getattr(self, "_member_intents", None))
        if has_member_wals:
            for j in self._member_intents.values():
                j.flush_resolved()
                intent_unresolved += j.unresolved_count
                intent_replayed += j.replayed
        xshard_extra = {}
        if self.flavour == "distributed":
            from ..node.distributed_uniqueness import ShardMap

            sm = ShardMap(
                [m.name for m in self.members], self.cluster_shards
            )
            xshard_extra = dict(
                cluster_shards=self.cluster_shards,
                shard_map={
                    row["partition"]: row["owner"]
                    for row in sm.snapshot()["partitions"]
                },
                xshard_decisions=list(self.xshard_decisions),
                reservations_live={
                    name: p.reservation_count()
                    for name, p in self._xshard_providers.items()
                },
                xshard_orphans={
                    name: p.orphan_count()
                    for name, p in self._xshard_providers.items()
                },
            )
        pool = self.verify_pool
        svc = self.members[0].services.notary_service
        return FleetReport(
            flavour=self.flavour,
            scenario=s,
            records=self.records,
            timeline=self.timeline,
            chaos_log=self.chaos.log,
            ledgers=self.gather_ledgers(),
            members=[m.name for m in self.members],
            monitors=dict(self.monitors),
            qos=self.qos,
            started_micros=started,
            finished_micros=self.now(),
            bulk_offered=self.bulk_offered,
            bulk_shed_brownout=shed_brownout,
            bulk_served=self.bulk_served,
            distinct_clients=len(
                {r.client for r in self.records}
            ),
            intent_wal=self.intent_journal is not None or has_member_wals,
            intent_unresolved=intent_unresolved,
            intent_replayed=intent_replayed,
            verify_offered=len(self.verify_futures),
            verify_resolved=verify_resolved,
            verify_failed=verify_failed,
            verify_redispatched=(
                _metric_count(pool.metrics, "Verifier.Redispatched")
                if pool is not None else 0
            ),
            verify_workers_lost=(
                _metric_count(pool.metrics, "Verifier.WorkersLost")
                if pool is not None else 0
            ),
            device_faults=(
                self.device_injector.faults_raised
                if self.device_injector is not None else 0
            ),
            degraded_flushes=(
                self._degraded_flushes_base
                + _metric_count(svc.metrics, "Notary.DegradedFlushes")
                if self.flavour == "batching" else 0
            ),
            device_telemetry=(
                self.device_plane.snapshot()
                if self.device_plane is not None else None
            ),
            wire_telemetry=(
                self.wire_plane.snapshot()
                if self.wire_plane is not None else None
            ),
            tracers=dict(self.tracers),
            cluster_traces=self.cluster_traces,
            incidents=self.incidents,
            txstory=self.txstory_plane,
            **xshard_extra,
        )

    # -- reconciliation inputs ----------------------------------------------

    def gather_ledgers(self) -> dict:
        """Every ALIVE member's committed map (the reference's
        gather-state step). Batching reads the uniqueness provider;
        raft reads each member's replicated provider map; BFT reads
        each replica's service map."""
        out = {}
        for m in self.members:
            if not self.alive[m.name]:
                continue
            svc = m.services.notary_service
            if self.flavour == "bft":
                out[m.name] = dict(svc.committed)
            else:
                out[m.name] = dict(svc.uniqueness.committed)
        return out


# ---------------------------------------------------------------------------
# invariant checking


class InvariantChecker:
    """Reconciles a FleetReport against the model: the CrossCash
    discipline (value neither lost nor duplicated), extended with the
    control-plane truth checks the ROADMAP calls for. Each method
    raises AssertionError with enough detail to debug; `check_all`
    runs the set that applies to the report's flavour."""

    def __init__(self, report: FleetReport):
        self.report = report

    # -- ledger --------------------------------------------------------------

    def check_replica_agreement(self) -> None:
        """Every alive replica holds the SAME committed map after the
        drain — kill/restart, partition and slow links included."""
        ledgers = self.report.ledgers
        names = sorted(ledgers)
        base = ledgers[names[0]]
        for name in names[1:]:
            if ledgers[name] != base:
                only_a = set(base) - set(ledgers[name])
                only_b = set(ledgers[name]) - set(base)
                raise AssertionError(
                    f"replica ledgers diverged: {names[0]} has "
                    f"{len(base)} entries, {name} has "
                    f"{len(ledgers[name])}; only-{names[0]}={only_a!r} "
                    f"only-{name}={only_b!r}"
                )

    def _ledger(self) -> dict:
        if self.report.flavour == "distributed":
            # the cluster ledger is the UNION of the members' partition
            # slices; a ref claimed by two members with different
            # consumers is a partition-ownership breach, surfaced here
            # before any downstream check trips on it confusingly
            merged: dict = {}
            claimed_by: dict = {}
            for name in sorted(self.report.ledgers):
                for ref, tx in self.report.ledgers[name].items():
                    prior = merged.get(ref)
                    assert prior is None or prior == tx, (
                        f"{ref} committed to {prior} on "
                        f"{claimed_by[ref]} but {tx} on {name} — two "
                        f"members both think they own the ref"
                    )
                    merged[ref] = tx
                    claimed_by[ref] = name
            return merged
        names = sorted(self.report.ledgers)
        return self.report.ledgers[names[0]]

    def check_ledger_vs_answers(self) -> None:
        """Signed answers and the ledger agree EXACTLY:
        - every signed tx's inputs are consumed by that tx on-ledger;
        - every conflict answer's tx is NOT on the ledger;
        - every on-ledger consumer is a transaction somebody submitted
          (no phantom commits);
        - no input consumed by two transactions (no double-spend)."""
        ledger = self._ledger()
        submitted = {r.tx_id for r in self.report.records}
        for ref, tx in ledger.items():
            assert tx in submitted, (
                f"phantom commit: {ref} consumed by never-submitted {tx}"
            )
        for r in self.report.records:
            if r.outcome == OUT_SIGNED:
                for ref in r.inputs:
                    got = ledger.get(ref)
                    assert got == r.tx_id, (
                        f"signed {r.tx_id} but ledger consumes {ref} "
                        f"by {got}"
                    )
            elif r.outcome == OUT_CONFLICT:
                on_ledger = [
                    ref for ref in r.inputs if ledger.get(ref) == r.tx_id
                ]
                assert not on_ledger, (
                    f"conflict answered for {r.tx_id} yet it consumed "
                    f"{on_ledger} on-ledger"
                )
            elif r.outcome == OUT_SHED:
                committed = [
                    ref for ref in r.inputs if ledger.get(ref) == r.tx_id
                ]
                assert not committed, (
                    f"shed {r.tx_id} still committed {committed} — a "
                    f"shed must never spend verify/commit work"
                )

    def check_exactly_one_winner(self) -> None:
        """Every injected double-spend resolved to EXACTLY one winner
        on the ledger, and at most one of the rivals was signed."""
        ledger = self._ledger()
        by_rid = {r.rid: r for r in self.report.records}
        pairs = [
            (by_rid[r.rival_of], r)
            for r in self.report.records
            if r.rival_of is not None
        ]
        assert pairs, "scenario injected no double-spends to check"
        for orig, rival in pairs:
            contested = set(orig.inputs) & set(rival.inputs)
            assert contested, "rival shares no input with its original"
            for ref in contested:
                winner = ledger.get(ref)
                # both shed is legal (overload); both COMMITTED is not
                assert winner in (orig.tx_id, rival.tx_id, None), (
                    f"{ref} consumed by a third transaction {winner}"
                )
            signed = [
                r for r in (orig, rival) if r.outcome == OUT_SIGNED
            ]
            assert len(signed) <= 1, (
                f"double-spend double-signed: {orig.tx_id} AND "
                f"{rival.tx_id}"
            )

    # -- QoS -----------------------------------------------------------------

    def check_no_admitted_then_expired(self) -> None:
        """A signed answer at or before its deadline, always — nothing
        verified-then-useless."""
        for r in self.report.records:
            if r.outcome == OUT_SIGNED and r.deadline is not None:
                assert r.answered_at <= r.deadline, (
                    f"admitted-then-expired: {r.tx_id} signed at "
                    f"{r.answered_at}, deadline {r.deadline}"
                )

    def check_slo(
        self, target_p99_micros: int, phases: tuple[str, ...] = ("steady",)
    ) -> None:
        """Admitted p99 (simulated time) within the SLO for requests
        submitted during the named phases."""
        lat = sorted(
            r.answered_at - r.submitted_at
            for r in self.report.records
            if r.outcome == OUT_SIGNED
            and any(r.phase.startswith(p) for p in phases)
        )
        assert lat, f"no signed steady-state traffic in phases {phases}"
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        assert p99 <= target_p99_micros, (
            f"steady-state admitted p99 {p99} us exceeds the "
            f"{target_p99_micros} us SLO"
        )

    def check_brownout_classes(self) -> None:
        """Brownout shed ONLY the right traffic: bulk at the lane seam
        and deadline-less requests at entry — never an interactive
        request that carried a deadline."""
        for r in self.report.records:
            if r.shed_reason == "brownout":
                assert r.deadline is None, (
                    f"brownout shed deadline-carrying {r.kind} request "
                    f"{r.tx_id}"
                )
        qos = self.report.qos
        assert qos is not None, "brownout check needs the QoS flavour"
        shed = qos.snapshot()["shed"]
        brownout_sheds = {
            k: v for k, v in shed.items() if k.startswith("Brownout")
        }
        assert set(brownout_sheds) <= {
            qoslib.SHED_BROWNOUT_BULK, qoslib.SHED_BROWNOUT_NO_DEADLINE
        }
        assert brownout_sheds, "the spike browned nothing out"

    def check_brownout_engaged_during_spike(self) -> None:
        """The brownout level rose during the spike phase and returned
        to 0 by the end of the drain (the transition history is the
        assertion surface, node/qos.py)."""
        spike = [
            t for t in self.report.timeline if t["phase"].startswith("spike")
        ]
        after = self.report.timeline[-1]
        assert any(t["brownout_level"] >= 1 for t in spike), (
            "brownout never engaged during the spike"
        )
        assert after["brownout_level"] == 0, (
            f"brownout stuck at level {after['brownout_level']} after "
            f"recovery"
        )
        assert self.report.qos.brownout_transitions, (
            "no brownout transitions recorded"
        )

    # -- health truth --------------------------------------------------------

    def _window(self, entry: dict) -> tuple[int, Optional[int]]:
        return entry["applied_at_micros"], entry["reverted_at_micros"]

    def _alert_of(self, member: str, name: str) -> Optional[dict]:
        mon = self.report.monitors.get(member)
        if mon is None:
            return None
        return mon.snapshot().get("alerts", {}).get(name)

    def _samples_between(self, start, end):
        return [
            t for t in self.report.timeline
            if t["at_micros"] >= start and (
                end is None or t["at_micros"] < end
            )
        ]

    def check_health_story(self) -> None:
        """The control plane told the truth about every injected fault:

          kill      — the victim read unhealthy and /cluster marked it
                      stale while down; both recovered after restart.
          freeze    — the victim's WATCHDOG flipped its healthz to
                      unhealthy while its pump was wedged (the node
                      was still reachable — this is the true 503
                      path), and it recovered after the thaw.
          partition — /cluster (served from the majority side) marked
                      the minority member stale during the split and
                      fresh after heal.
          slow      — the victim's consensus-lag alert fired during
                      the window and resolved after.
        """
        tl = self.report.timeline
        assert tl, "no timeline samples"
        final = tl[-1]
        for entry in self.report.chaos_log:
            start, end = self._window(entry)
            during = self._samples_between(start, end)
            victim = entry.get("target")
            if entry["kind"] == "kill":
                assert during, f"no samples during {entry['name']}"
                assert any(
                    not t["healthz"].get(victim, True) for t in during
                ), f"{entry['name']}: victim {victim} never read unhealthy"
                if victim == self.report.members[0]:
                    # the rollup is SERVED from the victim: a dead home
                    # cannot mark itself stale — the outage shows as
                    # everyone ELSE going stale in its view
                    assert any(t["cluster_stale"] for t in during), (
                        f"{entry['name']}: the dead rollup home's "
                        f"/cluster never lost its peers"
                    )
                else:
                    assert any(
                        victim in t["cluster_stale"] for t in during
                    ), (
                        f"{entry['name']}: /cluster never marked "
                        f"{victim} stale"
                    )
            elif entry["kind"] == "freeze":
                assert any(
                    not t["healthz"].get(victim, True) for t in during
                ), (
                    f"{entry['name']}: the watchdog never flipped "
                    f"{victim}'s healthz while its pump was wedged"
                )
                # the victim's own event log carries the flip — the
                # health plane's forensic surface (utils/health.py)
                events = [
                    e for e in self.report.monitors[victim].events.tail(64)
                    if e.get("event") == "healthz"
                ] if self.report.monitors else []
                if self.report.monitors:
                    assert any(not e["ok"] for e in events), (
                        f"{victim}'s health event log never recorded "
                        f"the healthz flip"
                    )
            elif entry["kind"] == "partition":
                if victim == self.report.members[0]:
                    # the rollup is SERVED from the victim: the split
                    # shows as everyone ELSE going stale in its view
                    assert any(t["cluster_stale"] for t in during), (
                        f"{entry['name']}: the minority-side /cluster "
                        f"never marked the majority stale"
                    )
                else:
                    assert any(
                        victim in t["cluster_stale"] for t in during
                    ), (
                        f"{entry['name']}: /cluster never marked the "
                        f"minority {victim} stale"
                    )
            elif entry["kind"] == "slow":
                assert any(
                    (t["cluster_alerts"].get(victim) or 0) > 0
                    or (t["alerts_firing"].get(victim) or 0) > 0
                    for t in during
                ), (
                    f"{entry['name']}: the lag alert never fired for "
                    f"{victim}"
                )
            elif entry["kind"] == "kill_notary":
                # a dead pump is a stalled flush heartbeat: the
                # watchdog must flip healthz while the notary is down
                assert any(
                    not t["healthz"].get(victim, True) for t in during
                ), (
                    f"{entry['name']}: healthz never flipped while the "
                    f"notary was dead"
                )
            elif entry["kind"] == "device_fault":
                # the monitor's fire_count is authoritative unless a
                # notary restart re-registered the rule (wiping its
                # state); the timeline's per-round alert samples carry
                # the firing either way
                alert = self._alert_of(victim, "notary.degraded_mode")
                fired = (
                    alert is not None and alert["fire_count"] >= 1
                ) or any(
                    (t["alerts_firing"].get(victim) or 0) > 0
                    for t in during
                )
                assert fired, (
                    f"{entry['name']}: notary.degraded_mode never fired"
                )
                assert alert is None or alert["state"] != "firing", (
                    f"{entry['name']}: degraded mode never auto-"
                    f"resolved (the recovery probe is not re-arming "
                    f"the device path)"
                )
                # round 15: the device-telemetry plane must tell the
                # SAME story — device.fallback_active bridges the
                # degraded gauge with device evidence, fires while the
                # flushes serve off the CPU reference, and resolves
                # with the probe
                dev_alert = self._alert_of(
                    victim, "device.fallback_active"
                )
                if dev_alert is not None:
                    assert dev_alert["fire_count"] >= 1, (
                        f"{entry['name']}: device.fallback_active "
                        f"never fired while the notary served "
                        f"degraded flushes"
                    )
                    assert dev_alert["state"] != "firing", (
                        f"{entry['name']}: device.fallback_active "
                        f"never resolved after the device path "
                        f"recovered"
                    )
                if self.report.device_telemetry is not None:
                    assert not self.report.device_telemetry[
                        "fallback_active"
                    ], (
                        f"{entry['name']}: the device plane still "
                        f"reports fallback_active at the end of the "
                        f"soak"
                    )
            elif entry["kind"] == "kill_verifier":
                alert = self._alert_of(victim, "verifier.pool_degraded")
                assert alert is not None and alert["fire_count"] >= 1, (
                    f"{entry['name']}: verifier.pool_degraded never "
                    f"fired on the worker loss"
                )
                assert alert["state"] != "firing", (
                    f"{entry['name']}: the pool never recovered "
                    f"(pool_degraded still firing at the end)"
                )
            # recovery: the LAST sample shows a clean fleet
            if victim is not None:
                assert final["healthz"].get(victim, False), (
                    f"{victim} still unhealthy after {entry['name']} "
                    f"reverted"
                )
                assert victim not in final["cluster_stale"], (
                    f"/cluster still stale on {victim} after "
                    f"{entry['name']} reverted"
                )

    def check_lost_bounded(self, max_fraction: float = 0.05) -> None:
        """WITHOUT the intent WAL, requests in flight at a kill may
        lose their reply; the fraction must stay small and the ledger
        invariants above already bound their effect. (With the WAL,
        check_exact_accounting replaces this allowance with an
        equality — check_all picks automatically.)"""
        lost = sum(1 for r in self.report.records if r.outcome == OUT_LOST)
        frac = lost / max(1, len(self.report.records))
        assert frac <= max_fraction, (
            f"{lost}/{len(self.report.records)} requests lost "
            f"({frac:.1%} > {max_fraction:.1%})"
        )

    def check_partition_ownership(self) -> None:
        """Distributed flavour: every committed ref lives on the
        member the ownership map says owns its partition (a replicated
        copy elsewhere is legal IF it agrees — _ledger already rejects
        disagreement)."""
        from ..node.notary import shard_of_ref

        rep = self.report
        assert rep.flavour == "distributed" and rep.shard_map, (
            "partition-ownership check needs the distributed flavour"
        )
        n = rep.cluster_shards
        for name, ledger in rep.ledgers.items():
            for ref in ledger:
                owner = rep.shard_map[shard_of_ref(ref, n)]
                owner_ledger = rep.ledgers.get(owner)
                assert owner_ledger is None or ref in owner_ledger, (
                    f"{ref} committed on {name} but MISSING on its "
                    f"owner {owner} — a commit landed off-partition"
                )

    def check_reservation_ledger(self) -> None:
        """The round-12 reservation-ledger reconciliation:

        1. ZERO live reservations (and zero orphans) on every member
           after the drain — every reserve the chaos window stranded
           was driven to commit or release, nothing leaked.
        2. The shared decision log replayed SERIALLY through a
           reference uniqueness map reproduces the cluster ledger
           bit-exact: accepts commit their inputs (same-tx re-commits
           — WAL replays — are idempotent, like the provider), each
           recorded conflict names a consumer the replay had already
           committed, and the final replay map EQUALS the merged
           ledger."""
        rep = self.report
        assert rep.flavour == "distributed", (
            "reservation-ledger reconciliation is the distributed "
            "flavour's check"
        )
        for name, count in rep.reservations_live.items():
            assert count == 0, (
                f"{name} still holds {count} reservation(s) after the "
                f"drain — orphan recovery leaked"
            )
        for name, count in rep.xshard_orphans.items():
            assert count == 0, f"{name} reports {count} orphan(s)"
        inputs_of = {r.tx_id: r.inputs for r in rep.records}
        replay: dict = {}
        for tx_id, conflict in rep.xshard_decisions:
            refs = inputs_of.get(tx_id, ())
            if conflict is None:
                for ref in refs:
                    prior = replay.get(ref)
                    assert prior is None or prior == tx_id, (
                        f"decision log accepted {tx_id} but the serial "
                        f"replay already committed {ref} to {prior} — "
                        f"the log is out of serialisation order"
                    )
                    replay[ref] = tx_id
            else:
                for ref, consumer in conflict.items():
                    got = replay.get(ref)
                    assert got == consumer, (
                        f"decision log rejected {tx_id} against "
                        f"{consumer} on {ref}, but the serial replay "
                        f"holds {got} — the loser saw a consumer that "
                        f"was not serialised before it"
                    )
        ledger = self._ledger()
        # replay may carry refs of canary-shaped input-less accepts
        # (none in the fleet); the ledger must match the replay EXACTLY
        assert replay == ledger, (
            f"serial replay of the decision log diverges from the "
            f"cluster ledger: {len(replay)} replayed vs {len(ledger)} "
            f"committed; only-replay="
            f"{list(set(replay) - set(ledger))[:3]!r} only-ledger="
            f"{list(set(ledger) - set(replay))[:3]!r}"
        )

    def check_exact_accounting(self) -> None:
        """The intent-WAL-era loss bound, tightened to an EQUALITY:
        every admitted request is committed, rejected or shed — never
        silently dropped, kill-restarts included — and the WAL itself
        drained (no intent is still pending recovery). The in-flight-
        at-kill allowance check_lost_bounded tolerated is gone."""
        assert self.report.intent_wal, (
            "exact accounting needs the intent WAL "
            "(FleetSim(intent_wal=True)); without it use "
            "check_lost_bounded"
        )
        lost = [
            r for r in self.report.records
            if r.outcome in (None, OUT_LOST)
        ]
        assert not lost, (
            f"{len(lost)} admitted request(s) silently dropped despite "
            f"the intent WAL (first: rid={lost[0].rid} "
            f"tx={lost[0].tx_id} phase={lost[0].phase})"
        )
        assert self.report.intent_unresolved == 0, (
            f"{self.report.intent_unresolved} intent(s) still "
            f"unresolved in the WAL after the drain"
        )

    def check_lifecycle_ledger(self) -> None:
        """The round-13 lifecycle-ledger reconciliation — strictly
        stronger than the counter-based accounting above, because it
        replays PER-TRANSACTION stories against the model:

        1. Every submitted request's transaction has a story, and a
           story that reached a terminal reached EXACTLY ONE (the
           intent-WAL replay window's re-answers record `tx.reanswer`,
           never a second terminal).
        2. The terminal kind AGREES with the model's outcome — signed
           <-> committed, conflict <-> rejected, shed <-> shed with
           the MATCHING reason, unavailable <-> unavailable or
           quarantined — and every shed/quarantined/unavailable
           terminal is attributed by a non-empty reason.
        3. Every ADMITTED story (one carrying an admit/replay event)
           reached a terminal; without the intent WAL the only excuse
           is a request the model itself recorded LOST at a kill.
        4. Nothing fell off the ledger (zero evictions): the soak's
           accounting surface is complete, not sampled."""
        from ..utils.txstory import ADMIT_EVENTS, TERMINALS

        rep = self.report
        assert rep.txstory is not None, (
            "lifecycle reconciliation needs FleetSim(txstory=True)"
        )
        assert rep.txstory.evicted == 0, (
            f"{rep.txstory.evicted} stories evicted mid-soak — the "
            f"ledger was sized too small to reconcile against"
        )
        stories = {s["tx_id"]: s for s in rep.txstory.stories()}
        terminal_names = set(TERMINALS.values())
        for tid, s in stories.items():
            terms = [
                e["name"] for e in s["events"]
                if e["name"] in terminal_names
            ]
            assert len(terms) <= 1, (
                f"{tid} recorded {len(terms)} terminal events {terms} "
                f"— exactly-once broken"
            )
        lost_ok = {
            str(r.tx_id) for r in rep.records
            if r.outcome in (None, OUT_LOST)
        }
        for tid, s in stories.items():
            admitted = any(
                e["name"] in ADMIT_EVENTS for e in s["events"]
            )
            if admitted and s["terminal"] is None:
                assert not rep.intent_wal and tid in lost_ok, (
                    f"admitted transaction {tid} never reached a "
                    f"terminal event (events: "
                    f"{[e['name'] for e in s['events']]})"
                )
        expected = {
            OUT_SIGNED: ("committed",),
            OUT_CONFLICT: ("rejected",),
            OUT_SHED: ("shed",),
            # the model folds EVERY non-shed/non-conflict NotaryError
            # into OUT_UNAVAILABLE — typed rejections (invalid-
            # transaction, time-window-invalid) included, which the
            # ledger rightly closes as `rejected`
            OUT_UNAVAILABLE: ("unavailable", "quarantined", "rejected"),
        }
        for r in rep.records:
            tid = str(r.tx_id)
            s = stories.get(tid)
            assert s is not None, (
                f"no lifecycle story for submitted {tid} "
                f"(outcome {r.outcome})"
            )
            if r.outcome in (None, OUT_LOST):
                continue   # rule 3 already bounded these
            kinds = expected[r.outcome]
            assert s["terminal"] in kinds, (
                f"{tid}: model says {r.outcome} but the story closed "
                f"{s['terminal']!r} (reason {s['reason']!r})"
            )
            if r.outcome in (OUT_SHED, OUT_UNAVAILABLE):
                assert s["reason"], (
                    f"{tid}: {s['terminal']} terminal carries no "
                    f"reason attribution"
                )
            if r.outcome == OUT_SHED and r.shed_reason is not None:
                assert s["reason"] == r.shed_reason, (
                    f"{tid}: shed attributed {s['reason']!r} on the "
                    f"ledger but {r.shed_reason!r} in the model"
                )

    def check_verifier_pool(self) -> None:
        """Every verify shipped to the out-of-process pool resolved —
        worker kills included: the lease/redispatch machinery moved
        in-flight nonces to a survivor instead of stranding them."""
        rep = self.report
        assert rep.verify_offered > 0, (
            "verifier-pool check needs FleetSim(verifier_pool=N) traffic"
        )
        unresolved = rep.verify_offered - rep.verify_resolved - (
            rep.verify_failed
        )
        assert unresolved == 0, (
            f"{unresolved}/{rep.verify_offered} pool verifications "
            f"never resolved (stranded in flight)"
        )
        assert rep.verify_failed == 0, (
            f"{rep.verify_failed} pool verifications failed (all fleet "
            f"spends are valid — a failure means a lost/duplicated "
            f"answer path)"
        )
        killed = [
            e for e in rep.chaos_log if e["kind"] == "kill_verifier"
        ]
        if killed:
            assert rep.verify_workers_lost >= len(killed), (
                "a worker was killed but the pool never detached it "
                "(lease expiry broken)"
            )
            assert rep.verify_redispatched > 0, (
                "a worker was killed mid-batch yet nothing re-dispatched"
            )

    # -- the bundle ----------------------------------------------------------

    def check_all(
        self,
        slo_p99_micros: Optional[int] = None,
        expect_conflicts: bool = True,
        expect_brownout: bool = False,
    ) -> dict:
        """The full reconciliation; returns a JSON-safe verdict dict
        (bench.py's fleet metric embeds it). With an IncidentRecorder
        on the report, a FAILED check snapshots a reconciliation
        bundle (the failure text, the chaos log, the monitors' event
        story) and the re-raised AssertionError CITES its id — the
        forensics artifact is minted at the moment the invariant
        broke, not reconstructed from memory later."""
        try:
            self._check_all_inner(
                slo_p99_micros, expect_conflicts, expect_brownout
            )
        except AssertionError as e:
            incident_id = self._record_reconciliation_failure(e)
            if incident_id is not None:
                raise AssertionError(
                    f"{e} [incident {incident_id}]"
                ) from e
            raise
        return self._verdict()

    def _check_all_inner(
        self,
        slo_p99_micros: Optional[int],
        expect_conflicts: bool,
        expect_brownout: bool,
    ) -> None:
        if self.report.flavour == "distributed":
            # partition-disjoint slices, not replicas: ownership and
            # the reservation-ledger reconciliation replace replica
            # agreement
            self.check_partition_ownership()
            self.check_reservation_ledger()
        else:
            self.check_replica_agreement()
        self.check_ledger_vs_answers()
        if expect_conflicts:
            self.check_exactly_one_winner()
        self.check_no_admitted_then_expired()
        if self.report.intent_wal:
            # the WAL turns the loss allowance into an equality
            self.check_exact_accounting()
        else:
            self.check_lost_bounded()
        if self.report.txstory is not None:
            # per-transaction accounting, strictly stronger than the
            # counter equality above
            self.check_lifecycle_ledger()
        if self.report.verify_offered:
            self.check_verifier_pool()
        if slo_p99_micros is not None:
            self.check_slo(slo_p99_micros)
        if expect_brownout:
            self.check_brownout_classes()
            self.check_brownout_engaged_during_spike()
        if self.report.chaos_log:
            self.check_health_story()

    def _record_reconciliation_failure(self, exc) -> Optional[str]:
        recorder = self.report.incidents
        if recorder is None:
            return None
        # the slowest signed requests' trace ids: the bundle pulls
        # their cross-node assemblies when the sim traced them
        traced = sorted(
            (
                r for r in self.report.records
                if r.trace_id is not None and r.answered_at is not None
            ),
            key=lambda r: r.answered_at - r.submitted_at,
            reverse=True,
        )
        evidence = {
            "traces": [
                {"trace_id": f"{r.trace_id:#x}"} for r in traced[:3]
            ],
        }
        monitors = self.report.monitors
        home = self.report.members[0] if self.report.members else None
        try:
            return recorder.record(
                "reconciliation",
                "fleet.invariant_failed",
                detail={"failure": str(exc)},
                severity="critical",
                evidence=evidence,
                monitor=monitors.get(home) if home else None,
                node=home,
            )
        except Exception:
            return None   # forensics must not mask the real failure

    def _verdict(self) -> dict:
        out = self.report.outcomes()
        return {
            "reconciled": True,
            "flavour": self.report.flavour,
            "requests": len(self.report.records),
            "distinct_clients": self.report.distinct_clients,
            "outcomes": out,
            "sim_seconds": round(self.report.sim_seconds, 6),
            "goodput_per_sim_sec": round(
                out.get(OUT_SIGNED, 0) / max(self.report.sim_seconds, 1e-9),
                3,
            ),
            "faults": [e["name"] for e in self.report.chaos_log],
            "lifecycle_ledger": (
                self.report.txstory.snapshot()
                if self.report.txstory is not None else None
            ),
            "fault_plane": {
                "intent_wal": self.report.intent_wal,
                "intent_replayed": self.report.intent_replayed,
                "intent_unresolved": self.report.intent_unresolved,
                "verify_offered": self.report.verify_offered,
                "verify_resolved": self.report.verify_resolved,
                "verify_redispatched": self.report.verify_redispatched,
                "verify_workers_lost": self.report.verify_workers_lost,
                "device_faults": self.report.device_faults,
                "degraded_flushes": self.report.degraded_flushes,
            },
        }
