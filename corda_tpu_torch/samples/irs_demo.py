"""irs-demo: interest-rate swap with a rate-fixing oracle + scheduler.

Reference: samples/irs-demo/ — an IRS lifecycle where a rate oracle
(`NodeInterestRates` in api/NodeInterestRates.kt) serves interest-rate
queries and **signs Merkle tear-offs** of fixing transactions (it sees
only the Fix command, nothing else — the oracle privacy pattern,
`RatesFixFlow` in flows/RatesFixFlow.kt), and fixings are driven by the
scheduler: the swap state is a `SchedulableState` whose
nextScheduledActivity launches the next fixing flow at its fixing date.

Port of corda_tpu/samples/irs_demo.py. `run` takes `batch_verifier=`:
the port's MockNetwork verifies on the card by default, where the
reference's verifies on the CPU. Contract, wire and flow tags are the
reference's strings, so transaction ids equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core import serialization as ser
from ..core.contracts import (
    ScheduledActivity,
    StateRef,
    register_contract,
    require_that,
)
from ..core.identity import Party
from ..core.transactions import (
    FilteredTransaction,
    G_COMMANDS,
    LedgerTransaction,
    TransactionBuilder,
    TransactionVerificationError,
)
from ..crypto.tx_signature import TransactionSignature
from ..flows.api import (
    FlowException,
    FlowLogic,
    class_tag,
    initiated_by,
    initiating_flow,
)
from ..flows.core_flows import CollectSignaturesFlow, FinalityFlow
from ..node.cordapp import corda_service

IRS_CONTRACT = "corda_tpu.samples.InterestRateSwap"


# -- the rate model ----------------------------------------------------------


@ser.serializable
@dataclass(frozen=True)
class FixOf:
    """Which rate is being fixed: index name + fixing date (reference:
    core FixOf — name/forDay/ofTenor collapsed to name+date)."""

    name: str                       # e.g. "LIBOR-3M"
    date_micros: int


@ser.serializable
@dataclass(frozen=True)
class RateFix:
    """An observed fixing: the FixOf plus the rate in basis points
    (integer — no floats on the ledger)."""

    of: FixOf
    rate_bps: int


# -- the swap state ----------------------------------------------------------


@ser.serializable
@dataclass(frozen=True)
class InterestRateSwapState:
    """A stylised IRS: fixed leg vs floating leg fixed by the oracle on
    each fixing date. Fixings accumulate on the state; the state is
    SCHEDULABLE — it asks for a FixingFlow at its next unfixed date."""

    fixed_payer: Party
    floating_payer: Party
    oracle: Party
    notional: int
    fixed_rate_bps: int
    index_name: str
    fixing_dates: tuple[int, ...]          # micros, ascending
    fixings: tuple[RateFix, ...] = ()

    @property
    def participants(self):
        return (self.fixed_payer, self.floating_payer)

    def next_fixing_date(self) -> Optional[int]:
        fixed = {f.of.date_micros for f in self.fixings}
        for d in self.fixing_dates:
            if d not in fixed:
                return d
        return None

    def next_scheduled_activity(self, this_state_ref: StateRef):
        d = self.next_fixing_date()
        if d is None:
            return None
        return ScheduledActivity(
            flow_tag=class_tag(FixingFlow),
            flow_args=(this_state_ref,),
            scheduled_at=d,
        )

    def with_fixing(self, fix: RateFix) -> "InterestRateSwapState":
        return InterestRateSwapState(
            self.fixed_payer,
            self.floating_payer,
            self.oracle,
            self.notional,
            self.fixed_rate_bps,
            self.index_name,
            self.fixing_dates,
            self.fixings + (fix,),
        )


@ser.serializable
@dataclass(frozen=True)
class IRSAgree:
    pass


@ser.serializable
@dataclass(frozen=True)
class IRSFix:
    fix: RateFix


class InterestRateSwap:
    def verify(self, ltx: LedgerTransaction) -> None:
        agrees = ltx.commands_of_type(IRSAgree)
        fixes = ltx.commands_of_type(IRSFix)
        require_that(
            "exactly one IRS command", len(agrees) + len(fixes) == 1
        )
        ins = ltx.inputs_of_type(InterestRateSwapState)
        outs = ltx.outputs_of_type(InterestRateSwapState)
        if agrees:
            cmd = agrees[0]
            require_that("agreement creates one swap", not ins and len(outs) == 1)
            swap = outs[0]
            signers = set(cmd.signers)
            for p in swap.participants:
                require_that(
                    "agreement signed by both parties",
                    p.owning_key in signers,
                )
        else:
            cmd = fixes[0]
            require_that("fix consumes one swap", len(ins) == 1 and len(outs) == 1)
            before, after = ins[0], outs[0]
            fix = cmd.value.fix
            require_that(
                "fix is for the next unfixed date",
                before.next_fixing_date() == fix.of.date_micros,
            )
            require_that(
                "fix is for the swap's index",
                fix.of.name == before.index_name,
            )
            require_that(
                "output appends exactly this fixing",
                after == before.with_fixing(fix),
            )
            require_that(
                "fix is signed by the oracle",
                before.oracle.owning_key in set(cmd.signers),
            )


register_contract(IRS_CONTRACT, InterestRateSwap())


# -- the oracle (NodeInterestRates) ------------------------------------------


@corda_service
class RateOracleService:
    """A @corda_service (reference: `@CordaService class Oracle`,
    NodeInterestRates.kt + AbstractNode.kt:226-279): discovered from
    the cordapp module and constructed with the ServiceHub on every
    node that installs it; only nodes whose operator `configure()`s a
    rate table act as oracles. The sign check: EVERY revealed component
    must be an IRSFix command whose rate matches our table — the oracle
    never sees (and cannot be tricked into signing) anything else
    (NodeInterestRates.sign)."""

    def __init__(self, services):
        self.services = services
        self.rates: Optional[dict[tuple[str, int], int]] = None

    def configure(self, rates: dict[tuple[str, int], int]) -> None:
        self.rates = dict(rates)

    @property
    def configured(self) -> bool:
        return self.rates is not None

    def query(self, fix_of: FixOf) -> Optional[int]:
        if self.rates is None:
            return None
        return self.rates.get((fix_of.name, fix_of.date_micros))

    def sign(self, ftx: FilteredTransaction) -> TransactionSignature:
        if self.rates is None:
            raise ValueError("this node's oracle is not configured")
        ftx.verify()
        revealed = [
            (g, c) for g, _i, c in ftx.components if g != 6   # not meta
        ]
        if not revealed:
            raise ValueError("nothing revealed to sign over")
        for g, c in revealed:
            if g != G_COMMANDS:
                raise ValueError("oracle only signs command components")
            if not hasattr(c, "value") or not isinstance(c.value, IRSFix):
                raise ValueError("oracle only signs Fix commands")
            fix = c.value.fix
            expected = self.query(fix.of)
            if expected is None:
                raise ValueError(f"no rate known for {fix.of}")
            if fix.rate_bps != expected:
                raise ValueError(
                    f"rate {fix.rate_bps} != fixing {expected} for {fix.of}"
                )
        return self.services.key_management.sign(
            ftx.id, self.services.my_info.legal_identity.owning_key
        )


@ser.serializable
@dataclass(frozen=True)
class RateQuery:
    fix_of: FixOf


@ser.serializable
@dataclass(frozen=True)
class RateQueryResponse:
    rate_bps: Optional[int]


@initiating_flow
class OracleQueryFlow(FlowLogic):
    """Ask the oracle for a rate (RatesFixFlow.QueryRequest)."""

    def __init__(self, oracle: Party, fix_of: FixOf):
        self.oracle = oracle
        self.fix_of = fix_of

    def call(self):
        resp = yield from self.send_and_receive(
            self.oracle, RateQuery(self.fix_of), RateQueryResponse
        )
        if resp.rate_bps is None:
            raise FlowException(f"oracle knows no rate for {self.fix_of}")
        return resp.rate_bps


@initiated_by(OracleQueryFlow)
class OracleQueryHandler(FlowLogic):
    def __init__(self, other: Party):
        self.other = other

    def call(self):
        q = yield from self.receive(self.other, RateQuery)
        try:
            oracle = self.services.cordapp_service(RateOracleService)
        except KeyError:
            oracle = None
        if oracle is None or not oracle.configured:
            raise FlowException("this node is not a rate oracle")
        yield from self.send(
            self.other, RateQueryResponse(oracle.query(q.fix_of))
        )
        return None


@initiating_flow
class OracleSignFlow(FlowLogic):
    """Send the oracle a tear-off revealing only the Fix command; get
    its signature over the whole transaction id back
    (RatesFixFlow.SignRequest)."""

    def __init__(self, oracle: Party, ftx: FilteredTransaction):
        self.oracle = oracle
        self.ftx = ftx

    def call(self):
        sig = yield from self.send_and_receive(
            self.oracle, self.ftx, TransactionSignature
        )
        sig.verify(self.ftx.id)
        if sig.by != self.oracle.owning_key:
            raise FlowException("oracle signed with an unexpected key")
        return sig


@initiated_by(OracleSignFlow)
class OracleSignHandler(FlowLogic):
    def __init__(self, other: Party):
        self.other = other

    def call(self):
        ftx = yield from self.receive(self.other, FilteredTransaction)
        try:
            oracle = self.services.cordapp_service(RateOracleService)
        except KeyError:
            oracle = None
        if oracle is None or not oracle.configured:
            raise FlowException("this node is not a rate oracle")
        try:
            sig = oracle.sign(ftx)
        except (ValueError, TransactionVerificationError) as e:
            raise FlowException(f"oracle refused to sign: {e}")
        yield from self.send(self.other, sig)
        return None


# -- the fixing flow (scheduler-launched) ------------------------------------


@initiating_flow
class FixingFlow(FlowLogic):
    """Fix the swap's next date: query the oracle, build the fixing tx,
    have the oracle sign its tear-off, collect the counterparty's
    signature, finalise (RatesFixFlow + FixingFlow in the demo).

    Launched BY THE SCHEDULER on both participants at the fixing date —
    only the fixed payer proceeds (deterministic leader), the floating
    payer's instance no-ops (the reference demo picks sides the same
    way)."""

    def __init__(self, state_ref: StateRef):
        self.state_ref = state_ref

    def call(self):
        sar = self.services.vault.state_and_ref(self.state_ref)
        if sar is None:
            return None   # already fixed/consumed (at-least-once firing)
        swap: InterestRateSwapState = sar.state.data
        if self.our_identity != swap.fixed_payer:
            return None   # the floating payer's scheduler also fired
        fix_date = swap.next_fixing_date()
        if fix_date is None:
            return None
        fix_of = FixOf(swap.index_name, fix_date)
        rate = yield from self.sub_flow(
            OracleQueryFlow(swap.oracle, fix_of)
        )
        fix = RateFix(fix_of, rate)
        builder = TransactionBuilder()
        builder.add_input_state(sar)
        builder.add_output_state(swap.with_fixing(fix), IRS_CONTRACT)
        builder.add_command(
            IRSFix(fix),
            swap.oracle.owning_key,
            swap.fixed_payer.owning_key,
            swap.floating_payer.owning_key,
        )
        stx = self.services.sign_initial_transaction(builder)
        # the oracle sees ONLY its Fix command
        ftx = stx.wtx.build_filtered_transaction(
            lambda c: hasattr(c, "value") and isinstance(c.value, IRSFix)
        )
        oracle_sig = yield from self.sub_flow(
            OracleSignFlow(swap.oracle, ftx)
        )
        stx = stx.with_additional_signature(oracle_sig)
        stx = yield from self.sub_flow(CollectSignaturesFlow(stx))
        result = yield from self.sub_flow(FinalityFlow(stx))
        return result


@initiating_flow
class StartSwapFlow(FlowLogic):
    """Agree the swap between the two parties (demo setup)."""

    def __init__(self, swap: InterestRateSwapState, notary: Party):
        self.swap = swap
        self.notary = notary

    def call(self):
        builder = TransactionBuilder(self.notary)
        builder.add_output_state(self.swap, IRS_CONTRACT)
        builder.add_command(
            IRSAgree(),
            self.swap.fixed_payer.owning_key,
            self.swap.floating_payer.owning_key,
        )
        stx = self.services.sign_initial_transaction(builder)
        stx = yield from self.sub_flow(CollectSignaturesFlow(stx))
        result = yield from self.sub_flow(FinalityFlow(stx))
        return result


# -- the demo arc ------------------------------------------------------------


def run(seed: int = 42, n_fixings: int = 3, batch_verifier=None):
    """The full demo on a MockNetwork: agree a swap, let the SCHEDULER
    fire each fixing as its date arrives, oracle-sign each one. Returns
    the final swap state. `batch_verifier`: the MockNetwork's verifier;
    None verifies on the card (`CudaBatchVerifier()`),
    `CpuBatchVerifier()` runs without one."""
    from ..testing.mock_network import MockNetwork

    net = MockNetwork(seed=seed, batch_verifier=batch_verifier)
    notary = net.create_notary("Notary", validating=True)
    bank_a = net.create_node("BankA")
    bank_b = net.create_node("BankB")
    oracle_node = net.create_node("RateOracle")

    now = net.clock.now_micros()
    dates = tuple(now + (i + 1) * 1_000_000 for i in range(n_fixings))
    rates = {("LIBOR-3M", d): 500 + 7 * i for i, d in enumerate(dates)}
    oracle_node.services.cordapp_service(RateOracleService).configure(rates)

    swap = InterestRateSwapState(
        fixed_payer=bank_a.party,
        floating_payer=bank_b.party,
        oracle=oracle_node.party,
        notional=10_000_000,
        fixed_rate_bps=450,
        index_name="LIBOR-3M",
        fixing_dates=dates,
    )
    fsm = bank_a.start_flow(StartSwapFlow(swap, notary.party))
    net.run()
    fsm.result_or_throw()

    # let time pass; the scheduler fires each fixing
    for _ in range(n_fixings):
        net.clock.advance(1_000_000)
        net.run()

    final = bank_b.vault.unconsumed_states(InterestRateSwapState)
    assert len(final) == 1
    return final[0].state.data
