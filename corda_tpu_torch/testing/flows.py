"""Tiny flows used by Ring-3 tests (ping/pong, a responder-less flow,
the scheduled heartbeat).

Port of corda_tpu/testing/flows.py, with the vault-query fixture
(DummyLinearState, `make_linear_state_tx`) and the empty-flow probe
(NoOpFlow, which the load test's EmptyFlowLoadTest starts). Module-
level so checkpoint restore can re-import them
(statemachine._reconstruct_logic); their tags are the reference's paths
(`corda_tpu.testing.flows.PingFlow`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import serialization as ser
from ..core.contracts import ScheduledActivity, UniqueIdentifier, register_contract
from ..core.identity import Party
from ..core.transactions import TransactionBuilder
from ..flows.api import FlowLogic, initiated_by, initiating_flow
from ..flows.core_flows import FinalityFlow


@initiating_flow
class PingFlow(FlowLogic):
    """Send `count` pings, expect incremented replies."""

    def __init__(self, other: Party, count: int = 1):
        self.other = other
        self.count = count

    def call(self):
        total = 0
        for i in range(self.count):
            reply = yield from self.send_and_receive(self.other, i, int)
            if reply != i + 1:
                raise AssertionError(f"bad pong {reply} for ping {i}")
            total += reply
        return total


@initiated_by(PingFlow)
class PongFlow(FlowLogic):
    def __init__(self, other: Party):
        self.other = other

    def call(self):
        while True:
            try:
                n = yield from self.receive(self.other, int)
            except Exception:
                return None   # session ended
            yield from self.send(self.other, n + 1)


@initiating_flow
class OneShotPingFlow(FlowLogic):
    """Single round-trip (responder ends after one reply)."""

    def __init__(self, other: Party, value: int = 7):
        self.other = other
        self.value = value

    def call(self):
        reply = yield from self.send_and_receive(self.other, self.value, int)
        return reply


@initiated_by(OneShotPingFlow)
class OneShotPongFlow(FlowLogic):
    def __init__(self, other: Party):
        self.other = other

    def call(self):
        n = yield from self.receive(self.other, int)
        yield from self.send(self.other, n * 2)
        return n


@ser.serializable
@dataclass(frozen=True)
class DummyLinearState:
    """Minimal LinearState for vault/scheduler tests (reference:
    test-utils DummyLinearContract.State)."""

    linear_id: UniqueIdentifier
    info: str
    owner: object   # PublicKey

    @property
    def participants(self):
        return (self.owner,)


class _DummyLinearContract:
    def verify(self, ltx) -> None:
        pass


DUMMY_LINEAR_CONTRACT = "test.DummyLinear"


def make_linear_state_tx(node, notary: Party, linear_id, info: str):
    """Build, self-sign and record a tx issuing one DummyLinearState."""
    register_contract(DUMMY_LINEAR_CONTRACT, _DummyLinearContract())
    b = TransactionBuilder(notary=notary)
    b.add_output_state(
        DummyLinearState(linear_id, info, node.party.owning_key),
        DUMMY_LINEAR_CONTRACT,
    )
    stx = node.services.sign_initial_transaction(b)
    node.services.record_transactions([stx])
    return stx


@ser.serializable
@dataclass(frozen=True)
class HeartbeatState:
    """SchedulableState test fixture: beats `count` up to `target`, one
    beat every `period_micros` (reference: NodeSchedulerServiceTest's
    TestState + ScheduledFlow in samples/irs-demo fixing logic)."""

    owner: object                  # PublicKey
    count: int
    target: int
    due_micros: int
    period_micros: int

    @property
    def participants(self):
        return (self.owner,)

    def next_scheduled_activity(self, this_state_ref):
        if self.count >= self.target:
            return None
        return ScheduledActivity(
            "corda_tpu.testing.flows.HeartbeatFlow",
            (this_state_ref,),
            self.due_micros,
        )


class _HeartbeatContract:
    def verify(self, ltx) -> None:
        pass


HEARTBEAT_CONTRACT = "test.Heartbeat"


def make_heartbeat_tx(node, notary: Party, *, target: int, period: int):
    """Issue a HeartbeatState due `period` micros from now."""
    register_contract(HEARTBEAT_CONTRACT, _HeartbeatContract())
    now = node.services.clock.now_micros()
    b = TransactionBuilder(notary=notary)
    b.add_output_state(
        HeartbeatState(node.party.owning_key, 0, target, now + period, period),
        HEARTBEAT_CONTRACT,
    )
    stx = node.services.sign_initial_transaction(b)
    node.services.record_transactions([stx])
    return stx


@initiating_flow
class HeartbeatFlow(FlowLogic):
    """Scheduler-launched: consume the heartbeat state, emit the next
    beat (count+1) due one period later. Constructor args = (StateRef,)
    per the FlowLogicRef discipline."""

    def __init__(self, ref):
        self.ref = ref

    def call(self):
        sar = self.services.vault.state_and_ref(self.ref)
        if sar is None:
            return None   # already consumed (double-fire guard)
        beat: HeartbeatState = sar.state.data
        now = self.services.clock.now_micros()
        b = TransactionBuilder(notary=sar.state.notary)
        b.add_input_state(sar)
        b.add_output_state(
            HeartbeatState(
                beat.owner,
                beat.count + 1,
                beat.target,
                now + beat.period_micros,
                beat.period_micros,
            ),
            HEARTBEAT_CONTRACT,
        )
        stx = self.services.sign_initial_transaction(b)
        stx = yield from self.sub_flow(FinalityFlow(stx))
        return stx.id


@initiating_flow
class NoResponderFlow(FlowLogic):
    """No @initiated_by counterpart: used to test SessionReject."""

    def __init__(self, other: Party):
        self.other = other

    def call(self):
        reply = yield from self.send_and_receive(self.other, 1, int)
        return reply



@initiating_flow
class NoOpFlow(FlowLogic):
    """The empty flow: no IO, returns immediately — the
    NodePerformanceTests round-trip probe (NodePerformanceTests.kt:59)."""

    def call(self):
        return "done"
