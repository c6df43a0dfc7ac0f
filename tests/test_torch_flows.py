"""The port's flow framework on MockNetwork (corda_tpu_torch.flows,
node/messaging.py, testing/mock_network.py), on the CPU.

The cases of the reference's tests/test_flows.py — sessions, shuffled
delivery, issue and pay with each notary kind, double spend, exit,
insufficient balance, checkpoint restore mid-flow and mid-conversation,
confidential identities — run on the port over its CpuBatchVerifier;
one small drive goes through `CudaBatchVerifier(device="cpu")`, whose
plain versions stand in for the kernels and count their launches. The
default MockNetwork builds a verifier on the card (raises here), and a
request's `deadline` reaches the batching notary and is ignored, as in
the reference without a QoS plane. Byte equality with the reference's
drive is tests/test_torch_mock_network.py.
"""

from __future__ import annotations

import random

import pytest

pytest.importorskip("torch")

from corda_tpu_torch.core.contracts import StateRef  # noqa: E402
from corda_tpu_torch.core.transactions import TransactionBuilder  # noqa: E402
from corda_tpu_torch.crypto.batch_verifier import (  # noqa: E402
    CpuBatchVerifier,
    CudaBatchVerifier,
)
from corda_tpu_torch.finance import (  # noqa: E402
    CashExitFlow,
    CashIssueFlow,
    CashPaymentFlow,
    CashState,
)
from corda_tpu_torch.finance.cash import CASH_CONTRACT, CashMove  # noqa: E402
from corda_tpu_torch.flows.api import FlowException, FlowSessionException  # noqa: E402
from corda_tpu_torch.flows.core_flows import FinalityFlow  # noqa: E402
from corda_tpu_torch.flows.statemachine import StateMachineManager  # noqa: E402
from corda_tpu_torch.node.notary import NotaryException  # noqa: E402
from corda_tpu_torch.testing import MockNetwork  # noqa: E402
from corda_tpu_torch.testing.flows import (  # noqa: E402
    NoResponderFlow,
    OneShotPingFlow,
    PingFlow,
)


def make_net(notary_kind="simple", verifier=None, **kw):
    net = MockNetwork(seed=7, batch_verifier=verifier or CpuBatchVerifier(), **kw)
    notary = net.create_notary(validating=notary_kind == "validating",
                               batching=notary_kind == "batching")
    alice = net.create_node("Alice")
    bob = net.create_node("Bob")
    return net, notary, alice, bob


def balance(node, currency="USD"):
    return sum(
        s.state.data.amount.quantity
        for s in node.vault.unconsumed_states(CashState)
        if s.state.data.amount.token.product == currency
    )


def spend_of(node, coin, key):
    b = TransactionBuilder()
    b.add_input_state(coin)
    b.add_output_state(coin.state.data.with_owner(key), CASH_CONTRACT)
    b.add_command(CashMove(), node.party.owning_key)
    return node.services.sign_initial_transaction(b)


# -- session machinery ---------------------------------------------------------


def test_ping_pong_roundtrips():
    net, _, alice, bob = make_net()
    assert alice.run_flow(PingFlow(bob.party, 3)) == 1 + 2 + 3


def test_one_shot():
    net, _, alice, bob = make_net()
    assert alice.run_flow(OneShotPingFlow(bob.party, 21)) == 42


def test_session_reject_when_no_responder():
    net, _, alice, bob = make_net()
    with pytest.raises(FlowSessionException, match="no responder"):
        alice.run_flow(NoResponderFlow(bob.party))


def test_shuffled_delivery_is_deterministic():
    net = MockNetwork(seed=9, batch_verifier=CpuBatchVerifier(), shuffle_delivery=True)
    alice = net.create_node("Alice")
    bob = net.create_node("Bob")
    assert alice.run_flow(PingFlow(bob.party, 5)) == 15


def test_flow_tags_are_the_reference_paths():
    """Session frames and checkpoint records name a flow by the
    reference's module path, so they equal the reference's bytes."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.flows.statemachine import SessionInit

    net, _, alice, bob = make_net()
    sent = []
    real = net.fabric._enqueue
    net.fabric._enqueue = lambda msg, target: (sent.append(msg), real(msg, target))
    alice.start_flow(OneShotPingFlow(bob.party, 5))
    init = ser.decode(sent[0].payload)
    assert isinstance(init, SessionInit)
    assert init.flow_tag == "corda_tpu.testing.flows.OneShotPingFlow"
    (_, record), = alice.services.checkpoint_storage.all()
    assert ser.decode(record)[1] == "corda_tpu.testing.flows.OneShotPingFlow"
    assert CashPaymentFlow._initiating_tag == "corda_tpu.finance.cash.CashPaymentFlow"


def test_fabric_faults_hold_delay_and_duplicate_frames():
    """The fault plane: frames across a partition stay queued until the
    heal, a slow link holds them until the network clock passes the
    delay, and a duplicated frame is absorbed by (sender, id) dedupe."""
    from corda_tpu_torch.node.messaging import FabricFaults

    faults = FabricFaults(seed=1)
    net = MockNetwork(seed=7, batch_verifier=CpuBatchVerifier(), faults=faults)
    alice, bob = net.create_node("Alice"), net.create_node("Bob")
    faults.partition({"Alice"}, {"Bob"})
    fsm = alice.start_flow(PingFlow(bob.party, 2))
    net.run()
    assert not fsm.done and net.fabric.pending == 1 and net.fabric.deliverable == 0
    faults.heal()
    faults.slow_link("Alice", "Bob", 500)
    faults.duplicate_link("Alice", "Bob", 1.0)
    net.run()               # the held Init was queued before the delay: it moves
    for _ in range(3):      # each later hop waits on the clock
        assert not fsm.done
        net.clock.advance(500)
        net.run()
    assert fsm.result_or_throw() == 1 + 2
    assert [e["action"] for e in faults.log] == [
        "partition", "heal", "slow_link", "duplicate_link"]


# -- cash + notarisation end to end --------------------------------------------


@pytest.mark.parametrize("notary_kind", ["simple", "validating", "batching"])
def test_issue_and_pay(notary_kind):
    net, notary, alice, bob = make_net(notary_kind)
    stx = alice.run_flow(CashIssueFlow(1000, "USD", alice.party, notary.party))
    assert balance(alice) == 1000
    assert stx.id in alice.services.validated_transactions
    alice.run_flow(CashPaymentFlow(300, "USD", bob.party))
    assert (balance(alice), balance(bob)) == (700, 300)
    # bob spends what he received (the backchain resolves from bob's side)
    bob.run_flow(CashPaymentFlow(100, "USD", alice.party))
    assert (balance(alice), balance(bob)) == (800, 200)
    service = notary.services.notary_service
    assert len(service.uniqueness.committed) == 2
    if notary_kind == "batching":
        assert service.batches_dispatched == 2 and not service.degraded


def test_double_spend_rejected():
    net, notary, alice, bob = make_net()
    alice.run_flow(CashIssueFlow(100, "USD", alice.party, notary.party))
    coin = alice.vault.unconsumed_states(CashState)[0]
    stx1 = spend_of(alice, coin, bob.party.owning_key)
    stx2 = spend_of(alice, coin, alice.party.owning_key)
    assert stx1.id != stx2.id
    alice.run_flow(FinalityFlow(stx1))
    with pytest.raises(NotaryException) as exc_info:
        alice.run_flow(FinalityFlow(stx2))
    assert exc_info.value.error.kind == "conflict"
    assert str(StateRef(coin.ref.txhash, coin.ref.index)) in str(
        exc_info.value.error.conflict
    )


def test_exit_destroys_value():
    net, notary, alice, bob = make_net()
    alice.run_flow(CashIssueFlow(100, "USD", alice.party, notary.party))
    alice.run_flow(CashExitFlow(40, "USD"))
    assert balance(alice) == 60


def test_insufficient_balance():
    net, notary, alice, bob = make_net()
    alice.run_flow(CashIssueFlow(10, "USD", alice.party, notary.party))
    with pytest.raises(FlowException, match="insufficient"):
        alice.run_flow(CashPaymentFlow(50, "USD", bob.party))
    # soft locks released on failure: a valid spend still works
    alice.run_flow(CashPaymentFlow(5, "USD", bob.party))
    assert balance(bob) == 5


def test_traced_notarisation_joins_one_trace_across_the_fabric():
    """With a tracer on, NotaryFlow opens the trace and every session
    frame of the payer's flow and of the notary's service flow carries
    its context as the fabric header (`wire_trace`); the batching
    notary's request span joins the same trace. The payloads are the
    untraced run's, byte for byte."""
    from corda_tpu_torch.utils import tracing

    def paid(tracer):
        saved = tracing.get_tracer()
        tracing.set_tracer(tracer)
        try:
            net, notary, alice, bob = make_net("batching")
            alice.run_flow(CashIssueFlow(100, "USD", alice.party, notary.party))
            sent = []
            real = net.fabric._enqueue
            net.fabric._enqueue = lambda msg, target: (sent.append((msg, target)),
                                                      real(msg, target))
            alice.run_flow(CashPaymentFlow(40, "USD", bob.party))
        finally:
            tracing.set_tracer(saved)
        return sent

    tracer = tracing.Tracer(enabled=True)
    traced, plain = paid(tracer), paid(tracing.Tracer(enabled=False))
    assert [m.payload for m, _ in traced] == [m.payload for m, _ in plain]
    assert all(m.trace is None for m, _ in plain)
    (root,), = [[s for s in t if s.name == "notarise.client"] for t in tracer.completed
                if any(s.name == "notarise.client" for s in t)]
    notary_legs = [m for m, target in traced if "Notary" in (m.sender, target)]
    assert notary_legs and all(
        m.trace is not None and len(m.trace) == 3 and m.trace[0] == root.trace_id
        for m in notary_legs)
    trace, = [t for t in tracer.completed if t[0].trace_id == root.trace_id]
    assert {"notarise.client", "notarise.request"} <= {s.name for s in trace}


# -- checkpoint / restore ------------------------------------------------------


def _restart(node, seed):
    """A node restart as the reference's tests make it: stop the state
    machine (detach its handlers), build a fresh one over the same
    services and endpoint, restore from checkpoint storage."""
    node.smm.stop()
    node.smm = StateMachineManager(node.services, node.messaging, rng=random.Random(seed))
    return node.smm.restore_checkpoints()


def test_flow_restores_from_checkpoint_after_restart():
    net, _, alice, bob = make_net()
    fsm = alice.start_flow(OneShotPingFlow(bob.party, 5))
    net.fabric.pump(1)      # alice -> bob Init only; bob's reply stays queued
    assert not fsm.done
    assert len(alice.services.checkpoint_storage.all()) == 1
    assert _restart(alice, 1) == 1
    net.run()
    fsm2, = alice.smm.flows.values()
    assert fsm2.result_or_throw() == 10
    assert alice.services.checkpoint_storage.all() == []


def test_mid_conversation_restore():
    net, _, alice, bob = make_net()
    fsm = alice.start_flow(PingFlow(bob.party, 4))
    net.fabric.pump(4)      # two round trips: init, pong, ping, pong
    assert not fsm.done
    assert _restart(alice, 2) == 1
    net.run()
    fsm2, = alice.smm.flows.values()
    assert fsm2.result_or_throw() == 1 + 2 + 3 + 4


def test_payment_restores_while_it_awaits_the_notary():
    """A CashPaymentFlow checkpointed while it waits for the validating
    notary's answer completes after a restart: its coin selection and
    sends replay from the journal, the notary's answer arrives on the
    restored session."""
    net, notary, alice, bob = make_net("validating")
    alice.run_flow(CashIssueFlow(100, "USD", alice.party, notary.party))
    fsm = alice.start_flow(CashPaymentFlow(30, "USD", bob.party))
    assert fsm.waiting[0] == "recv"
    assert alice.smm.sessions_by_id[fsm.waiting[1]][1].party == notary.party
    net.fabric.pump(1)
    assert _restart(alice, 3) == 1
    restored, = alice.smm.flows.values()
    net.run()
    stx = restored.result_or_throw()
    assert stx.id in alice.services.validated_transactions
    assert stx.id in bob.services.validated_transactions
    assert (balance(alice), balance(bob)) == (70, 30)


# -- confidential identities ---------------------------------------------------


def test_swap_identities_flow():
    from corda_tpu_torch.core.identity import AnonymousParty
    from corda_tpu_torch.flows.core_flows import SwapIdentitiesFlow

    net, notary, alice, bob = make_net()
    fsm = alice.start_flow(SwapIdentitiesFlow(bob.party))
    net.run()
    mapping = fsm.result_or_throw()
    anon_alice, anon_bob = mapping[alice.party], mapping[bob.party]
    assert isinstance(anon_bob, AnonymousParty)
    assert anon_bob.owning_key != bob.party.owning_key
    assert alice.services.identity.well_known_party(anon_bob) == bob.party
    assert bob.services.identity.well_known_party(anon_alice) == alice.party
    assert alice.services.identity.well_known_party(anon_alice) == alice.party
    # pay the anonymous key: relevancy still routes it to bob's vault
    alice.run_flow(CashIssueFlow(500, "USD", alice.party, notary.party))
    alice.run_flow(CashPaymentFlow(200, "USD", AnonymousParty(anon_bob.owning_key)))
    assert balance(bob) == 200


def test_swap_identities_rejects_forged_and_hostile_proofs():
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.composite import CompositeKey
    from corda_tpu_torch.flows.core_flows import AnonymousIdentity, _accept_identity

    net, notary, alice, bob = make_net()
    fresh = bob.services.key_management.fresh_key()
    zeros = b"\x00" * 64
    with pytest.raises(FlowException, match="proof failed"):
        _accept_identity(alice.services, AnonymousIdentity(bob.party, fresh, zeros, zeros),
                         expected=bob.party)
    with pytest.raises(FlowException, match="session is with"):
        _accept_identity(alice.services, AnonymousIdentity(alice.party, fresh, zeros, zeros),
                         expected=bob.party)
    for bad_key in (CompositeKey.build([fresh, bob.party.owning_key]), b"not-a-key"):
        with pytest.raises(FlowException, match="proof failed"):
            _accept_identity(alice.services,
                             AnonymousIdentity(bob.party, bad_key, zeros, zeros),
                             expected=bob.party)
    # endorsing a key the party cannot sign with fails the possession proof
    charlie_key = schemes.generate_keypair(seed=777).public
    bind = AnonymousIdentity(bob.party, charlie_key, b"", b"").bind_bytes()
    bob_sig = bob.services.key_management.sign_bytes(bind, bob.party.owning_key)
    with pytest.raises(FlowException, match="proof failed"):
        _accept_identity(alice.services, AnonymousIdentity(bob.party, charlie_key, bob_sig, zeros),
                         expected=bob.party)


# -- the card by default, and the device path ----------------------------------


def test_default_network_verifies_on_the_card():
    """MockNetwork() builds a CudaBatchVerifier on "cuda": it raises
    where there is no card (the reference defaults to its CPU verifier;
    ROADMAP Queue 3 records the divergence)."""
    import torch

    if torch.cuda.is_available():
        net = MockNetwork()
        assert isinstance(net.batch_verifier, CudaBatchVerifier)
        assert net.batch_verifier.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MockNetwork()


def test_persistence_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 #6"):
        MockNetwork(batch_verifier=CpuBatchVerifier(), db_dir="nodes")
    net, _, alice, _ = make_net()
    with pytest.raises(NotImplementedError, match="Queue 1 #6"):
        net.restart_node(alice)


def test_drive_through_the_device_path(monkeypatch):
    """Issue, one payment and a double spend over
    CudaBatchVerifier(device="cpu", batch_sizes=(16,)): every signature
    check of the flows and the notary runs the device path, with the
    kernels' plain versions counted as launched."""
    import torch

    from corda_tpu_torch.crypto import cuda_ec

    monkeypatch.setattr(cuda_ec, "ed_ladder_launches", 0)
    plain = cuda_ec.ed_ladder_plain

    def counted(*args):
        cuda_ec.ed_ladder_launches += 1
        return plain(*args)

    monkeypatch.setattr(cuda_ec, "ed_ladder_plain", counted)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        verifier = CudaBatchVerifier(device="cpu", batch_sizes=(16,))
        calls = []
        real = verifier.verify_batch_async
        monkeypatch.setattr(verifier, "verify_batch_async",
                            lambda reqs: calls.append(len(reqs)) or real(reqs))
        net, notary, alice, bob = make_net(verifier=verifier)
        alice.run_flow(CashIssueFlow(100, "USD", alice.party, notary.party))
        alice.run_flow(CashPaymentFlow(60, "USD", bob.party))
        assert (balance(alice), balance(bob)) == (40, 60)
        coin, = alice.vault.unconsumed_states(CashState)
        alice.run_flow(FinalityFlow(spend_of(alice, coin, bob.party.owning_key)))
        with pytest.raises(NotaryException) as exc_info:
            alice.run_flow(FinalityFlow(spend_of(alice, coin, alice.party.owning_key)))
    finally:
        torch.set_num_threads(saved)
    assert exc_info.value.error.kind == "conflict"
    # rows per call — issue to herself: finality; payment: finality, then
    # Bob resolves the issue and checks the payment with the notary's
    # signature; the first spend: finality, Bob's check; the double
    # spend: finality (the simple notary sees a tear-off and checks no
    # signature)
    assert calls == [1, 1, 1, 2, 1, 2, 1]
    assert cuda_ec.ed_ladder_launches == len(calls)


def test_batching_notary_deadline_answers_as_the_reference():
    """BatchingNotaryService.process(..., deadline=) in both packages on
    the same spends' bytes: the same answers (byte-equal notary
    signatures), with and without a deadline — neither has a QoS plane,
    so both ignore it."""
    import test_torch_notary as tn
    from corda_tpu_torch.node import notary as pnot
    from corda_tpu_torch.testing.notary_fixture import notary_hub

    fx = tn.fixture()
    spends = [fx.spends[i] for i in tn.SMALL]
    answers = {}
    for deadline in (None, 1):
        svc = pnot.BatchingNotaryService(notary_hub(fx, CpuBatchVerifier()))
        started = pnot.run_process([svc.process(s, fx.requester, deadline=deadline)
                                    for s in spends])
        svc.flush()
        answers["port", deadline] = [tn.pser.encode(a) for a in pnot.finish_process(started)]
        hub, r_spends, requester = tn._reference_hub(fx, tn.StreamedCpu())
        r_svc = tn.rnot.BatchingNotaryService(hub, tn.rnot.InMemoryUniquenessProvider())
        r_started = []
        for stx in [r_spends[i] for i in tn.SMALL]:
            gen = r_svc.process(stx, requester, deadline=deadline)
            r_started.append((gen, next(gen).future))
        r_svc.flush()
        out = []
        for gen, fut in r_started:
            with pytest.raises(StopIteration) as stop:
                gen.send(fut.result())
            out.append(tn.rser.encode(stop.value.value))
        answers["reference", deadline] = out
    assert answers["port", None] == answers["port", 1] == answers["reference", 1] \
        == answers["reference", None]


# -- the scheduler and CorDapp services ----------------------------------------

PERIOD = 1_000_000


def _beats(node):
    from corda_tpu_torch.testing.flows import HeartbeatState

    return sorted(s.state.data.count for s in node.vault.unconsumed_states(HeartbeatState))


def test_scheduled_flow_fires_when_due_and_chains():
    """A HeartbeatState names its flow by the reference's tag
    (`corda_tpu.testing.flows.HeartbeatFlow`): the scheduler resolves it
    in the port, fires it when due, and each beat schedules the next
    until the target."""
    from corda_tpu_torch.testing.flows import make_heartbeat_tx

    net, notary, alice, _ = make_net()
    make_heartbeat_tx(alice, notary.party, target=3, period=PERIOD)
    net.run()
    assert _beats(alice) == [0] and alice.scheduler.pending_count() == 1
    assert alice.scheduler.next_wakeup_micros() == net.clock.now_micros() + PERIOD
    for want in (1, 2, 3):
        net.clock.advance(PERIOD)
        net.run()
        assert _beats(alice) == [want]
    assert alice.scheduler.pending_count() == 0
    net.clock.advance(10 * PERIOD)
    assert net.run() == 0


def test_consumed_state_cancels_its_activity_and_schedule_rederives():
    from corda_tpu_torch.node.scheduler import NodeSchedulerService
    from corda_tpu_torch.testing.flows import make_heartbeat_tx

    net, notary, alice, _ = make_net()
    make_heartbeat_tx(alice, notary.party, target=3, period=PERIOD)
    stx = make_heartbeat_tx(alice, notary.party, target=4, period=PERIOD)
    net.run()
    # a fresh scheduler over the same services rebuilds the schedule
    alice.scheduler.stop()
    alice.scheduler = NodeSchedulerService(alice.services, alice.smm.start_flow)
    assert alice.scheduler.pending_count() == 2
    b = TransactionBuilder(notary=notary.party)
    b.add_input_state(alice.vault.state_and_ref(StateRef(stx.id, 0)))
    alice.run_flow(FinalityFlow(alice.services.sign_initial_transaction(b)))
    assert alice.scheduler.pending_count() == 1
    net.clock.advance(PERIOD)
    net.run()
    assert _beats(alice) == [1]


@pytest.fixture
def scratch_registry():
    from corda_tpu_torch.node import cordapp

    before = list(cordapp._SERVICE_REGISTRY)
    yield cordapp
    cordapp._SERVICE_REGISTRY[:] = before


def test_cordapp_services_installed_per_node(scratch_registry):
    cordapp = scratch_registry

    @cordapp.corda_service
    class CounterService:
        def __init__(self, services):
            self.services = services

    net, _, alice, bob = make_net()
    sa, sb = (n.services.cordapp_service(CounterService) for n in (alice, bob))
    assert sa is not sb and sa.services is alice.services
    with pytest.raises(KeyError, match="StateMachineManager"):
        alice.services.cordapp_service(StateMachineManager)

    @cordapp.corda_service
    class BrokenService:
        def __init__(self, services):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="BrokenService failed to install: boom"):
        net.create_node("Carol")
