"""chip_smoke.py's host-side arithmetic, on the CPU: the bound model
(`_ladder_ops`, the IMAD count a ladder needs for given scalars) and the
dispatch order a streamed flush is checked against; and rehearsals of
its notary phases (6: the flush with its codec check; 7: every scheme
and attachment code, against the reference notary's answers) at a small
size, with counted plain versions standing in for the kernels."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1  # noqa: E402

FIXED = 2 * 4 * 8 * 2   # the entry folds, per row


@pytest.mark.parametrize(
    "windowed, x, y, want",
    [
        # nothing to add: only the conversions
        (False, 0, 0, lambda c: 0),
        # one bit: the top step's add is a copy (its T comes with it)
        (False, 1, 0, lambda c: 0),
        # bits 1,0 of x; bit 0 of y: P + Q built (with T), one doubling
        # (with T: an add follows), the low step adds P + Q (full; the
        # result's T), the top step's P is a copy
        (False, 0b11, 0b01, lambda c: c["madd"] + c["dbl"] + c["add"] + 3 * c["t"]),
        # windows 0x21 / 0x10: Q table (7 dbl + 7 madd, each with T), 4
        # doublings (the last with T), window 0 adds P (mixed; the
        # result's T), window 1's two mixed adds less the copied one
        (True, 0x21, 0x10,
         lambda c: 7 * (c["dbl"] + c["madd"]) + 4 * c["dbl"] + 2 * c["madd"] + 16 * c["t"]),
        # three windows, 8 doublings (the last with T); a Q multiple
        # (digit 3) is a full add (the result's T); the top window's P
        # is a copy
        (True, 0x100, 0x3, lambda c: 7 * (c["dbl"] + c["madd"]) + 8 * c["dbl"] + c["add"] + 16 * c["t"]),
        # one window, two digits: one of its adds (the dearer, the full
        # add of Q multiple 2) is taken as the copy, the other counted,
        # and the result's T
        (True, 0x5, 0x2, lambda c: 7 * (c["dbl"] + c["madd"]) + c["madd"] + 15 * c["t"]),
    ],
)
def test_ladder_ops_by_hand(windowed, x, y, want):
    for cost in (cs.ED_COST, cs._wei_cost(SECP256K1), cs._wei_cost(SECP256R1)):
        got = cs._ladder_ops(cost, 0, windowed, [x], [y])
        assert got - FIXED == want(cost)
        conv = cs._ladder_ops(cost, 5, windowed, [x], [y]) - got
        assert conv == 5 * cost["mul"]


def test_bound_counts_less_than_the_schedule():
    """Dedicated doublings, no identity adds: below every step's full
    add, and the windowed schedule below the plain one."""
    import random

    rng = random.Random(5)
    ss = [rng.randrange(ED25519.L) for _ in range(64)]
    ks = [rng.randrange(ED25519.L) for _ in range(64)]
    plain, windowed = cs._ed_ops(False, ss, ks), cs._ed_ops(True, ss, ks)
    schedule = sum((1 + 2 * max(s.bit_length(), k.bit_length())) * cs.ED_COST["add"]
                   for s, k in zip(ss, ks))
    assert windowed < plain < schedule


def test_formula_costs():
    """The multiplies per operation, by hand: Edwards (ed_ladder.cu)
    add of a cached operand 7M, of a cached affine one 6M, doubling
    3M + 4S, each + 1M for T where the result must carry it, at the
    special-form cost of 2^255 - 19 (64 products + 8 by 38; a square 36
    + 8); RCB15 for the Weierstrass kernels, which have no T, at the
    Montgomery cost (64 + 64 products + 8)."""
    assert (cs.MUL_OPS, cs.SQR_OPS) == (264, 208)
    mul, sqr = cs.ED_MUL_OPS, cs.ED_SQR_OPS
    assert (mul, sqr) == (144, 88)
    assert cs.ED_COST == {"add": 7 * mul, "madd": 6 * mul, "dbl": 3 * mul + 4 * sqr, "t": mul,
                          "mul": mul}
    k1, p256 = cs._wei_cost(SECP256K1), cs._wei_cost(SECP256R1)
    assert k1["t"] == p256["t"] == 0 and k1["mul"] == p256["mul"] == cs.MUL_OPS
    assert k1["dbl"] < p256["dbl"] < p256["madd"] < p256["add"] == k1["add"]
    with pytest.raises(ValueError):
        cs._wei_cost(SimpleNamespace(name="a=1", a=1, p=SECP256R1.p))


def test_dispatch_order():
    def req(sid):
        return SimpleNamespace(key=SimpleNamespace(scheme_id=sid))

    reqs = [req(s) for s in (4, 2, 3, 4, 2, 3, 4)]
    assert cs._dispatch_order(reqs) == [0, 3, 6, 1, 4, 2, 5]
    assert cs._dispatch_order([req(2)] * 5) == list(range(5))


@pytest.mark.parametrize("batch", cs.PARITY_SIZES)
def test_ladder_inputs_at_parity_sizes(batch):
    """The Weierstrass parity inputs at every size the card checks
    (B = 256, the ragged 130 and 1): [22, B] tensors, the edge rows
    first (u1 = 0 in row 0; u2 = n - u1 with Q = G in row 3, where B
    reaches it)."""
    import torch

    for curve in (SECP256R1, SECP256K1):
        args, (u1s, u2s, qs) = cs._ladder_inputs(curve, batch, 7, torch.device("cpu"))
        assert [tuple(a.shape) for a in args] == [(22, batch)] * 4
        assert len(u1s) == len(u2s) == len(qs) == batch and u1s[0] == 0
        if batch > 3:
            assert u1s[3] + u2s[3] == curve.n and qs[3] == (curve.gx, curve.gy)


@pytest.mark.parametrize("batch", cs.PARITY_SIZES)
def test_ed_inputs_at_parity_sizes(batch):
    """The Edwards parity inputs at every size the card checks (B = 256,
    the ragged 130 and 1): [22, B] tensors, the edge rows first (s = 0
    in row 0; A = identity in row 2, s = L in row 3, where B reaches
    them)."""
    import torch

    from corda_tpu_torch.crypto.curves import ED25519 as c

    args, (ss, ks, As) = cs._ed_inputs(batch, 7, torch.device("cpu"))
    assert [tuple(a.shape) for a in args] == [(22, batch)] * 4
    assert len(ss) == len(ks) == len(As) == batch and ss[0] == 0
    if batch > 3:
        assert As[2] == (0, 1) and ss[3] == c.L


def _counted_plain_versions(monkeypatch):
    """The kernels' plain versions stand in for the kernels and count a
    launch each; the counts are restored afterwards, for the tests that
    read the counters later in this process."""
    from corda_tpu_torch.crypto import cuda_ec

    for name, counter in cs.COUNTERS.items():
        monkeypatch.setattr(cuda_ec, counter, getattr(cuda_ec, counter))
        plain = getattr(cuda_ec, name + "_plain")

        def counted(*args, _plain=plain, _counter=counter):
            setattr(cuda_ec, _counter, getattr(cuda_ec, _counter) + 1)
            return _plain(*args)

        monkeypatch.setattr(cuda_ec, name + "_plain", counted)


@pytest.fixture
def one_thread():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)   # faster on 16-row tensors; spares the other workers
    yield
    torch.set_num_threads(saved)


SMALL_FIXTURE = dict(outputs_per_issue=8, bad_every=8, wrong_notary_every=16,
                     owners_per_scheme=4, workers=1)


def test_notary_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_notary end to end at a small size on the CPU:
    the kernels' plain versions stand in for the kernels and count a
    launch each, so the phase's checks (the native-against-Python codec
    check, answers against labels, the card's verdicts against
    CpuBatchVerifier, notary signatures, the launches of ed_ladder and
    wei_ladder_windowed, no degraded flush) all run."""
    import torch

    _counted_plain_versions(monkeypatch)
    monkeypatch.setenv("CORDA_TPU_NOTARY_PROFILE", "1")
    monkeypatch.setattr(cs, "NOTARY_SPENDS", 16)
    monkeypatch.setattr(cs, "CHUNK", 16)
    monkeypatch.setattr(cs, "NOTARY_PASSES", ("timed",))
    monkeypatch.setattr(cs, "NOTARY_FIXTURE", SMALL_FIXTURE)
    rates, fx = cs.phase_notary(torch.device("cpu"), "cpu rehearsal")
    assert set(rates) == {1, 4} and len(fx.spends) == 16
    out = capsys.readouterr().out
    assert "notary shards=4 timed phase_seconds" in out and "'ed_ladder': 0" not in out
    assert "codec check: 16 spends byte-equal, ids equal" in out


def test_codec_check_raises_on_a_difference(monkeypatch):
    """Phase 6's codec check raises when the native and Python codecs
    disagree on a spend's bytes."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.testing.notary_fixture import build_fixture

    fx = build_fixture(4, **SMALL_FIXTURE)
    wire = [ser.encode(s) for s in fx.spends]
    real = ser.encode_py
    monkeypatch.setattr(ser, "encode_py", lambda v: real(v) + (b"!" if isinstance(
        v, type(fx.spends[0])) else b""))
    with pytest.raises(RuntimeError, match="re-encodes differently"):
        cs._check_codecs(wire, "cpu")


def test_every_scheme_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_schemes at a small size on the CPU (16 base
    spends): RSA and SPHINCS rows verified on the host in the flush's one
    dispatch, the attachment contract run in the sandbox, every answer
    its label — and the reference's batching notary, given the same
    bytes, answers every spend with the same label."""
    import torch

    import test_torch_notary as tn
    from corda_tpu_torch.testing import notary_fixture
    from corda_tpu_torch.testing.notary_fixture import answer_kind, build_fixture

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cs, "SCHEME_BASE", 16)
    monkeypatch.setattr(cs, "SCHEME_BATCHES", (16, 64))
    made = []
    real = notary_fixture.build_scheme_fixture
    monkeypatch.setattr(notary_fixture, "build_scheme_fixture",
                        lambda *a, **k: made.append(real(*a, **k)) or made[-1])
    fx = build_fixture(48, **SMALL_FIXTURE)
    launches = cs.phase_schemes(torch.device("cpu"), "cpu rehearsal", fx)
    assert launches["ed_ladder"] and launches["wei_ladder_windowed"]
    out = capsys.readouterr().out
    assert "every answer its label" in out and "host_rows 6" in out
    sf, = made
    assert sf.kinds.count("rsa") == sf.kinds.count("sphincs") == 3
    assert set(sf.labels) == {"ok", "invalid-signature", "conflict", "wrong-notary",
                              "invalid-transaction"}
    hub, _, requester = tn._reference_hub(fx, tn.StreamedCpu())
    for data in sf.attachments:
        hub.attachments.import_attachment(data)
    r_svc = tn.rnot.BatchingNotaryService(hub, tn.rnot.InMemoryUniquenessProvider())
    r_answers = tn._drive(r_svc, [tn.rser.decode(tn.pser.encode(s)) for s in sf.spends],
                          requester)
    assert [answer_kind(a) for a in r_answers] == sf.labels


def test_flow_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_flows on the CPU: drive 1 (8a) in full, the
    batching notary's flush (8b) at 2 payers of one coin each for shards
    1 and 4, and 8a again over CpuBatchVerifier (8c), whose ledger must
    equal the device path's; the kernels' plain versions stand in for
    the kernels and count a launch each, so the phase's launch check of
    ed_ladder, wei_ladder_windowed and wei_ladder runs too."""
    import torch

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cs, "FLOW_PAYERS", 2)
    monkeypatch.setattr(cs, "FLOW_COINS", 1)
    monkeypatch.setattr(cs, "FLOW_BATCHES", (4,))
    launches = cs.phase_flows(torch.device("cpu"), "cpu rehearsal")
    assert launches["ed_ladder"] and launches["wei_ladder_windowed"] and launches["wei_ladder"]
    out = capsys.readouterr().out
    assert "flow drive (8a): 6 flows completed and 3 refused" in out
    assert "'double spend Alice -> Carol', 'NotaryException', 'conflict'" in out
    assert "flow flush (8b) shards=1: 2 payments" in out and "1 dispatch(es), 2 rows" in out
    assert "flow flush (8b) shards=4: 2 payments" in out
    assert "flow drive (8c) over CpuBatchVerifier" in out


def test_pool_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_pool on the CPU at 32 spends: the pool with two
    workers over the device path (9a), the same through the ingest
    pipeline (9b) with the Merkle-id stage timed, a worker lost mid-batch
    (9c) and the ring-fed notary flush (9d); the kernels' plain versions stand in for the kernels and
    count a launch each, so every check of the phase runs — answers
    against labels and against a CpuBatchVerifier worker, one dispatch
    per drain, the launches, phase 6's notary checks."""
    import torch

    from corda_tpu_torch.testing.notary_fixture import build_fixture

    _counted_plain_versions(monkeypatch)
    monkeypatch.setenv("CORDA_TPU_NOTARY_PROFILE", "1")
    monkeypatch.setattr(cs, "CHUNK", 16)
    monkeypatch.setattr(cs, "POOL_WINDOW", 32)
    monkeypatch.setattr(cs, "POOL_SAMPLE", 8)
    monkeypatch.setattr(cs, "POOL_LOSS", 8)
    monkeypatch.setattr(cs, "POOL_CHUNK", 8)
    fx = build_fixture(32, **SMALL_FIXTURE)
    launches = cs.phase_pool(torch.device("cpu"), "cpu rehearsal", fx)
    for tag in ("9a", "9b", "9d"):
        assert launches[tag]["ed_ladder"] and launches[tag]["wei_ladder_windowed"], tag
    assert launches["9c"]["ed_ladder"]
    out = capsys.readouterr().out
    assert "pool (9a): 32 requests in" in out and "rows per dispatch [16, 16]" in out
    assert "frame bytes per request; rows per dispatch [16, 16]" in out
    assert "pool (9b, ingest shards=4): 32 requests in" in out
    assert "request frames to the workers' rings" in out
    assert "id stage: 32 transactions" in out and "gc seconds/gen-2 collections" in out
    assert out.count(" collections (gen 0/1/2)") == 3     # 9a, 9b and 9d
    assert "8 sampled answers equal a CpuBatchVerifier worker's" in out
    assert "pool worker loss (9c): 8 requests answered exactly once by the survivor" in out
    assert "workers lost 1, redispatched 4" in out
    assert "ring-fed notary (9d): 32 spends fed and flushed" in out


def test_pool_checks_raise_on_a_wrong_answer():
    """Phase 9's answer check refuses a flipped signature answered ok, a
    good spend refused, and an unanswered request."""
    labels = ["ok", "invalid-signature", "conflict", "wrong-notary"]
    bad = "VerificationFailedError: InvalidSignature: invalid signature(s) on X"
    cs._check_pool_answers(["ok", bad, "ok", "ok"], labels, "t")
    for answers in (["ok", "ok", "ok", "ok"], ["ok", bad, bad, "ok"],
                    ["ok", bad, "ok", "unanswered"]):
        with pytest.raises(RuntimeError, match="answered"):
            cs._check_pool_answers(answers, labels, "t")


class _RecordingCpu:
    """A CpuBatchVerifier with the recording verifier's `.calls` and a
    streamed handle: the rehearsal's stand-in for the card."""

    def __init__(self, *_args, **_kw):
        from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

        self._cpu = CpuBatchVerifier()
        self.calls = []

    def verify_batch(self, requests):
        return self.verify_batch_async(requests).result()

    def verify_batch_async(self, requests):
        from corda_tpu_torch.crypto.batch_verifier import PendingVerification

        out = self._cpu.verify_batch(requests)
        pv = PendingVerification(out, [], host_rows=range(len(out)))
        self.calls.append((list(requests), pv))
        return pv


def test_cluster_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.phase_clusters on the CPU over CPU verifiers, at 64
    spends in 10a and 1,024 Raft entries in 10c: every check of 10a-10e
    runs and passes, and the phase's last check — that ed_ladder,
    wei_ladder_windowed and wei_ladder launched — refuses a run in which
    no kernel did."""
    import torch

    from corda_tpu_torch.testing.notary_fixture import build_fixture

    monkeypatch.setenv("CORDA_TPU_NOTARY_PROFILE", "1")
    monkeypatch.setattr(cs, "_recording_verifier", _RecordingCpu)
    monkeypatch.setattr(cs, "NOTARY_SAMPLE", 8)
    monkeypatch.setattr(cs, "DURABLE_REOPEN", 16)
    monkeypatch.setattr(cs, "RAFT_ENTRIES", 1024)
    fx = build_fixture(64, **SMALL_FIXTURE)
    with pytest.raises(RuntimeError, match="ed_ladder was not launched in the cluster phase"):
        cs.phase_clusters(torch.device("cpu"), "cpu rehearsal", fx)
    out = capsys.readouterr().out
    for shards in (1, 4):
        assert f"durable notary (10a) shards={shards}: 64 spends in" in out
        assert (f"durable notary (10a) shards={shards} reopened: 48 committed inputs read back; "
                "16 double spends answered conflict") in out
    assert "raft drive (10b): 7 flows completed and 1 refused" in out
    assert "raft drive (10b) over CpuBatchVerifier" in out
    assert "raft transfer (10c): 1024 commits through the leader" in out
    assert "1 snapshots (snap_index 1024)" in out and "maps equal at 1030 refs" in out
    assert "bft drive (10d): 7 flows completed and 1 refused" in out
    assert "caught up by state transfer (1 catch-up(s))" in out
    assert "crash drive (10e)" in out and "refused a double spend (conflict)" in out


def test_cluster_checks_raise_on_a_wrong_answer(monkeypatch, tmp_path):
    """Each phase-10 check refuses a wrong answer: a double spend the
    reopened notary signs (10a), a card ledger unlike the CPU run's
    (10b), a rebuilt Raft member short of a ref (10c), live maps that
    differ (10b, 10d), a replica that never catches up (10d), a vault
    page unlike the in-memory network's and a restarted notary that
    forgot its commits (10e)."""
    import torch

    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.node import bft, raft
    from corda_tpu_torch.node.notary import InMemoryUniquenessProvider
    from corda_tpu_torch.testing import mock_network
    from corda_tpu_torch.testing.notary_fixture import build_fixture, notary_hub
    from corda_tpu_torch.core import serialization as ser

    monkeypatch.setattr(cs, "NOTARY_SAMPLE", 8)
    monkeypatch.setattr(cs, "DURABLE_REOPEN", 4)
    # 10a: the "double spends" are the committed spends themselves, which
    # the notary accepts again (the same transaction)
    fx = build_fixture(16, **SMALL_FIXTURE)
    verifier = _RecordingCpu()
    wire = [ser.encode(s) for s in fx.spends]
    monkeypatch.setattr(cs, "_double_spends", lambda fx, picks: [fx.spends[i] for i in picks])
    with pytest.raises(RuntimeError, match="the reopened notary answered"):
        cs.durable_flush(fx, notary_hub(fx, verifier), wire, verifier, 1,
                         str(tmp_path / "n.db"), "cpu")
    # 10b: ledgers and maps
    ledger = {"ids": ["a"], "notary_sigs": [], "refused": [], "balances": {}, "leaders": []}
    cs._same_ledger(ledger, dict(ledger), "t")
    with pytest.raises(RuntimeError, match="the card's ids differ"):
        cs._same_ledger(ledger, {**ledger, "ids": ["b"]}, "t")
    with pytest.raises(RuntimeError, match="committed maps differ"):
        cs._maps_equal([{1: 2}, {1: 2}, {1: 3}], "t")
    # 10c: the rebuilt member's restore drops a ref
    (tmp_path / "raft").mkdir()
    drive = cs.raft_drive(CpuBatchVerifier(), str(tmp_path / "raft"))
    restore = raft.RaftUniquenessProvider._restore

    def lossy(self, state):
        restore(self, state)
        self.committed.pop(next(iter(self.committed)))

    monkeypatch.setattr(raft.RaftUniquenessProvider, "_restore", lossy)
    with pytest.raises(RuntimeError, match="the rebuilt member holds"):
        cs.raft_transfer(drive, 1024, "cpu")
    # 10d: a rebuilt replica that never asks to catch up
    monkeypatch.setattr(bft.BftReplica, "_maybe_request_catchup", lambda self, now: 0)
    with pytest.raises(RuntimeError, match="did not settle|did not catch up"):
        cs.bft_drive(drive["net"], [], "cpu")
    # 10e: a notary whose commits do not survive its restart
    monkeypatch.setattr(mock_network, "PersistentUniquenessProvider",
                        lambda db: InMemoryUniquenessProvider())
    (tmp_path / "crash").mkdir()
    with pytest.raises(RuntimeError, match="signed a double spend"):
        cs.crash_drive(CpuBatchVerifier(), str(tmp_path / "crash"))


def _pool_inputs(n: int):
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing.notary_fixture import build_fixture, notary_hub

    fx = build_fixture(n, **SMALL_FIXTURE)
    hub = notary_hub(fx, CpuBatchVerifier())
    return fx, [stx.to_ledger_transaction(hub) for stx in fx.spends]


def _default_lease(monkeypatch):
    """11d at a few dozen requests holds no heartbeat back: the pool's
    default lease, so that worker 0 is detached in seconds."""
    from corda_tpu_torch.node.verifier import RedispatchPolicy

    monkeypatch.setattr(cs, "TCP_POOL_LEASE", RedispatchPolicy().lease_micros)


def test_node_phase_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase 11 on the CPU at small depth: (a) the trio over
    verifier_backend "cpu" nodes twice, with one concurrent payment per
    payer, leaving the equal ledgers phase 11 requires of the card's run
    and the CPU's; (b) the Raft cluster (its leader stopped, a payment
    under the new one) and the BFT cluster; (c) the two CLI node
    processes over RPC; (d) 32 phase-6 spends through two `--cpu` worker
    processes over TCP, worker 0 killed mid-batch. Every check of each
    part runs and passes."""
    monkeypatch.setattr(cs, "NODE_CONCURRENT", 1)
    one = cs.node_trio_drive(str(tmp_path / "a1"), "cpu")
    two = cs.node_trio_drive(str(tmp_path / "a2"), "cpu")
    cs._same_node_ledger(one["ledger"], two["ledger"])
    assert [r[2] for r in one["ledger"]["refused"]] == [None, "invalid-transaction", "conflict"]
    assert one["ledger"]["balances"]["Carol"] == 140 and len(one["ledger"]["commits"]) >= 7
    assert one["concurrent_flushes"] >= 1 and one["tls"]
    raft = cs.node_cluster_drive(str(tmp_path / "raft"), "cpu", "raft")
    assert len(set(raft["leaders"])) == 2 and raft["refused"][0][2] == "conflict"
    bft = cs.node_cluster_drive(str(tmp_path / "bft"), "cpu", "bft")
    assert bft["balances"] == {"Hub": 100, "Alice": 0}
    cli = cs.cli_drive(str(tmp_path / "cli"), backend="cpu", check_contexts=False)
    assert cli["balances"] == {"CliHub": 300, "CliBob": 700}
    fx, ltxs = _pool_inputs(32)
    _default_lease(monkeypatch)
    pool = cs.pool_tcp_drive(str(tmp_path / "pool"), ltxs, fx.spends, cpu_workers=True,
                             check_contexts=False)
    cs._check_pool_answers(pool["answers"], fx.labels, "t")
    assert pool["lost"] == 1 and pool["redispatched"] > 0 and pool["deliver_s"] is not None
    assert 0 < pool["silence_s"] < pool["lease_s"]
    assert pool["survivor"][0].startswith("verifier worker w1: ")


def test_node_checks_raise_on_a_wrong_answer(monkeypatch, tmp_path):
    """Each phase-11 check refuses a wrong answer: card and CPU ledgers
    that differ, a "double spend" the notary signs (11a), a balance off
    by one (11b), node processes that add no CUDA context (11c), and a
    pool run in which no worker is killed (11d)."""
    ledger = {"ids": ["a"], "refused": [], "balances": {}, "consumed": [], "commits": []}
    cs._same_node_ledger(ledger, dict(ledger))
    for key, wrong in (("ids", ["b"]), ("consumed", ["x"]), ("commits", [[1]])):
        with pytest.raises(RuntimeError, match=f"the card nodes' {key} differ"):
            cs._same_node_ledger(ledger, {**ledger, key: wrong})
    # 11a: the double spend spends a fresh coin, which the notary signs
    monkeypatch.setattr(cs, "NODE_CONCURRENT", 1)
    spend, spends = cs._spend, []

    def fresh_second(node, coin, notary, owner):
        spends.append(coin)
        if len(spends) == 2:
            from corda_tpu_torch.finance import CashState

            coin, = [s for s in node.vault.unconsumed_states(CashState) if s != coin][:1]
        return spend(node, coin, notary, owner)

    monkeypatch.setattr(cs, "_spend", fresh_second)
    with pytest.raises(RuntimeError, match="double spend Alice -> Carol: was not refused"):
        cs.node_trio_drive(str(tmp_path / "a"), "cpu")
    monkeypatch.setattr(cs, "_spend", spend)
    # 11b: a balance off by one
    cash = cs._cash_of
    monkeypatch.setattr(cs, "_cash_of", lambda node: cash(node) + (node.config.name == "Hub"))
    with pytest.raises(RuntimeError, match="bft cluster .11b.: balances"):
        cs.node_cluster_drive(str(tmp_path / "bft"), "cpu", "bft")
    monkeypatch.setattr(cs, "_cash_of", cash)
    # 11c: the node processes add no CUDA context
    monkeypatch.setattr(cs, "_cuda_contexts", lambda: 1)
    monkeypatch.setattr(cs, "_smi_apps", lambda: "1, 600 MiB")
    with pytest.raises(RuntimeError, match="0 new CUDA contexts for 2 node processes"):
        cs.cli_drive(str(tmp_path / "cli"), backend="cpu")
    # 11d: worker 0 is never killed (its lease still expires)
    monkeypatch.setattr(cs, "TCP_POOL_KILL_AT", 2.0)
    _default_lease(monkeypatch)
    fx, ltxs = _pool_inputs(16)
    with pytest.raises(RuntimeError, match="killed at None, workers lost 1"):
        cs.pool_tcp_drive(str(tmp_path / "pool"), ltxs, fx.spends, cpu_workers=True,
                          check_contexts=False)


def test_drives_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_drives end to end on the CPU at small depth: (a)
    the load test through four `verifier_backend = "cpu"` node processes,
    8 commands with both restarts and 5 empty flows, no command failed and
    the model the reference's for the seed; (b) the notary demo, batching
    (2 payments) and single (1), and (d) the trader demo, on MockNetwork's
    default verifier made CpuBatchVerifier; (c) the 30-tx corpus cut to 6
    and a 20-tx ledger's mutation through the card's path on the CPU
    (CudaBatchVerifier(device="cpu"), counted plain versions), every
    verdict its label. Every check and print of the phase runs; the three
    kernels of the path launch in (c)."""
    import torch
    from test_torch_loadtest import SOAK, command_stream

    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing import mock_network

    monkeypatch.setattr(cs, "LOAD_COUNT", 8)
    monkeypatch.setattr(cs, "LOAD_EMPTY", 5)
    monkeypatch.setattr(cs, "DEMO_TXS", (("batching", 2), ("single", 1)))
    monkeypatch.setattr(cs, "FUZZ_CORPUS", (13, 6))
    monkeypatch.setattr(cs, "FUZZ_SCALE", (17, 20))
    monkeypatch.setattr(cs, "FUZZ_SAMPLE", 8)
    monkeypatch.setattr(mock_network, "CudaBatchVerifier", CpuBatchVerifier)
    _counted_plain_versions(monkeypatch)
    load, real = {}, cs.load_drive
    monkeypatch.setattr(cs, "load_drive", lambda root: load.update(
        real(root, "cpu", check_contexts=False)) or load)
    launches = cs.phase_drives(torch.device("cpu"), "cpu rehearsal")
    assert all(launches[k] > 0 for k in ("ed_ladder", "wei_ladder_windowed", "wei_ladder"))
    r = load["result"]
    assert (r.submitted, r.failed, r.reconciled) == (8, 0, True)
    want = command_stream("corda_tpu", cs.LOAD_SEED, ("Alice", "Bob", "Carol"), 8, SOAK)
    assert r.expected == load["totals"] == want["expected"]
    assert [n for n, _ in load["restarts"]] == [want["victims"][0], "Hub"]
    assert set(load["boot_s"]) == {"Hub", "Alice", "Bob", "Carol"}
    assert all(v > 0 for v in load["p50_s"].values()) and load["max_s"] >= load["p50_s"]["all"]
    assert load["empty"]["count"] == 5 and load["contexts"] == (0, None)
    out = capsys.readouterr().out
    for line in ("load test (12a): nodes booted", "notary demo batching (12b): 2 payments",
                 "notary demo single (12b): 1 payments", "every verdict its label",
                 "trader demo (12d): buyer 1 paper, seller 92000", "drives (ph. 12) launches"):
        assert line in out, line


def test_drive_checks_raise_on_a_wrong_answer(monkeypatch):
    """Each phase-12 check refuses a wrong answer: a verifier that accepts
    every row (12c), a notary demo whose transaction carries two notary
    signatures or whose card run differs from the CPU run (12b), a
    trader demo with no paper delivered (12d)."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.samples import notary_demo, trader_demo

    monkeypatch.setattr(cs, "FUZZ_CORPUS", (13, 4))
    monkeypatch.setattr(cs, "FUZZ_SCALE", (17, 4))
    monkeypatch.setattr(cs, "FUZZ_SAMPLE", 4)

    class AcceptsAll:
        def verify_batch(self, requests):
            return [True] * len(requests)

    with pytest.raises(RuntimeError, match="30-tx corpus against its labels"):
        cs.fuzz_drive(AcceptsAll(), CpuBatchVerifier())
    monkeypatch.setattr(cs, "DEMO_TXS", (("single", 1),))
    run = notary_demo.run
    monkeypatch.setattr(notary_demo, "run", lambda *a, **kw: (
        lambda out: ([s * 2 for s in out[0]], out[1]))(run(*a, **kw)))
    with pytest.raises(RuntimeError, match="notary signatures per transaction"):
        cs.notary_demo_drive(CpuBatchVerifier())
    calls = []

    def seeded(*a, **kw):
        calls.append(1)
        return run(*a, **{**kw, "seed": kw["seed"] + len(calls)})

    monkeypatch.setattr(notary_demo, "run", seeded)
    with pytest.raises(RuntimeError, match="differ from the CpuBatchVerifier run"):
        cs.notary_demo_drive(CpuBatchVerifier())
    monkeypatch.setattr(trader_demo, "run", lambda **kw: ([], 92_000))
    with pytest.raises(RuntimeError, match="buyer paper 0"):
        cs.trader_drive(CpuBatchVerifier())


def _fake_window(verifier, reqs, planes):
    """13b's profiler window without a card: the chunk verified as on the
    card, into ledgers of its own, with fixed figures in the keys the
    phase prints."""
    with cs._private_ledgers():
        verdicts = verifier.verify_batch(reqs)
    return {"rows": len(reqs), "verdicts": verdicts, "window_ms": 400.0,
            "capture_s": 0.4, "stop_s": 0.1, "read_s": 0.1,
            "kernels": 3, "kernel_ms": 2.0, "ladder_ms": 1.5, "ladder_share": 0.75,
            "busy_share": 0.005, "plane_busy_fraction": 0.9}


def test_telemetry_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_telemetry at 16 spends on the CPU: the card's path
    on the CPU (CudaBatchVerifier(device="cpu"), counted plain versions),
    a device plane with no device (the CPU node's sampler), one on/off
    pair, the profiler window stood in for (its verdicts still held to
    the flush's), and the profiled worker process on `--cpu`. Every other
    check and print of 13a-13d runs: one compile per key then executes
    only with 0 retraces, the device-0 ledger's dispatches (the two
    flushes and the window's chunk) and requests, the named constraint,
    every answer its label, the worker's exit 0 and its folded stacks."""
    import torch

    from corda_tpu_torch.testing.notary_fixture import build_fixture
    from corda_tpu_torch.utils import device_telemetry as dlib
    from corda_tpu_torch.utils import perf as plib

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cs, "CHUNK", 16)
    monkeypatch.setattr(cs, "NOTARY_SAMPLE", 8)
    monkeypatch.setattr(cs, "TELEMETRY_PAIRS", 1)
    monkeypatch.setattr(cs, "TELEMETRY_WORKER", 8)
    monkeypatch.setattr(cs, "profile_window", _fake_window)
    kernels, devices = plib.get_kernel_accounting(), dlib.get_device_accounting()
    fx = build_fixture(16, **SMALL_FIXTURE)
    out = cs.phase_telemetry(torch.device("cpu"), "cpu rehearsal", fx,
                             sampler=dlib.DeviceSampler(lambda: []), cpu_worker=True)
    # the phase put the process ledgers back
    assert plib.get_kernel_accounting() is kernels and dlib.get_device_accounting() is devices
    assert out["launches"]["ed_ladder"] > 0 and out["launches"]["wei_ladder_windowed"] > 0
    assert out["capacity"] in ("host_pump", "device_compute", "transfer", "commit_plane")
    assert out["worker"]["stacks"] > 0 and out["worker"]["samples"] > 0
    printed = capsys.readouterr().out
    for line in ("telemetry (13a) first pass: 16 spends in",
                 "telemetry (13a) warm pass (13c's first planes-on flush): 16 spends",
                 "retraces 0", '"executes": 1', "telemetry (13a) device ledger cuda:0",
                 "telemetry (13a) capacity: binding", "telemetry (13a) wire (in-memory fabric, "
                 'both endpoints): {"frames_in": 32, "frames_out": 32',
                 "telemetry (13b) profiler window over one warm", "the device plane's busy "
                 "fraction (launch wall) for the same window 0.9000",
                 "telemetry (13c) planes on vs off, 1 interleaved pairs",
                 "min-of-walls overhead", "telemetry (13d) profiled worker (--profile-hz 19)",
                 "8 requests answered", "SIGINT exit 0", "telemetry (ph. 13) launches"):
        assert line in printed, line


def test_telemetry_checks_raise_on_a_wrong_reading(monkeypatch, one_thread):
    """13a refuses a verifier whose keys recompile after mark_warm (a
    retrace); 13b's window arithmetic: the busy share is the union of the
    kernel intervals, and a capture without device time is refused."""
    import torch

    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier
    from corda_tpu_torch.testing.notary_fixture import build_fixture
    from corda_tpu_torch.utils import device_telemetry as dlib

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cs, "CHUNK", 16)
    monkeypatch.setattr(cs, "NOTARY_SAMPLE", 8)
    real = cs._recording_verifier

    def forgetful(batch_sizes, device):
        v = real(batch_sizes, device)
        inner = v.verify_batch_async

        def cold(requests):
            v._warm_shapes.clear()      # every call a first call: retraces
            return inner(requests)

        v.verify_batch_async = cold
        return v

    monkeypatch.setattr(cs, "_recording_verifier", forgetful)
    monkeypatch.setattr(cs, "profile_window", _fake_window)
    fx = build_fixture(8, **SMALL_FIXTURE)
    with pytest.raises(RuntimeError, match="after mark_warm the keys recompiled"):
        cs.phase_telemetry(torch.device("cpu"), "cpu", fx,
                           sampler=dlib.DeviceSampler(lambda: []), cpu_worker=True)
    assert isinstance(cs._recording_verifier((4,), "cpu"), CudaBatchVerifier)

    from torch.autograd import DeviceType

    def evt(start, end, device_type, name="k", annotation=False):
        """A raw profiler event (µs in, ns out, as kineto gives them)."""
        return SimpleNamespace(start_ns=lambda: start * 1000, end_ns=lambda: end * 1000,
                               device_type=lambda: device_type, name=lambda: name,
                               is_user_annotation=lambda: annotation)

    events = [evt(0, 100, DeviceType.CPU), evt(10, 30, DeviceType.CUDA, "ed_ladder_kernel"),
              evt(20, 40, DeviceType.CUDA), evt(60, 70, DeviceType.CUDA),
              evt(5, 95, DeviceType.CUDA, "corda_tpu.verify_dispatch.s4.b16", True)]
    window, kernels = cs._kernel_intervals(events)
    assert window == 100 and len(kernels) == 3     # the annotation is not device work
    assert cs._union_us(kernels) == 40     # 10-40 and 60-70
    assert cs._kernel_intervals([evt(0, 5, DeviceType.CPU)]) == (5, [])


def test_profile_window_on_the_cpu(monkeypatch):
    """13b's window on the CPU: the profiler records the CPU side only, so
    the capture is refused for holding no device time; with device
    activity stood in for, the window's own device plane reads the
    chunk's launch wall as busy (its ledger anchored before the launch),
    and the flushes' process ledgers are left as they were."""
    import torch
    from test_torch_perf import stub_kernels

    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier, VerificationRequest
    from corda_tpu_torch.utils import device_telemetry as dlib

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    stub_kernels(monkeypatch)
    kp = schemes.generate_keypair(schemes.EDDSA_ED25519_SHA512, seed=3)
    reqs = [VerificationRequest(kp.public, kp.private.sign(b"m"), b"m")] * 3
    verifier = CudaBatchVerifier(batch_sizes=(4,), device="cpu")
    planes = SimpleNamespace(device=SimpleNamespace(sampler=dlib.DeviceSampler(lambda: [])))
    before = dlib.get_device_accounting().snapshot()
    with pytest.raises(RuntimeError, match="no device time in the capture"):
        cs.profile_window(verifier, reqs, planes)
    monkeypatch.setattr(cs, "_kernel_intervals", lambda events: (
        1000.0, [(0.0, 10.0, "ed_ladder_kernel"), (5.0, 30.0, "k")]))
    win = cs.profile_window(verifier, reqs, planes)
    assert win["verdicts"] == [True] * 3 and win["kernels"] == 2
    assert win["busy_share"] == pytest.approx(0.03) and win["ladder_share"] == pytest.approx(10 / 35)
    assert 0 < win["plane_busy_fraction"] <= 1
    assert dlib.get_device_accounting().snapshot() == before
