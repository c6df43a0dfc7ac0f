"""chip_smoke.py's host-side arithmetic, on the CPU: the bound model
(`_ladder_ops`, the IMAD count a ladder needs for given scalars) and the
dispatch order a streamed flush is checked against; and rehearsals of
its notary phases (6: the flush with its codec check; 7: every scheme
and attachment code, against the reference notary's answers; 8: the
flows) at a small size, with counted plain versions standing in for
the kernels. Phases 9, 10 and 11 are rehearsed in
test_torch_chip_smoke_nodes.py, 12 and 13 in
test_torch_chip_smoke_drives.py, 14 in test_torch_chip_smoke_planes.py."""

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
