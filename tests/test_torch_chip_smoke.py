"""chip_smoke.py's host-side arithmetic, on the CPU: the bound model
(`_ladder_ops`, the IMAD count a ladder needs for given scalars) and the
dispatch order a streamed flush is checked against."""

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


def test_notary_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.phase_notary end to end at a small size on the CPU:
    the kernels' plain versions stand in for the kernels and count a
    launch each, so the phase's checks (answers against labels, the
    card's verdicts against CpuBatchVerifier, notary signatures, the
    launches of ed_ladder and wei_ladder_windowed, no degraded flush)
    all run."""
    import torch

    from corda_tpu_torch.crypto import cuda_ec

    for name, counter in cs.COUNTERS.items():
        # the phase leaves its counts behind: restore them afterwards,
        # for the tests that read the counters later in this process
        monkeypatch.setattr(cuda_ec, counter, getattr(cuda_ec, counter))
        plain = getattr(cuda_ec, name + "_plain")

        def counted(*args, _plain=plain, _counter=counter):
            setattr(cuda_ec, _counter, getattr(cuda_ec, _counter) + 1)
            return _plain(*args)

        monkeypatch.setattr(cuda_ec, name + "_plain", counted)
    monkeypatch.setenv("CORDA_TPU_NOTARY_PROFILE", "1")
    saved_threads = torch.get_num_threads()
    torch.set_num_threads(1)   # faster on 16-row tensors; spares the other workers
    monkeypatch.setattr(cs, "NOTARY_SPENDS", 16)
    monkeypatch.setattr(cs, "CHUNK", 16)
    monkeypatch.setattr(cs, "NOTARY_PASSES", ("timed",))
    monkeypatch.setattr(cs, "NOTARY_FIXTURE", dict(
        outputs_per_issue=8, bad_every=8, wrong_notary_every=16, owners_per_scheme=4, workers=1))
    try:
        rates = cs.phase_notary(torch.device("cpu"), "cpu rehearsal")
    finally:
        torch.set_num_threads(saved_threads)
    assert set(rates) == {1, 4}
    out = capsys.readouterr().out
    assert "notary shards=4 timed phase_seconds" in out and "'ed_ladder': 0" not in out
