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
        # one bit: the top step's add is a copy
        (False, 1, 0, lambda c: 0),
        # bits 1,0 of x; bit 0 of y: P + Q built, one doubling, the
        # low step adds P + Q (full), the top step's P is a copy
        (False, 0b11, 0b01, lambda c: c["madd"] + c["dbl"] + c["add"]),
        # windows 0x21 / 0x10: Q table (7 dbl + 7 madd), 4 doublings, window 0
        # adds P (mixed), window 1's two mixed adds less the copied one
        (True, 0x21, 0x10, lambda c: 7 * (c["dbl"] + c["madd"]) + 4 * c["dbl"] + 2 * c["madd"]),
        # three windows, 8 doublings; a Q multiple (digit 3) is a full
        # add; the top window's P is a copy
        (True, 0x100, 0x3, lambda c: 7 * (c["dbl"] + c["madd"]) + 8 * c["dbl"] + c["add"]),
    ],
)
def test_ladder_ops_by_hand(windowed, x, y, want):
    for cost in (cs.ED_COST, cs._wei_cost(SECP256K1), cs._wei_cost(SECP256R1)):
        got = cs._ladder_ops(cost, 0, windowed, [x], [y])
        assert got - FIXED == want(cost)
        conv = cs._ladder_ops(cost, 5, windowed, [x], [y]) - got
        assert conv == 5 * cs.MUL_OPS


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
    assert cs.ED_COST["dbl"] < cs.ED_COST["madd"] < cs.ED_COST["add"]
    k1, p256 = cs._wei_cost(SECP256K1), cs._wei_cost(SECP256R1)
    assert k1["dbl"] < p256["dbl"] < p256["madd"] < p256["add"] == k1["add"]
    with pytest.raises(ValueError):
        cs._wei_cost(SimpleNamespace(name="a=1", a=1, p=SECP256R1.p))


def test_dispatch_order():
    def req(sid):
        return SimpleNamespace(key=SimpleNamespace(scheme_id=sid))

    reqs = [req(s) for s in (4, 2, 3, 4, 2, 3, 4)]
    assert cs._dispatch_order(reqs) == [0, 3, 6, 1, 4, 2, 5]
    assert cs._dispatch_order([req(2)] * 5) == list(range(5))


@pytest.mark.parametrize("batch", cs.WEI_PARITY_SIZES)
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
