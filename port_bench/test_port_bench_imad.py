"""The frozen count: pinned per-row values for each scheme, and the same
numbers as the kernel tables' cost model (chip_smoke.py) gave when the
benchmark was defined."""

from __future__ import annotations

import pytest

from port_bench import ec_ref as R
from port_bench import imad, traffic

CONFIG = {"schemes": list(R.SCHEMES), "message_bytes": 48, "signers_per_scheme": 4,
          "adversarial": {"wrong_message": 0.125, "flipped_byte": 0.125, "truncated": 0.125}}

# the first valid row of seed 99 per scheme, IMAD as pinned when the
# benchmark was defined
PINNED = {
    R.P256: 1351576,
    R.K1: 1297744,
    R.ED25519: 443064,
}


@pytest.mark.parametrize("scheme", R.SCHEMES)
def test_pinned_first_valid_row(scheme):
    rows = traffic.scheme_rows(99, CONFIG, scheme, 16)
    first = next(r for r in rows if r.kind == "valid")
    assert imad.row_imad(first.scheme, first.key, first.signature, first.message) == PINNED[scheme]


@pytest.mark.parametrize("scheme", R.SCHEMES)
def test_rows_rejected_at_decoding_cost_nothing_more(scheme):
    rows = traffic.scheme_rows(99, CONFIG, scheme, 16)
    truncated = [r for r in rows if r.kind == "truncated"]
    assert truncated
    for r in truncated:
        assert imad.row_imad(r.scheme, r.key, r.signature, r.message) == 0


def test_zero_scalars_cost_only_the_conversions():
    steps = imad.ED_STEPS
    assert imad.double_scalar(steps, 7, False, 0, 0) == 7 * imad.ED_MUL + 2 * imad.FOLD


@pytest.mark.parametrize("scheme", R.SCHEMES)
def test_equal_to_the_kernel_tables_cost_model(scheme):
    """chip_smoke's _wei_ops / _ed_ops and _ends_ops per row, for today's
    ladder per scheme (p256 windowed, secp256k1 and ed25519 bit ladders)."""
    cs = pytest.importorskip("chip_smoke")
    from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1

    curve = {R.P256: SECP256R1, R.K1: SECP256K1, R.ED25519: ED25519}[scheme]
    for r in traffic.scheme_rows(5, CONFIG, scheme, 24):
        if scheme == R.ED25519:
            sc = R.ed25519_scalars(r.key, r.signature, r.message)
            theirs = 0 if sc is None else (cs._ed_ops(False, [sc[0]], [sc[1]])
                                           + cs._ends_ops("ed_prologue", curve, 1)
                                           + cs._ends_ops("ed_epilogue", curve, 1))
        else:
            sc = R.ecdsa_scalars(scheme, r.key, r.signature, r.message)
            theirs = 0 if sc is None else (cs._wei_ops(curve, scheme == R.P256, [sc[0]], [sc[1]])
                                           + cs._ends_ops("ecdsa_prologue", curve, 1)
                                           + cs._ends_ops("ecdsa_epilogue", curve, 1))
        assert imad.row_imad(r.scheme, r.key, r.signature, r.message) == theirs


def test_row_bytes():
    assert imad.row_bytes(R.P256) == imad.row_bytes(R.K1) == 161
    assert imad.row_bytes(R.ED25519) == 131
