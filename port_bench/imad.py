"""The frozen count of a verification's IMAD work, per row.

`verify_roofline` divides this count by what the card could have done
in the verify kernels' device time. The count is the work of one row's
verification as the algorithm stood when the benchmark was defined, and
it never follows the kernels' code: a kernel that does the same
verification with fewer instructions, or folds its ends into the ladder,
reads a higher share of the same work.

What is charged, per row of each scheme:

- ECDSA (p256, secp256k1), for a row whose signature and key decode and
  whose r and s lie in [1, n): the scalars u1 = z/s and u2 = r/s
  (s^(n-2) by fixed 4-bit windows, the record's loads), the
  double-scalar multiplication u1*G + u2*Q (p256: Shamir's trick over
  4-bit windows; secp256k1: over single bits; RCB15 complete formulas),
  and the conversion to affine x and the compare.
- ed25519, for a row of the right lengths: the decoding of A (a square
  root), the double-scalar multiplication S*B - k*A (single bits,
  extended coordinates), and the conversion and compare of R.
- A row the verification rejects before that work (malformed DER, a
  truncated signature, a point off the curve) is charged nothing beyond
  the decoding it did.

Fixed prices per 256-bit product: 264 / 208 IMAD for a Montgomery
multiply / square, 144 / 88 for the 2^255 - 19 form; 2 IMAD per 32-bit
product of a fold (4 x 8 products). `row_bytes` is the matching count
of bytes, for the roofline's other term.
"""

from __future__ import annotations

from . import ec_ref as R

MUL = 264               # 256-bit Montgomery multiply: 8x8 + 8x8 products (2 IMAD each) + 8
SQR = 208               # a Montgomery square: 36 distinct products
ED_MUL = 144            # mod 2^255 - 19: 8x8 products and 8 words times 38
ED_SQR = 88
FOLD = 4 * 8 * 2        # one entry fold into the field's domain

# (multiplies, squares, folds) of the work around the double-scalar
# multiplication. ed25519's decoding: chain_250 (249 squares, 10
# multiplies) and the square root's rest; its conversion: the inverse's
# chain and rest, the compare's multiplies. ECDSA's scalars: s^2 and
# s^3 .. s^15 for the window table, 4 squares per window below the top
# one, the loads; its conversion: X/Z and the compare.
ED_DECODE = (21, 255, 0)
ED_FINISH = (16, 254, 3)
ECDSA_SCALARS = (11 + 13, 2 + 1 + 252, 0)
ECDSA_FINISH = (5, 0, 2)
INV_WINDOW = 4

# the double-scalar multiplication's schedule per scheme: 4-bit windows
# (True) or single bits (False)
WINDOWED = {R.P256: True, R.K1: False, R.ED25519: False}


def _cost(mults: int, squares: int = 0, mul: int = MUL, sqr: int = SQR) -> int:
    return mults * mul + squares * sqr


def _ed_cost(mults: int, squares: int = 0) -> int:
    return _cost(mults, squares, ED_MUL, ED_SQR)


# extended Edwards (a = -1), each without the T product ("t", charged
# where the result must carry T): add of a cached operand 7M, mixed 6M,
# doubling 3M + 4S
ED_STEPS = {"add": _ed_cost(7), "madd": _ed_cost(6), "dbl": _ed_cost(3, 4), "t": _ed_cost(1),
            "mul": ED_MUL}


def _wei_steps(c: R.Weierstrass) -> dict:
    """RCB15 complete formulas (Renes-Costello-Batina 2016, table 1):
    add 12M + 2 by b, mixed add 11M + 2 by b, doubling 6M + 2S + 1 by 3b
    (a = 0) or 8M + 3S + 2 by b (a = -3)."""
    dbl = _cost(7, 2) if c.a == 0 else _cost(10, 3)
    return {"add": _cost(14), "madd": _cost(13), "dbl": dbl, "t": 0, "mul": MUL}


def _step_adds(steps: dict, windowed: bool, x: int, y: int, i: int) -> list:
    if not windowed:
        pair = ((x >> i) & 1, (y >> i) & 1)
        return [] if pair == (0, 0) else [steps["add"] if pair == (1, 1) else steps["madd"]]
    ds, dk = (x >> 4 * i) & 15, (y >> 4 * i) & 15
    return [steps["madd"]] * (ds > 0) + [steps["madd"] if dk == 1 else steps["add"]] * (dk > 0)


def double_scalar(steps: dict, conversions: int, windowed: bool, x: int, y: int) -> int:
    """IMAD of x*P + y*Q for one row: each step of the scalars' length a
    doubling (`width` of them) and its adds, no add of the identity, the
    top step's add a copy; the table the row needs (P + Q, or Q's
    multiples 2..15 as 7 doublings and 7 mixed adds); T where an add
    follows; `conversions` multiplies into and out of the ladder's
    domain and the two input coordinates' folds."""
    width = 4 if windowed else 1
    t = steps["t"]
    ops = 0
    n_steps = -(-max(x.bit_length(), y.bit_length()) // width)
    if n_steps:
        adds = [_step_adds(steps, windowed, x, y, i) for i in range(n_steps)]
        ops += sum(map(sum, adds)) - max(adds[-1]) + width * (n_steps - 1) * steps["dbl"]
        ops += t * (sum(map(len, adds[:-1])) + (n_steps > 1 or len(adds[-1]) == 2))
        if windowed and y:
            ops += 7 * (steps["dbl"] + steps["madd"] + 2 * t)
        elif not windowed and x & y:
            ops += steps["madd"] + t
    return ops + conversions * steps["mul"] + 2 * FOLD


def _window_mults(e: int) -> int:
    mask = (1 << INV_WINDOW) - 1
    return sum(1 for i in range(256 // INV_WINDOW - 1) if (e >> (INV_WINDOW * i)) & mask)


def ecdsa_row(scheme: str, key: bytes, sig: bytes, msg: bytes) -> int:
    c = R.CURVES[scheme]
    scalars = R.ecdsa_scalars(scheme, key, sig, msg)
    if scalars is None:
        return 0
    mults, squares, folds = ECDSA_SCALARS
    ops = _cost(mults + _window_mults(c.n - 2), squares) + folds * FOLD
    ops += double_scalar(_wei_steps(c), 5, WINDOWED[scheme], *scalars)
    mults, squares, folds = ECDSA_FINISH
    return ops + _cost(mults, squares) + folds * FOLD


def ed25519_row(key: bytes, sig: bytes, msg: bytes) -> int:
    scalars = R.ed25519_scalars(key, sig, msg)
    if scalars is None:
        return 0
    s, k, decodes = scalars
    mults, squares, folds = ED_DECODE
    ops = _ed_cost(mults, squares) + folds * FOLD
    if not decodes:
        return ops
    ops += double_scalar(ED_STEPS, 7, WINDOWED[R.ED25519], s, k)
    mults, squares, folds = ED_FINISH
    return ops + _ed_cost(mults, squares) + folds * FOLD


def row_bytes(scheme: str) -> int:
    """The bytes a row's verification must read and write once: z, r, s
    and Q (160) or S, k, A.y, R.y and the two signs (130), and a verdict."""
    return (130 if scheme == R.ED25519 else 160) + 1


def row_imad(scheme: str, key: bytes, sig: bytes, msg: bytes) -> int:
    """The frozen IMAD count of one row's verification."""
    if scheme == R.ED25519:
        return ed25519_row(key, sig, msg)
    return ecdsa_row(scheme, key, sig, msg)
