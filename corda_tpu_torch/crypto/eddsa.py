"""Batched ed25519 (EdDSA) verification, torch + CUDA.

Port of corda_tpu/crypto/eddsa.py with the same semantics: the
cofactorless check with encoded-point comparison of the i2p EdDSAEngine
the reference uses as its default scheme (Crypto.kt:171), i.e.
refmath.ed25519_verify:

  * accept iff encode(s*B - k*A) == R_bytes, with k = SHA-512(R||A||M)
    mod L computed on the host (encodings.stage_ed25519_packed);
  * s is the raw 256-bit little-endian integer: there is no s < L check,
    so s + L verifies like s;
  * small-order A is not rejected.

ed25519_verify_packed runs three stages on the device of its input
tensors, each a CUDA kernel on the card and its plain torch version on
CPU tensors:

  * ed_prologue: unpacks [B, 128] byte records and decodes A (RFC 8032
    decoding, returning -A: ed_decompress_neg_batch) into the ladder's
    operands (kernel: csrc/ed_ends.cu ed_prologue_kernel);
  * the ladder R' = s*B + k*(-A) (cuda_ec.ed_ladder or
    ed_ladder_windowed);
  * ed_epilogue: maps R' to affine (a Fermat inverse) and compares the
    canonical y with the raw R.y and the parity of x with the R sign bit
    (kernel: ed_epilogue_kernel).

ed_decompress_neg_batch and the limb-level ed25519_verify_batch (host-
decoded -A; its affine map as torch ops) stay as plain functions.
"""

from __future__ import annotations

import torch

from . import cuda_ec
from .cuda_ec import ed_ladder, ed_ladder_windowed, use_windowed_ladder
from .curves import ED25519
from .ec import ed_ext_to_affine
from .limbs import LIMB_BITS, NLIMB, R_BITS, int_to_limbs
from .modmath import (
    add_mod,
    const_batch,
    eq,
    from_mont,
    is_zero,
    lex_lt,
    mont_canon,
    mont_mul,
    mont_mul_const,
    mont_one,
    mont_pow_const,
    mont_sqr,
    select,
    sub_mod,
    to_mont,
    unpack_be32,
)


def _limb_tuple(x: int) -> tuple[int, ...]:
    return tuple(int(v) for v in int_to_limbs(x))


_P_LIMBS = _limb_tuple(ED25519.p)
_D_MONT = _limb_tuple((ED25519.d << R_BITS) % ED25519.p)
_SQRT_M1_MONT = _limb_tuple(
    (pow(2, (ED25519.p - 1) // 4, ED25519.p) << R_BITS) % ED25519.p
)
_SQRT_EXP = (ED25519.p - 5) // 8
_SQRT_EXP_BITS = tuple(
    (_SQRT_EXP >> i) & 1 for i in range(_SQRT_EXP.bit_length() - 1, -1, -1)
)


def _ladder(windowed: bool | None):
    return ed_ladder_windowed if use_windowed_ladder("ed25519", windowed) else ed_ladder


def _affine_check(R, exp_y, exp_sign, valid):
    """[B] bool: valid, and the affine R' (a Fermat inverse) with the
    canonical y equal to the raw exp_y and x's parity equal to exp_sign."""
    fp = ED25519.fp
    xm, ym = ed_ext_to_affine(fp, R)
    x_std = from_mont(fp, xm)
    y_std = from_mont(fp, ym)
    sign = x_std[0] & 1
    # canonical y' vs raw y-from-bytes: a non-canonical encoding (y >= p)
    # never equals a canonical y', matching encode-and-compare
    return valid & eq(y_std, exp_y) & (sign == exp_sign)


def ed25519_verify_batch(
    s,            # [22,B] signature scalar (raw 256-bit little-endian int)
    k,            # [22,B] SHA512(R||A||M) mod L
    nax,          # [22,B] canonical affine x of -A
    nay,          # [22,B] canonical affine y of -A
    exp_y,        # [22,B] y value from the signature's R bytes (may be >= p)
    exp_sign,     # [B] int32 sign bit from the signature's R bytes
    valid_in,     # [B] bool prefilter (decoding succeeded etc.)
    windowed: bool | None = None,   # None = the ed25519 default ladder
):
    """[B] bool: cofactorless ed25519 verification (the affine map as
    torch ops on either device)."""
    fp = ED25519.fp
    R = _ladder(windowed)(ED25519, s, k, to_mont(fp, nax), to_mont(fp, nay))
    return _affine_check(R, exp_y, exp_sign, valid_in)


def _p_minus(x_canon):
    """p - x for canonical x in [0, p), canonical digits out (borrow
    chain); x == 0 maps to 0 (mod-p negation, matching refmath)."""
    rows = []
    borrow = None
    for i in range(NLIMB):
        d = _P_LIMBS[i] - x_canon[i]
        if borrow is not None:
            d = d - borrow
        borrow = (d < 0).to(torch.int32)
        rows.append(d + (borrow << LIMB_BITS))
    out = torch.stack(rows, dim=0)
    return select(is_zero(x_canon), x_canon, out)


def ed_decompress_neg_batch(y_raw, a_sign):
    """Batched RFC 8032 decoding of A, returning the NEGATED x (the
    verifier wants -A); the device counterpart of refmath.ed_decompress.

    y_raw: [22,B] canonical digits of the encoded y (top bit already
    stripped); a_sign: [B] int32, the encoding's x-parity bit. Returns
    (nax_std, y_std, ok): canonical standard-domain -A.x and y, and the
    per-row verdict (y < p, point on the curve, the x = 0 rule). The
    square root is the p = 5 (mod 8) candidate u v^3 (u v^7)^((p-5)/8)
    with the sqrt(-1) fix, as in refmath.
    """
    c = ED25519
    fp = c.fp
    batch, device = y_raw.shape[1], y_raw.device
    ok_y = lex_lt(y_raw, _P_LIMBS)
    y_std = select(ok_y, y_raw, const_batch(1, batch, device))   # benign for the math

    ym = to_mont(fp, y_std)
    y2 = mont_sqr(fp, ym)
    one_m = mont_one(fp, batch, device)
    u = sub_mod(fp, y2, one_m)                                 # y^2 - 1
    v = add_mod(fp, mont_mul_const(fp, y2, _D_MONT), one_m)    # d y^2 + 1
    v3 = mont_mul(fp, mont_sqr(fp, v), v)
    v7 = mont_mul(fp, mont_sqr(fp, v3), v)
    w = mont_pow_const(fp, mont_mul(fp, u, v7), _SQRT_EXP_BITS)
    cand = mont_mul(fp, mont_mul(fp, u, v3), w)

    chk = mont_canon(fp, mont_mul(fp, v, mont_sqr(fp, cand)), 2)
    u_c = mont_canon(fp, u, 12)
    is_pos = eq(chk, u_c)
    is_neg = eq(chk, _p_minus(u_c)) & ~is_pos
    x_m = select(is_pos, cand, mont_mul_const(fp, cand, _SQRT_M1_MONT))
    on_curve = is_pos | is_neg

    x_std = from_mont(fp, x_m)                # canonical
    x_zero = is_zero(x_std)
    parity = x_std[0] & 1
    # A.x has parity == a_sign; the verifier wants -A, so take the root
    # whose parity DIFFERS from a_sign (0 stays 0)
    nax = select(parity == a_sign, _p_minus(x_std), x_std)
    nax = select(x_zero, x_std, nax)
    ok = ok_y & on_curve & ~(x_zero & (a_sign == 1))
    return nax, y_std, ok


def _unpack(packed):
    """[B, 128] uint8 records -> (s, k, A.y, R.y) as [22, B] digits."""
    pb = packed.t().to(torch.int32)
    return tuple(unpack_be32(pb[32 * i : 32 * i + 32]) for i in range(4))


def ed_prologue_plain(packed, a_sign, valid_in):
    """The plain version of ed_prologue_kernel: (s, k, -A.x, A.y, ok),
    the points in the ladder's 2^264 Montgomery domain (lazily
    reduced), ok = valid_in and the decoding's verdict."""
    fp = ED25519.fp
    s, k, ay_raw, _ = _unpack(packed)
    nax, nay, ok_a = ed_decompress_neg_batch(ay_raw, a_sign)
    return s, k, to_mont(fp, nax), to_mont(fp, nay), valid_in & ok_a


def ed_epilogue_plain(R, packed, exp_sign, ok):
    """The plain version of ed_epilogue_kernel: [B] verdicts from the
    ladder's extended R and the records' R.y."""
    return _affine_check(R, _unpack(packed)[3], exp_sign, ok)


def ed_prologue(packed, a_sign, valid_in):
    """The ladder's operands and the decoding's verdict from [B, 128]
    records: the plain version for CPU tensors, the CUDA kernel
    otherwise (or raise)."""
    if packed.device.type == "cpu":
        return ed_prologue_plain(packed, a_sign, valid_in)
    return cuda_ec.ed_prologue_cuda(packed, a_sign, valid_in)


def ed_epilogue(R, packed, exp_sign, ok):
    """[B] verdicts from the ladder's R: the plain version for CPU
    tensors, the CUDA kernel otherwise (or raise)."""
    if packed.device.type == "cpu":
        return ed_epilogue_plain(R, packed, exp_sign, ok)
    return cuda_ec.ed_epilogue_cuda(R, packed, exp_sign, ok)


def ed25519_verify_packed(packed, a_sign, exp_sign, valid_in, windowed: bool | None = None):
    """[B] bool from [B, 128] uint8 records (s|k|A.y|R.y, 32-byte
    big-endian each; see encodings.stage_ed25519_packed): prologue,
    ladder, epilogue, on the records' device."""
    s, k, nax_m, nay_m, ok = ed_prologue(packed, a_sign, valid_in)
    R = _ladder(windowed)(ED25519, s, k, nax_m, nay_m)
    return ed_epilogue(R, packed, exp_sign, ok)
