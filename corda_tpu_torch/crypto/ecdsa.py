"""Batched ECDSA verification (secp256r1 / secp256k1), torch + CUDA.

Port of corda_tpu/crypto/ecdsa.py with the same semantics:

  * ecdsa_verify_packed unpacks [B, 160] byte records (z|r|s|qx|qy)
    into limbs, checks 0 < r < n, 0 < s < n, coordinates < p and Q on
    the curve, substitutes benign values in failed rows (s=1, r=1, Q=G)
    and builds the second x-candidate c1 = r + n with its c1 < p gate.
  * ecdsa_verify_batch computes u1 = z/s, u2 = r/s mod n with a Fermat
    inverse (torch ops: the prologue), runs the ladder R = u1*G + u2*Q
    (the CUDA kernel on the card, its plain version on CPU tensors), and
    accepts iff R is not infinity and x_R == c (mod n) for c in
    {r, r+n}, checked as c*Z == X (mod p) without an inversion.

Everything runs on the device of the input tensors.
"""

from __future__ import annotations

import torch

from .cuda_ec import curve_tag, use_windowed_ladder, wei_ladder, wei_ladder_windowed
from .curves import WeierstrassCurve
from .ec import wei_is_infinity
from .limbs import R_BITS, int_to_limbs
from .modmath import (
    _const_col,
    add_mod,
    canon,
    const_batch,
    eq,
    from_mont,
    lex_lt,
    mont_canon,
    mont_inv,
    mont_mul,
    mont_mul_const,
    mont_one,
    mont_sqr,
    nonzero,
    select,
    to_mont,
    unpack_be32,
)


def ecdsa_scalars(curve: WeierstrassCurve, z, r, s):
    """The prologue: (u1, u2) = (z/s, r/s) mod n, canonical digits."""
    fn = curve.fn
    w = mont_inv(fn, to_mont(fn, s))
    u1 = from_mont(fn, mont_mul(fn, to_mont(fn, z), w))
    u2 = from_mont(fn, mont_mul(fn, to_mont(fn, r), w))
    return u1, u2


def ecdsa_verify_batch(
    curve: WeierstrassCurve,
    z,          # [22,B] hash ints (not reduced mod n; to_mont reduces)
    r,          # [22,B] canonical, checked 1 <= r < n
    s,          # [22,B] canonical, checked 1 <= s < n
    qx,         # [22,B] canonical affine pubkey (checked on curve)
    qy,         # [22,B]
    c1,         # [22,B] r + n (second x-candidate)
    c1_ok,      # [B] bool: r + n < p
    valid_in,   # [B] bool prefilter result
    windowed: bool | None = None,   # None = the curve's default ladder
):
    """[B] bool: SEC1 ECDSA verification, bit-exact accept/reject."""
    fp = curve.fp
    batch = z.shape[1]
    u1, u2 = ecdsa_scalars(curve, z, r, s)
    qx_m, qy_m = to_mont(fp, qx), to_mont(fp, qy)
    ladder = (
        wei_ladder_windowed
        if use_windowed_ladder(curve_tag(curve), windowed)
        else wei_ladder
    )
    R = ladder(curve, u1, u2, qx_m, qy_m)
    X, _Y, Z = R
    not_inf = ~wei_is_infinity(fp, R)

    # x_R == c (mod n)  <=>  c*Z == X (mod p)
    one = mont_one(fp, batch, z.device)
    rhs = mont_canon(fp, mont_mul(fp, X, one))
    chk0 = eq(mont_canon(fp, mont_mul(fp, to_mont(fp, r), Z)), rhs)
    chk1 = eq(mont_canon(fp, mont_mul(fp, to_mont(fp, c1), Z)), rhs)
    return valid_in & not_inf & (chk0 | (chk1 & c1_ok))


def ecdsa_verify_packed(
    curve: WeierstrassCurve, packed, valid_in, windowed: bool | None = None
):
    """[B] bool from [B, 160] uint8 records (z|r|s|qx|qy, 32-byte
    big-endian each; see encodings.stage_ecdsa_packed).

    Device-side validation replicates the host prefilter bit-exactly:
    0 < r < n, 0 < s < n, coordinates < p, point on curve. Rows failing
    any check verify as False; their values are replaced with benign
    ones (s=1, Q=G) so the shared ladder still runs on defined inputs.
    """
    fp = curve.fp
    pb = packed.t().to(torch.int32)                   # [160, B]
    batch, device = pb.shape[1], pb.device
    z = unpack_be32(pb[0:32])
    r = unpack_be32(pb[32:64])
    s = unpack_be32(pb[64:96])
    qx = unpack_be32(pb[96:128])
    qy = unpack_be32(pb[128:160])

    n_limbs = tuple(int(v) for v in int_to_limbs(curve.n))
    p_limbs = tuple(int(v) for v in int_to_limbs(curve.p))
    r_ok = nonzero(r) & lex_lt(r, n_limbs)
    s_ok = nonzero(s) & lex_lt(s, n_limbs)

    # on-curve: y^2 == x^3 + a*x + b (mod p), in the Montgomery domain
    xm = to_mont(fp, qx)
    ym = to_mont(fp, qy)
    b_mont = const_batch((curve.b << R_BITS) % curve.p, batch, device)
    x3 = mont_mul(fp, mont_sqr(fp, xm), xm)
    rhs = add_mod(
        fp, add_mod(fp, x3, mont_mul_const(fp, xm, curve.a_mont)), b_mont
    )
    q_ok = (
        lex_lt(qx, p_limbs)
        & lex_lt(qy, p_limbs)
        & eq(mont_canon(fp, mont_sqr(fp, ym), 2), mont_canon(fp, rhs, 6))
    )

    # benign substitution for rows that failed a check
    one = const_batch(1, batch, device)
    s_use = select(s_ok, s, one)
    r_use = select(r_ok, r, one)
    qx_use = select(q_ok, qx, const_batch(curve.gx, batch, device))
    qy_use = select(q_ok, qy, const_batch(curve.gy, batch, device))

    # second x-candidate c1 = r + n and its c1 < p gate; exact carry
    # only (bound_mul=1): c1 may exceed p by design
    c1 = canon(fp, r_use + _const_col(n_limbs, device), bound_mul=1)
    c1_ok = lex_lt(c1, p_limbs)

    valid = valid_in & r_ok & s_ok & q_ok
    return ecdsa_verify_batch(
        curve, z, r_use, s_use, qx_use, qy_use, c1, c1_ok, valid,
        windowed=windowed,
    )

