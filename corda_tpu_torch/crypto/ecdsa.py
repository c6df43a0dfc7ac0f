"""Batched ECDSA verification (secp256r1 / secp256k1), torch + CUDA.

Port of corda_tpu/crypto/ecdsa.py with the same semantics.
ecdsa_verify_packed runs three stages on the device of its input
tensors, each a CUDA kernel on the card and its plain torch version on
CPU tensors:

  * ecdsa_prologue: unpacks [B, 160] byte records (z|r|s|qx|qy),
    checks 0 < r < n, 0 < s < n, coordinates < p and Q on the curve,
    substitutes benign values in failed rows (s=1, r=1, Q=G) and
    computes u1 = z/s, u2 = r/s mod n with a Fermat inverse
    (ecdsa_scalars; kernel: csrc/wei_ends.cu ecdsa_prologue_kernel);
  * the ladder R = u1*G + u2*Q (cuda_ec.wei_ladder or
    wei_ladder_windowed);
  * ecdsa_epilogue: accepts iff R is not infinity and x_R == c (mod n)
    for c in {r, r+n}, the second only where r + n < p, checked as
    c*Z == X (mod p) without an inversion (kernel:
    ecdsa_epilogue_kernel).

ecdsa_scalars stays as a plain function.
"""

from __future__ import annotations

import torch

from . import cuda_ec
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


def _ladder(curve: WeierstrassCurve, windowed: bool | None):
    return (wei_ladder_windowed if use_windowed_ladder(curve_tag(curve), windowed)
            else wei_ladder)


def _x_check(curve: WeierstrassCurve, R, r, c1, c1_ok, valid):
    """[B] bool: valid, R not infinity and x_R == c (mod n) for c in {r,
    c1 = r + n where c1_ok}, as c*Z == X (mod p) without an inversion."""
    fp = curve.fp
    X, _Y, Z = R
    not_inf = ~wei_is_infinity(fp, R)
    one = mont_one(fp, r.shape[1], r.device)
    rhs = mont_canon(fp, mont_mul(fp, X, one))
    chk0 = eq(mont_canon(fp, mont_mul(fp, to_mont(fp, r), Z)), rhs)
    chk1 = eq(mont_canon(fp, mont_mul(fp, to_mont(fp, c1), Z)), rhs)
    return valid & not_inf & (chk0 | (chk1 & c1_ok))


def _limbs(x: int) -> tuple[int, ...]:
    return tuple(int(v) for v in int_to_limbs(x))


def _unpack(packed):
    """[B, 160] uint8 records -> (z, r, s, qx, qy) as [22, B] digits."""
    pb = packed.t().to(torch.int32)                   # [160, B]
    return tuple(unpack_be32(pb[32 * i : 32 * i + 32]) for i in range(5))


def ecdsa_prologue_plain(curve: WeierstrassCurve, packed, valid_in):
    """The plain version of ecdsa_prologue_kernel: (u1, u2, qx_m, qy_m,
    valid), Q in the ladder's 2^264 Montgomery domain (lazily reduced).

    The checks replicate the host prefilter bit-exactly: 0 < r < n,
    0 < s < n, coordinates < p, point on curve. Rows failing any check
    have valid False and benign values (s=1, r=1, Q=G), so the ladder
    still runs on defined inputs.
    """
    fp = curve.fp
    batch, device = packed.shape[0], packed.device
    z, r, s, qx, qy = _unpack(packed)
    n_limbs, p_limbs = _limbs(curve.n), _limbs(curve.p)
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
    u1, u2 = ecdsa_scalars(curve, z, r_use, s_use)
    valid = valid_in & r_ok & s_ok & q_ok
    return u1, u2, to_mont(fp, qx_use), to_mont(fp, qy_use), valid


def ecdsa_epilogue_plain(curve: WeierstrassCurve, R, packed, valid):
    """The plain version of ecdsa_epilogue_kernel: [B] verdicts from the
    ladder's projective R and the records' r."""
    r = _unpack(packed)[1]
    # second x-candidate c1 = r + n and its c1 < p gate; exact carry
    # only (bound_mul=1): c1 may exceed p by design
    c1 = canon(curve.fp, r + _const_col(_limbs(curve.n), r.device), bound_mul=1)
    return _x_check(curve, R, r, c1, lex_lt(c1, _limbs(curve.p)), valid)


def ecdsa_prologue(curve: WeierstrassCurve, packed, valid_in):
    """The ladder's operands and the checks' verdict from [B, 160]
    records: the plain version for CPU tensors, the CUDA kernel
    otherwise (or raise)."""
    if packed.device.type == "cpu":
        return ecdsa_prologue_plain(curve, packed, valid_in)
    return cuda_ec.ecdsa_prologue_cuda(curve, packed, valid_in)


def ecdsa_epilogue(curve: WeierstrassCurve, R, packed, valid):
    """[B] verdicts from the ladder's R: the plain version for CPU
    tensors, the CUDA kernel otherwise (or raise)."""
    if packed.device.type == "cpu":
        return ecdsa_epilogue_plain(curve, R, packed, valid)
    return cuda_ec.ecdsa_epilogue_cuda(curve, R, packed, valid)


def ecdsa_verify_packed(
    curve: WeierstrassCurve, packed, valid_in, windowed: bool | None = None
):
    """[B] bool from [B, 160] uint8 records (z|r|s|qx|qy, 32-byte
    big-endian each; see encodings.stage_ecdsa_packed): prologue,
    ladder, epilogue, on the records' device. Rows failing a check
    verify as False."""
    u1, u2, qx_m, qy_m, valid = ecdsa_prologue(curve, packed, valid_in)
    R = _ladder(curve, windowed)(curve, u1, u2, qx_m, qy_m)
    return ecdsa_epilogue(curve, R, packed, valid)
