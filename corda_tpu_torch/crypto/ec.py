"""Batched short-Weierstrass point arithmetic (torch).

Port of the Weierstrass half of corda_tpu/crypto/ec.py. Complete
homogeneous-projective addition (Renes–Costello–Batina 2015,
Algorithm 1, arbitrary a): one formula valid for every input pair —
doubling, inverses and the point at infinity (0:1:0) — so scalar
multiplication is a fixed-shape branch-free loop.

Points are tuples of [NLIMB, B] Montgomery-domain (R = 2^264) limb
tensors. These functions are the plain versions the CUDA ladder
kernels in cuda_ec.py are held against.
"""

from __future__ import annotations

from functools import partial

import torch

from . import refmath
from .curves import WeierstrassCurve
from .limbs import NLIMB, R_BITS
from .modmath import (
    MontCtx,
    add_mod,
    const_batch,
    get_bit,
    is_zero,
    mont_canon,
    mont_inv,
    mont_mul,
    mont_mul_const,
    mont_one,
    select,
    sub_mod,
)


def wei_infinity(ctx: MontCtx, batch: int, device):
    z = torch.zeros((NLIMB, batch), dtype=torch.int32, device=device)
    return (z, mont_one(ctx, batch, device), z.clone())


def wei_affine_to_proj(ctx: MontCtx, x_m, y_m):
    return (x_m, y_m, mont_one(ctx, x_m.shape[1], x_m.device))


def wei_add(curve: WeierstrassCurve, P, Q):
    """Complete projective addition, RCB15 Algorithm 1 (generic a).

    12 field muls + 5 muls by curve constants; valid for all P, Q
    including P==Q, P==-Q and the point at infinity.
    """
    ctx = curve.fp
    a = curve.a_mont
    b3 = curve.b3_mont
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    mul = partial(mont_mul, ctx)
    mulc = partial(mont_mul_const, ctx)
    add = partial(add_mod, ctx)
    sub = partial(sub_mod, ctx)

    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t2 = mul(Z1, Z2)
    t3 = add(X1, Y1)
    t4 = add(X2, Y2)
    t3 = mul(t3, t4)
    t4 = add(t0, t1)
    t3 = sub(t3, t4)
    t4 = add(X1, Z1)
    t5 = add(X2, Z2)
    t4 = mul(t4, t5)
    t5 = add(t0, t2)
    t4 = sub(t4, t5)
    t5 = add(Y1, Z1)
    X3 = add(Y2, Z2)
    t5 = mul(t5, X3)
    X3 = add(t1, t2)
    t5 = sub(t5, X3)
    Z3 = mulc(t4, a)
    X3 = mulc(t2, b3)
    Z3 = add(X3, Z3)
    X3 = sub(t1, Z3)
    Z3 = add(t1, Z3)
    Y3 = mul(X3, Z3)
    t1 = add(t0, t0)
    t1 = add(t1, t0)
    t2 = mulc(t2, a)
    t4 = mulc(t4, b3)
    t1 = add(t1, t2)
    t2 = sub(t0, t2)
    t2 = mulc(t2, a)
    t4 = add(t4, t2)
    t0 = mul(t1, t4)
    Y3 = add(Y3, t0)
    t0 = mul(t5, t4)
    X3 = mul(t3, X3)
    X3 = sub(X3, t0)
    t0 = mul(t3, t1)
    Z3 = mul(t5, Z3)
    Z3 = add(Z3, t0)
    return (X3, Y3, Z3)


def wei_select(mask, P, Q):
    """Per-element point select: where(mask, P, Q)."""
    return tuple(select(mask, p, q) for p, q in zip(P, Q))


def wei_is_infinity(ctx: MontCtx, P):
    # Z can be an add-of-muls output, value < 4p
    return is_zero(mont_canon(ctx, P[2], bound_mul=4))


def wei_double_scalar_mul(curve: WeierstrassCurve, u1, u2, Q, nbits: int = 256):
    """R = u1*G + u2*Q batched — Shamir's trick, branch-free.

    u1, u2: standard-domain scalar limb tensors [NLIMB, B] (values
    < 2^nbits). Q: projective Montgomery point. G is the curve
    generator (host constant). nbits complete doublings + nbits
    complete selected adds over the table {inf, G, Q, G+Q}.
    """
    ctx = curve.fp
    batch, device = u1.shape[1], u1.device
    R = 1 << R_BITS
    gx = const_batch((curve.gx * R) % curve.p, batch, device)
    gy = const_batch((curve.gy * R) % curve.p, batch, device)
    G = wei_affine_to_proj(ctx, gx, gy)
    GQ = wei_add(curve, G, Q)
    inf = wei_infinity(ctx, batch, device)

    acc = inf
    for bit_idx in range(nbits - 1, -1, -1):
        acc = wei_add(curve, acc, acc)
        bg = get_bit(u1, bit_idx).bool()
        bq = get_bit(u2, bit_idx).bool()
        lo = wei_select(bg, G, inf)       # bq = 0 row of the table
        hi = wei_select(bg, GQ, Q)        # bq = 1 row
        acc = wei_add(curve, acc, wei_select(bq, hi, lo))
    return acc


def window_digit(x, win_idx: int, w: int):
    """w-bit window digit of a [NLIMB, B] scalar tensor: bits
    [win_idx*w, (win_idx+1)*w) as a [B] int32."""
    d = get_bit(x, win_idx * w)
    for b in range(1, w):
        d = d + (get_bit(x, win_idx * w + b) << b)
    return d


def wei_table_select(digit, entries):
    """Branch-free table lookup: entries[digit] per batch lane.
    `entries` is a python list of points; `digit` a [B] int32."""
    out = entries[0]
    for j in range(1, len(entries)):
        out = wei_select(digit == j, entries[j], out)
    return out


def _g_table_mont(curve: WeierstrassCurve, size: int, r_bits: int = R_BITS):
    """Host-computed multiples 1..size-1 of G as Montgomery-domain
    affine ints (Montgomery radix 2^r_bits)."""
    shift = 1 << r_bits
    pts = []
    P = None
    for _ in range(size - 1):
        P = (
            (curve.gx, curve.gy)
            if P is None
            else refmath.wei_add(curve, P, (curve.gx, curve.gy))
        )
        pts.append(((P[0] * shift) % curve.p, (P[1] * shift) % curve.p))
    return pts


def wei_window_tables(curve: WeierstrassCurve, Q, batch: int, w: int = 4):
    """(g_tab, q_tab) for the w-bit windowed double-scalar-mult: entry
    0 of both is the point at infinity (absorbed by the complete
    formulas), G entries are host constants, Q entries a complete-add
    chain. The same conventions as the reference and the CUDA kernel —
    they are crypto-sensitive."""
    ctx = curve.fp
    device = Q[0].device
    inf = wei_infinity(ctx, batch, device)
    one = mont_one(ctx, batch, device)
    g_tab = [inf] + [
        (const_batch(gx_i, batch, device), const_batch(gy_i, batch, device), one)
        for gx_i, gy_i in _g_table_mont(curve, 1 << w)
    ]
    q_tab = [inf, Q]
    for _ in range(2, 1 << w):
        q_tab.append(wei_add(curve, q_tab[-1], Q))
    return g_tab, q_tab


def wei_double_scalar_mul_windowed(
    curve: WeierstrassCurve, u1, u2, Q, nbits: int = 256, w: int = 4
):
    """R = u1*G + u2*Q batched — fixed-window Shamir, branch-free.

    Per w-bit window: w complete doublings + one add from the constant
    G table + one add from the per-batch Q table (2^w - 2 complete adds
    to build). Entry 0 of both tables is the point at infinity, which
    the complete formulas absorb, so zero digits need no branch.
    """
    if nbits % w:
        raise ValueError(f"nbits {nbits} is not a multiple of w {w}")
    ctx = curve.fp
    batch = u1.shape[1]
    g_tab, q_tab = wei_window_tables(curve, Q, batch, w)
    acc = wei_infinity(ctx, batch, u1.device)
    for win_idx in range(nbits // w - 1, -1, -1):
        for _ in range(w):
            acc = wei_add(curve, acc, acc)
        acc = wei_add(
            curve, acc, wei_table_select(window_digit(u1, win_idx, w), g_tab)
        )
        acc = wei_add(
            curve, acc, wei_table_select(window_digit(u2, win_idx, w), q_tab)
        )
    return acc


def wei_proj_to_affine(ctx: MontCtx, P):
    """(x, y) Montgomery-domain affine; undefined (zeros) at infinity."""
    X, Y, Z = P
    zi = mont_inv(ctx, Z)
    return mont_mul(ctx, X, zi), mont_mul(ctx, Y, zi)
