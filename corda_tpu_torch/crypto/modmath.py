"""Batched Montgomery modular arithmetic over [NLIMB, B] int32 limb tensors.

PyTorch port of corda_tpu/crypto/modmath.py, same representation and
same bound discipline, so every function here returns the same limb
values as its JAX counterpart:

  * A field element batch is a [22, B] int32 tensor of radix-2^12
    digits, batch minor. Montgomery radix R = 2^264.
  * Schoolbook products are one broadcast multiply [22, 22, B] plus a
    diagonal sum (pad rows to 45, re-view as [22, 44, B], sum axis 0:
    45 = 1 mod 44, so flat columns align with i + j). This is the
    formulation the reference's own module docstring describes; on the
    card it is a handful of elementwise launches per product. The
    reference's int8 MXU Toeplitz constant multiply and `_diag_mul_mxu`
    are TPU matrix-unit workarounds with the same values and are not
    ported.
  * Carries are parallel rounds (shift-mask-add over the limb axis).
  * Lazy reduction: Montgomery outputs live in [0, 2p); subtraction
    adds a precomputed 8p offset whose digits dominate any bounded
    subtrahend. Canonical form is restored only at domain boundaries.

Bound discipline (as in the reference):
  * "bounded" limbs: in [0, 4200); product columns then stay < 2^29.
  * mont_mul accepts values < 12p and returns a value < 2p with bounded
    limbs.
  * add_mod: value < sum of inputs; sub_mod: value < a + 8p.

Every function is shape-polymorphic in B and branch-free on data; the
device is the inputs' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .limbs import LIMB_BITS, LIMB_MASK, NLIMB, R_BITS, int_to_limbs

# ---------------------------------------------------------------------------
# host-side context


def _saturated_digits(value: int) -> tuple[int, ...] | None:
    """Decompose value (= 8p) into 22 digits with digits[0..20] >= 4104.

    Used as the subtraction offset: every low digit dominates any bounded
    limb, and the top digit dominates the top limb of any subtrahend
    < 4p, so a - b + offset has non-negative limbs everywhere. Returns
    None when the top digit can't dominate (scalar-order fields ~2^252,
    which never subtract).
    """
    digits = []
    v = value
    for _ in range(NLIMB - 1):
        r = v % 4096
        d = r + 4096 if r >= 8 else r + 8192
        digits.append(d)
        v = (v - d) >> LIMB_BITS
    if not (40 <= v < (1 << 30)):
        return None
    digits.append(v)
    return tuple(digits)


@dataclass(frozen=True)
class MontCtx:
    """Per-modulus constants, precomputed on host with python ints."""

    p: int
    p_limbs: tuple[int, ...]
    pinv_limbs: tuple[int, ...]    # (-p)^-1 mod R
    r2_limbs: tuple[int, ...]      # R^2 mod p
    r_mod_p: int                   # R mod p  (Montgomery form of 1)
    sub_offset: tuple[int, ...] | None   # 8p as saturated digits
    inv_exp_bits: tuple[int, ...]  # bits of p-2, MSB first (Fermat inverse)

    @staticmethod
    def make(p: int) -> "MontCtx":
        R = 1 << R_BITS
        pinv = (-pow(p, -1, R)) % R
        e = p - 2
        bits = tuple((e >> i) & 1 for i in range(e.bit_length() - 1, -1, -1))
        return MontCtx(
            p=p,
            p_limbs=tuple(int(v) for v in int_to_limbs(p)),
            pinv_limbs=tuple(int(v) for v in int_to_limbs(pinv)),
            r2_limbs=tuple(int(v) for v in int_to_limbs((R * R) % p)),
            r_mod_p=R % p,
            sub_offset=_saturated_digits(8 * p),
            inv_exp_bits=bits,
        )


# device copies of host limb tuples, one per (tuple, device): a fresh
# torch.tensor per call would be a synchronous host->device copy
_CONST_CACHE: dict[tuple[tuple[int, ...], str], torch.Tensor] = {}


def _const_col(limbs: tuple[int, ...], device) -> torch.Tensor:
    """[len(limbs), 1] int32 constant column on `device`."""
    key = (tuple(int(v) for v in limbs), str(torch.device(device)))
    col = _CONST_CACHE.get(key)
    if col is None:
        col = torch.tensor(key[0], dtype=torch.int32, device=device)[:, None]
        _CONST_CACHE[key] = col
    return col


# ---------------------------------------------------------------------------
# carry rounds and products


def _rounds(x: torch.Tensor, n: int):
    """n parallel carry rounds on non-negative columns [K, B].

    Returns (bounded_limbs, carry_out_sum): carries leaving the top limb
    are summed (units of 2^(12K)). Three rounds take columns < 2^30
    down to limbs <= 4096.
    """
    out = torch.zeros_like(x[0])
    for _ in range(n):
        c = x >> LIMB_BITS
        x = x & LIMB_MASK
        x[1:] += c[:-1]
        out = out + c[-1]
    return x, out


def _diag_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Raw schoolbook column sums U[k] = sum_i a[i] * b[k-i] -> [44, B].

    a: [22, B]; b: [22, B] or a [22, 1] constant column. Both bounded
    (< 4200) so columns stay < 2^29.
    """
    n, batch = a.shape
    prod = a[:, None, :] * b[None, :, :]                     # [22, 22, B]
    padded = torch.nn.functional.pad(prod, (0, 0, 0, n + 1))  # [22, 45, B]
    flat = padded.reshape(n * (2 * n + 1), batch)[: n * 2 * n]
    return flat.reshape(n, 2 * n, batch).sum(0, dtype=torch.int32)


def _diag_mul_const(a: torch.Tensor, const_limbs: tuple[int, ...]):
    """Column sums against a host-constant operand -> [44, B]."""
    return _diag_mul(a, _const_col(const_limbs, a.device))


def _mont_reduce(ctx: MontCtx, t_cols: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of raw columns T (< 144 p^2) -> T/R mod p.

    t_cols: [K, B] raw column sums, K <= 44, non-negative, < 2^30.
    Output: value < 2p, bounded limbs.
    """
    if t_cols.shape[0] < 2 * NLIMB:
        t_cols = torch.nn.functional.pad(
            t_cols, (0, 0, 0, 2 * NLIMB - t_cols.shape[0])
        )
    # m = (T mod R) * pinv mod R — dropping columns/carries >= R is free;
    # two rounds bring columns < 2^29 under the 4200 "bounded" limit
    t_lo_b, _ = _rounds(t_cols[:NLIMB], 2)
    m, _ = _rounds(_diag_mul_const(t_lo_b, ctx.pinv_limbs)[:NLIMB], 2)
    # U = T + m*p == 0 (mod R); divide exactly by R
    u = t_cols + _diag_mul_const(m, ctx.p_limbs)
    lo, t_drop = _rounds(u[:NLIMB], 3)
    # remaining low value is a multiple of R in [0, 1.001*R) => 0 or R
    t = t_drop + (lo != 0).any(0).to(torch.int32)
    hi = u[NLIMB:]
    hi[0] += t
    out, _top = _rounds(hi, 3)   # value < 2p fits 22 limbs: _top is zero
    return out


# ---------------------------------------------------------------------------
# public batched ops (stacked [NLIMB, B] int32)


def mont_mul(ctx: MontCtx, a, b):
    """(a*b*R^-1) mod p for Montgomery-domain a, b (values < 12p each)."""
    return _mont_reduce(ctx, _diag_mul(a, b))


def mont_sqr(ctx: MontCtx, a):
    return mont_mul(ctx, a, a)


def mont_mul_const(ctx: MontCtx, a, const_limbs: tuple[int, ...]):
    """a * const * R^-1 mod p, const given as canonical limb tuple."""
    return _mont_reduce(ctx, _diag_mul_const(a, const_limbs))


def add_mod(ctx: MontCtx, a, b):
    """a+b (no reduction — lazy; value grows, limbs rebounded)."""
    s, _ = _rounds(a + b, 1)
    return s


def sub_mod(ctx: MontCtx, a, b):
    """a-b+8p: congruent to a-b mod p, non-negative limbs throughout.

    Contract: b has value < 4p and bounded limbs. Only curve fields
    (p ~ 2^255+) support subtraction.
    """
    if ctx.sub_offset is None:
        raise ValueError("sub_mod unsupported for this modulus (no offset)")
    s, _ = _rounds(a - b + _const_col(ctx.sub_offset, a.device), 1)
    return s


def neg_mod(ctx: MontCtx, a):
    """8p - a, congruent to -a mod p (a < 4p, bounded limbs)."""
    if ctx.sub_offset is None:
        raise ValueError("neg_mod unsupported for this modulus (no offset)")
    s, _ = _rounds(_const_col(ctx.sub_offset, a.device) - a, 1)
    return s


def _lex_ge(rows, b_limbs: tuple[int, ...]):
    """[B] bool: value(rows) >= b, canonical non-negative digits."""
    ge = torch.ones_like(rows[0], dtype=torch.bool)
    for k in range(len(rows)):
        bk = b_limbs[k] if k < len(b_limbs) else 0
        ge = (rows[k] > bk) | ((rows[k] == bk) & ge)
    return ge


def _carry_exact(rows: list) -> list:
    """Exact sequential carry over a list of [B] digit rows."""
    for k in range(NLIMB - 1):
        c = rows[k] >> LIMB_BITS
        rows[k] = rows[k] - (c << LIMB_BITS)
        rows[k + 1] = rows[k + 1] + c
    return rows


def canon(ctx: MontCtx, x, bound_mul: int = 2):
    """Exact canonical form (< p, 12-bit digits) of a value < bound_mul*p."""
    rows = _carry_exact([x[i] for i in range(NLIMB)])
    for _ in range(bound_mul - 1):        # conditional subtracts of p
        ge = _lex_ge(rows, ctx.p_limbs)
        d = _carry_exact([rows[k] - ctx.p_limbs[k] for k in range(NLIMB)])
        rows = [torch.where(ge, d[k], rows[k]) for k in range(NLIMB)]
    return torch.stack(rows, dim=0)


def to_mont(ctx: MontCtx, x):
    """Standard -> Montgomery domain. Accepts any value < R (mods by p)."""
    return mont_mul_const(ctx, x, ctx.r2_limbs)


def from_mont(ctx: MontCtx, x):
    """Montgomery -> standard domain, exact canonical output (< p)."""
    return canon(ctx, _mont_reduce(ctx, x))


def mont_canon(ctx: MontCtx, x, bound_mul: int = 2):
    """Canonical representative of a Montgomery-domain value < bound_mul*p."""
    return canon(ctx, x, bound_mul)


def mont_pow_const(ctx: MontCtx, a, exp_bits: tuple[int, ...]):
    """a^e for host-constant exponent (MSB-first bits), Montgomery domain.

    Square-and-multiply as a Python loop (the reference's lax.scan). The
    exponent is a host constant, so a zero bit skips the multiply the
    reference computes and discards: the values are the same.
    """
    acc = mont_one(ctx, a.shape[1], a.device)
    for bit in exp_bits:
        acc = mont_mul(ctx, acc, acc)
        if bit:
            acc = mont_mul(ctx, acc, a)
    return acc


def mont_inv(ctx: MontCtx, a):
    """a^-1 mod p in Montgomery domain (Fermat; p must be prime)."""
    return mont_pow_const(ctx, a, ctx.inv_exp_bits)


def mont_one(ctx: MontCtx, batch: int, device):
    """Montgomery form of 1, broadcast to [NLIMB, batch]."""
    return const_batch(ctx.r_mod_p, batch, device)


def const_batch(value: int, batch: int, device):
    """Broadcast a host integer to a canonical [NLIMB, batch] limb tensor."""
    limbs = tuple(int(v) for v in int_to_limbs(value))
    return _const_col(limbs, device).expand(NLIMB, batch).contiguous()


def is_zero(a) -> torch.Tensor:
    """[B] bool: canonical value == 0 (canonicalise first if lazy)."""
    return (a == 0).all(0)


def eq(a, b) -> torch.Tensor:
    """[B] bool: canonical values equal (limb-wise)."""
    return (a == b).all(0)


def select(mask, a, b):
    """Per-batch-element select: mask [B] -> where(mask, a, b) on [NLIMB,B]."""
    return torch.where(mask[None, :], a, b)


def unpack_be32(cols):
    """[32, B] big-endian byte columns (int32 0..255) -> [22, B] limbs."""
    a = cols.flip(0)                                  # little-endian bytes
    a = torch.cat([a, torch.zeros_like(a[:1])], dim=0)   # pad byte 32
    t = torch.arange(NLIMB // 2, device=cols.device)
    even = a[3 * t] | ((a[3 * t + 1] & 0xF) << 8)     # [11, B]
    odd = (a[3 * t + 1] >> 4) | (a[3 * t + 2] << 4)
    return torch.stack([even, odd], dim=1).reshape(NLIMB, a.shape[1])


def lex_lt(x, b_limbs):
    """[B] bool: canonical-digit value(x) < b (python-int limb tuple)."""
    lt = torch.zeros_like(x[0], dtype=torch.bool)
    for k in range(NLIMB):
        bk = int(b_limbs[k]) if k < len(b_limbs) else 0
        lt = (x[k] < bk) | ((x[k] == bk) & lt)
    return lt


def nonzero(x):
    """[B] bool: any non-zero digit."""
    return (x != 0).any(0)


def get_bit(x, i: int):
    """Bit i of canonical standard-domain limb tensor x: [B] int32 in {0,1}."""
    return (x[i // LIMB_BITS] >> (i % LIMB_BITS)) & 1
