"""Host-side wire encodings and batch staging for the ECDSA and ed25519
paths.

Port of corda_tpu/crypto/encodings.py (the EC parts). Everything
consensus-critical about *parsing* signatures lives here, on the host:
strict DER for ECDSA, SEC1 points, ed25519 lengths and SHA-512 mod L.
Malformed inputs are rejected before device dispatch; the device only
sees fixed-width records plus a validity mask.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from . import refmath
from .curves import ED25519, WeierstrassCurve
from .limbs import ints_to_batch


# ---------------------------------------------------------------------------
# ECDSA: strict DER signatures (r, s) and SEC1 public points


def parse_der_ecdsa(sig: bytes) -> Optional[tuple[int, int]]:
    """Strict DER SEQUENCE of two INTEGERs -> (r, s), None if malformed.

    Matches the strict parsing of modern JCA/BouncyCastle providers:
    definite lengths, minimal-length integers, no trailing bytes.
    """
    def read_len(b: bytes, i: int) -> Optional[tuple[int, int]]:
        if i >= len(b):
            return None
        first = b[i]
        if first < 0x80:
            return first, i + 1
        nlen = first & 0x7F
        if nlen == 0 or nlen > 2 or i + 1 + nlen > len(b):
            return None
        val = int.from_bytes(b[i + 1 : i + 1 + nlen], "big")
        if val < 0x80 or (nlen == 2 and val < 0x100):
            return None  # non-minimal length encoding
        return val, i + 1 + nlen

    def read_int(b: bytes, i: int) -> Optional[tuple[int, int]]:
        if i >= len(b) or b[i] != 0x02:
            return None
        ln = read_len(b, i + 1)
        if ln is None:
            return None
        n, j = ln
        if n == 0 or j + n > len(b):
            return None
        body = b[j : j + n]
        if body[0] & 0x80:
            return None  # negative
        if n > 1 and body[0] == 0 and not (body[1] & 0x80):
            return None  # non-minimal integer
        return int.from_bytes(body, "big"), j + n

    if len(sig) < 2 or sig[0] != 0x30:
        return None
    ln = read_len(sig, 1)
    if ln is None:
        return None
    total, i = ln
    if i + total != len(sig):
        return None
    ri = read_int(sig, i)
    if ri is None:
        return None
    r, i = ri
    si = read_int(sig, i)
    if si is None:
        return None
    s, i = si
    if i != len(sig):
        return None
    return r, s


def encode_der_ecdsa(r: int, s: int) -> bytes:
    """Minimal DER encoding of an (r, s) ECDSA signature."""
    def enc_int(v: int) -> bytes:
        body = v.to_bytes((v.bit_length() + 8) // 8 or 1, "big")
        return b"\x02" + _der_len(len(body)) + body

    body = enc_int(r) + enc_int(s)
    return b"\x30" + _der_len(len(body)) + body


def _der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    if n < 0x100:
        return bytes([0x81, n])
    return bytes([0x82, n >> 8, n & 0xFF])


def parse_sec1_point(
    curve: WeierstrassCurve, data: bytes
) -> Optional[tuple[int, int]]:
    """SEC1 point bytes -> affine (x, y), with full on-curve validation.

    Accepts uncompressed (0x04) and compressed (0x02/0x03) forms;
    rejects the point at infinity and off-curve/out-of-range points.
    """
    p = curve.p
    if len(data) == 65 and data[0] == 0x04:
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
        if x >= p or y >= p:
            return None
        if not refmath.wei_on_curve(curve, (x, y)):
            return None
        return (x, y)
    if len(data) == 33 and data[0] in (0x02, 0x03):
        x = int.from_bytes(data[1:], "big")
        if x >= p:
            return None
        rhs = (x * x * x + curve.a * x + curve.b) % p
        y = _sqrt_mod(rhs, p)
        if y is None:
            return None
        if (y & 1) != (data[0] & 1):
            y = p - y
        return (x, y)
    return None


def encode_sec1_point(x: int, y: int) -> bytes:
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _sqrt_mod(a: int, p: int) -> Optional[int]:
    """Square root mod an odd prime (p = 3 mod 4 fast path, else T-S)."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli-Shanks (secp curves are 3 mod 4; kept for generality)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


# ---------------------------------------------------------------------------
# staging: signature tuples -> packed device records


ECDSA_RECORD_BYTES = 160    # z | r | s | qx | qy, 32-byte big-endian each


def stage_ecdsa_packed(
    curve: WeierstrassCurve,
    items: list[tuple[bytes, bytes, bytes]],  # (pubkey_sec1, der_sig, message)
    batch: int,
):
    """Compact staging for ecdsa_verify_packed: ONE [batch, 160] uint8
    array + [batch] valid mask.

    The wire format to the device is raw 32-byte big-endian field
    elements (z, r, s, qx, qy), 160 B per signature. Limb expansion,
    range checks (0 < r,s < n), coordinate bounds and the on-curve check
    all run on the device; the host keeps only what it must: strict DER
    parsing (variable-length, consensus-critical — the same code path as
    the CPU reference), SHA-256, and SEC1 decompression for compressed
    points. Padding rows carry benign values (z=0, r=s=1, Q=G) and
    valid=False. This is the reference's Python loop; its native C
    codec is not ported yet.
    """
    n_items = len(items)
    if n_items > batch:
        raise ValueError(f"{n_items} items do not fit a batch of {batch}")
    g_rec = (
        curve.gx.to_bytes(32, "big") + curve.gy.to_bytes(32, "big")
    )
    benign = b"\x00" * 32 + _ONE32 + _ONE32 + g_rec
    records = []
    valid = np.zeros(batch, dtype=bool)
    for i, (pub, sig, msg) in enumerate(items):
        z_b = hashlib.sha256(msg).digest()
        rs_pair = parse_der_ecdsa(sig)
        pt_b = _sec1_bytes(curve, pub)
        if (
            rs_pair is None
            or pt_b is None
            or rs_pair[0] >> 256
            or rs_pair[1] >> 256
        ):
            records.append(benign)
            continue
        r, s = rs_pair
        records.append(
            z_b + r.to_bytes(32, "big") + s.to_bytes(32, "big") + pt_b
        )
        valid[i] = True
    records.extend([benign] * (batch - n_items))
    packed = np.frombuffer(b"".join(records), dtype=np.uint8).reshape(
        batch, ECDSA_RECORD_BYTES
    )
    return packed, valid


_ONE32 = (1).to_bytes(32, "big")


def _sec1_bytes(curve: WeierstrassCurve, data: bytes) -> Optional[bytes]:
    """SEC1 point -> 64 raw coordinate bytes, WITHOUT the on-curve /
    range checks (those run on device). Compressed points are
    decompressed here (host sqrt); structurally-bad encodings -> None."""
    if len(data) == 65 and data[0] == 0x04:
        return data[1:]
    if len(data) == 33 and data[0] in (0x02, 0x03):
        pt = parse_sec1_point(curve, data)
        if pt is None:
            return None
        return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
    return None


# ---------------------------------------------------------------------------
# ed25519


ED25519_RECORD_BYTES = 128   # s | k | A.y | R.y, 32-byte big-endian each


def stage_ed25519_packed(
    items: list[tuple[bytes, bytes, bytes]],  # (pubkey32, sig64, message)
    batch: int,
):
    """Compact staging for ed25519_verify_packed: ONE [batch, 128] uint8
    array + [batch] int32 A-sign bits + [batch] int32 R-sign bits +
    [batch] valid mask.

    The host keeps SHA-512 (k = H(R||A||M) mod L) and the length checks;
    the decoding of A runs on the device (eddsa.ed_decompress_neg_batch).
    s is staged raw (not reduced mod L), as the reference verifies it.
    Padding and malformed rows carry benign values (s = k = 0, A.y =
    R.y = 1) and valid=False. This is the reference's Python loop; its
    native C codec is not ported yet.
    """
    n_items = len(items)
    if n_items > batch:
        raise ValueError(f"{n_items} items do not fit a batch of {batch}")
    benign = b"\x00" * 64 + _ONE32 * 2
    records = []
    a_signs = np.zeros(batch, dtype=np.int32)
    r_signs = np.zeros(batch, dtype=np.int32)
    valid = np.zeros(batch, dtype=bool)
    mask255 = (1 << 255) - 1
    for i, (pub, sig, msg) in enumerate(items):
        if len(sig) != 64 or len(pub) != 32:
            records.append(benign)
            continue
        s = int.from_bytes(sig[32:], "little")
        k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % ED25519.L
        aenc = int.from_bytes(pub, "little")
        renc = int.from_bytes(sig[:32], "little")
        records.append(
            s.to_bytes(32, "big")
            + k.to_bytes(32, "big")
            + (aenc & mask255).to_bytes(32, "big")
            + (renc & mask255).to_bytes(32, "big")
        )
        a_signs[i] = (aenc >> 255) & 1
        r_signs[i] = (renc >> 255) & 1
        valid[i] = True
    records.extend([benign] * (batch - n_items))
    packed = np.frombuffer(b"".join(records), dtype=np.uint8).reshape(
        batch, ED25519_RECORD_BYTES
    )
    return packed, a_signs, r_signs, valid


def stage_ed25519_batch(
    items: list[tuple[bytes, bytes, bytes]],  # (pubkey32, sig64, message)
    batch: int,
):
    """Host prefilter + limb staging for the limb-level
    eddsa.ed25519_verify_batch: A decoded on the host (refmath), -A.x
    staged. Failed and padding rows carry A = B, s = k = 0 and
    valid=False."""
    c = ED25519
    n_items = len(items)
    if n_items > batch:
        raise ValueError(f"{n_items} items do not fit a batch of {batch}")
    ss, ks, naxs, nays, eys = [], [], [], [], []
    signs = np.zeros(batch, dtype=np.int32)
    valid = np.zeros(batch, dtype=bool)
    for i, (pub, sig, msg) in enumerate(items):
        ok = len(sig) == 64 and len(pub) == 32
        A = refmath.ed_decompress(c, pub) if ok else None
        if A is None:
            ok = False
            A = (c.gx, c.gy)
            s = k = 0
            ey, sign = 1, 0
        else:
            s = int.from_bytes(sig[32:], "little")
            k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % c.L
            renc = int.from_bytes(sig[:32], "little")
            ey = renc & ((1 << 255) - 1)
            sign = (renc >> 255) & 1
        ss.append(s)
        ks.append(k)
        naxs.append((c.p - A[0]) % c.p)
        nays.append(A[1])
        eys.append(ey)
        signs[i] = sign
        valid[i] = ok
    pad = batch - n_items
    ss += [0] * pad
    ks += [0] * pad
    naxs += [(c.p - c.gx) % c.p] * pad
    nays += [c.gy] * pad
    eys += [1] * pad
    return dict(
        s=ints_to_batch(ss),
        k=ints_to_batch(ks),
        nax=ints_to_batch(naxs),
        nay=ints_to_batch(nays),
        exp_y=ints_to_batch(eys),
        exp_sign=signs,
        valid_in=valid,
    )
