"""On-card self-check of the port's verification path.

Counterpart of corda_tpu/testing/tpu_selfcheck.py: verifies adversarial
requests of the three EC schemes (p256, secp256k1 and ed25519, with
wrong-message, flipped-byte and truncated signatures, plus the ed25519
edge rows of `ed25519_edge_requests`) through CudaBatchVerifier with
both ladders of each curve, and holds every row against the CPU
reference. Run it on a machine with a CUDA card:

    python -m corda_tpu_torch.testing.selfcheck [--n 256] [--batch-size 256]

It refuses a non-CUDA device: on the CPU the kernels would not run and
the check would pass vacuously.
"""

from __future__ import annotations

import hashlib
import random
import time


TAMPERED_KINDS = (5, 6, 7)   # i % 8 of a row that must verify False


def build_requests(n: int, seed: int = 99, scheme_ids=None):
    """Requests incl. tampered/malformed rows: row i has kind i % 8,
    where kind 5 is a wrong message, 6 one flipped signature byte, 7 a
    truncated signature (the reference's kinds, tpu_selfcheck.py).
    Schemes alternate over `scheme_ids` (default p256, k1, ed25519, as
    the reference's build_requests)."""
    from ..crypto import schemes
    from ..crypto.batch_verifier import VerificationRequest

    sids = scheme_ids or (
        schemes.ECDSA_SECP256R1_SHA256,
        schemes.ECDSA_SECP256K1_SHA256,
        schemes.EDDSA_ED25519_SHA512,
    )
    rng = random.Random(seed)
    reqs = []
    for i in range(n):
        sid = sids[i % len(sids)]
        kp = schemes.generate_keypair(sid, seed=rng.getrandbits(64))
        msg = rng.randbytes(48)
        sig = kp.private.sign(msg)
        kind = i % 8
        if kind == 5:
            msg = msg + b"!"                       # wrong message
        elif kind == 6:
            pos = len(sig) // 2
            sig = sig[:pos] + bytes([sig[pos] ^ 1]) + sig[pos + 1:]
        elif kind == 7:
            sig = sig[: len(sig) // 2]             # truncated
        reqs.append(VerificationRequest(kp.public, sig, msg))
    return reqs


def ed25519_edge_requests(seed: int = 5):
    """ed25519 requests at the edges of the reference's semantics
    (refmath.ed25519_verify: cofactorless, encoded-point comparison, no
    s < L check, small-order A not rejected), as (label, request):
    valid; s + L; A.y >= p; R.y >= p; A = identity with R = enc(s*B);
    y = 1 with the sign bit set; A not on the curve; A of order 2 and
    of order 4, each once with k = 0 mod its order and once not. The
    expected decision of each row is the CPU reference's."""
    from ..crypto import refmath, schemes
    from ..crypto.batch_verifier import VerificationRequest
    from ..crypto.curves import ED25519 as c

    rng = random.Random(seed)
    B = (c.gx, c.gy)
    kp = schemes.generate_keypair(schemes.EDDSA_ED25519_SHA512, seed=rng.getrandbits(64))
    msg = rng.randbytes(40)
    sig = kp.private.sign(msg)
    s = int.from_bytes(sig[32:], "little")

    def req(pub: bytes, sig: bytes, m: bytes = msg):
        return VerificationRequest(schemes.PublicKey(schemes.EDDSA_ED25519_SHA512, pub), sig, m)

    def enc(y: int, sign: int = 0) -> bytes:
        return (y | (sign << 255)).to_bytes(32, "little")

    def k_of(r_enc: bytes, pub: bytes, m: bytes) -> int:
        return int.from_bytes(hashlib.sha512(r_enc + pub + m).digest(), "little") % c.L

    rows = [
        ("valid", req(kp.public.data, sig)),
        ("s + L", req(kp.public.data, sig[:32] + (s + c.L).to_bytes(32, "little"))),
        ("A.y >= p", req(enc(c.p + 1), sig)),
        ("R.y >= p", req(kp.public.data, enc(c.p + 3) + sig[32:])),
    ]
    s1 = rng.randrange(c.L)
    r1 = refmath.ed_compress(c, refmath.ed_mul(c, s1, B))
    rows.append(("A = identity, R = enc(s*B)", req(enc(1), r1 + s1.to_bytes(32, "little"))))
    rows.append(("y = 1, sign bit set", req(enc(1, 1), r1 + s1.to_bytes(32, "little"))))
    y_off = 2
    while refmath.ed_decompress(c, enc(y_off)) is not None:
        y_off += 1
    rows.append(("A not on the curve", req(enc(y_off), sig)))
    sqrt_m1 = pow(2, (c.p - 1) // 4, c.p)
    for order, pub in ((2, enc(c.p - 1)), (4, enc(0, sqrt_m1 & 1))):
        # R' = s*B - k*A equals s*B iff k = 0 mod the order of A: search
        # messages for one of each
        found = {}
        while len(found) < 2:
            m = rng.randbytes(24)
            found.setdefault(k_of(r1, pub, m) % order == 0, m)
        for zero in (True, False):
            label = f"A of order {order}, k {'=' if zero else '!='} 0 mod {order}"
            rows.append((label, req(pub, r1 + s1.to_bytes(32, "little"), found[zero])))
    return rows


def _tile(rows: list, n: int) -> list:
    return [rows[i % len(rows)] for i in range(n)]


def _digits(vals, curve, rng, lazy_every: int = 0):
    """[22, n] int32 digits of vals in the ladder's 2^264 Montgomery
    domain: canonical, or on every lazy_every-th row plus p, 2p or 3p
    (below 4p, the plain ladders' bound), as a lazily reduced plain
    ladder leaves them."""
    from ..crypto.limbs import R_BITS, ints_to_batch

    p = curve.p
    out = []
    for i, v in enumerate(vals):
        m = (v << R_BITS) % p
        if lazy_every and i % lazy_every == 1:
            m += rng.randrange(1, 4) * p
        out.append(m)
    return ints_to_batch(out)


def ed25519_prologue_rows(n: int, seed: int = 7):
    """n rows for the ed25519 prologue (eddsa.ed_prologue): ([n, 128]
    uint8 records s|k|A.y|R.y, [n] int32 A-sign bits, [n] bool
    valid_in). First the crafted rows, each with sign 0 and 1: A.y = 0
    (x = sqrt(-1) or its negative), 1 (x = 0), p - 1 (x = 0), p, p + 5
    and 2^255 - 1 (y >= p), a y off the curve, s = 2^256 - 1 and a
    row with valid_in False; then the staged build_requests and
    ed25519_edge_requests rows; then valid points (either square-root
    branch) with random s and k; tiled to n."""
    import numpy as np

    from ..crypto import refmath, schemes
    from ..crypto.curves import ED25519 as c
    from ..crypto.encodings import stage_ed25519_packed_py

    rng = random.Random(seed)

    def rec(s: int, k: int, y: int, ry: int) -> bytes:
        return b"".join(v.to_bytes(32, "big") for v in (s, k, y, ry))

    y_off = 2
    while refmath.ed_decompress(c, y_off.to_bytes(32, "little")) is not None:
        y_off += 1
    rows = []
    for y in (0, 1, c.p - 1, c.p, c.p + 5, (1 << 255) - 1, y_off):
        for sign in (0, 1):
            rows.append((rec(rng.randrange(c.L), rng.randrange(c.L), y, 1), sign, True))
    rows.append((rec((1 << 256) - 1, c.L - 1, 1, 1), 0, True))
    rows.append((rec(5, 7, 1, 1), 0, False))
    reqs = build_requests(24, seed=seed, scheme_ids=(schemes.EDDSA_ED25519_SHA512,))
    reqs += [r for _, r in ed25519_edge_requests(seed)]
    packed, a_sign, _, valid = stage_ed25519_packed_py(
        [(r.key.data, r.signature, r.message) for r in reqs], len(reqs))
    rows += [(bytes(packed[i]), int(a_sign[i]), bool(valid[i])) for i in range(len(reqs))]
    for _ in range(24):
        x, y = refmath.ed_mul(c, rng.randrange(1, c.L), (c.gx, c.gy))
        rows.append((rec(rng.getrandbits(256), rng.randrange(c.L), y, rng.randrange(c.p)),
                     x & 1, True))
    rows = _tile(rows, n)
    return (np.frombuffer(b"".join(r for r, _, _ in rows), np.uint8).reshape(n, 128).copy(),
            np.array([sg for _, sg, _ in rows], np.int32), np.array([v for _, _, v in rows], bool))


def ed25519_epilogue_rows(n: int, seed: int = 7):
    """n rows for the ed25519 epilogue (eddsa.ed_epilogue): ((X, Y, Z,
    T) as [22, n] int32 digits of an extended point in the 2^264
    Montgomery domain, some lazily reduced; [n, 128] uint8 records whose
    R.y the check reads; [n] int32 R-sign bits; [n] bool ok). Rows per
    point: R.y and the sign matching (accepted), the sign flipped, R.y +
    p (non-canonical), ok False; and Z = 0 (x = y = 0 after the
    inverse); tiled to n."""
    import numpy as np

    from ..crypto import refmath
    from ..crypto.curves import ED25519 as c

    rng = random.Random(seed)
    p = c.p
    rows = []                 # (x, y, z, R.y, sign, ok)
    for _ in range(16):
        x, y = refmath.ed_mul(c, rng.randrange(1, c.L), (c.gx, c.gy))
        z = rng.randrange(1, p)
        rows += [(x, y, z, y, x & 1, True), (x, y, z, y, 1 - (x & 1), True),
                 (x, y, z, y + p, x & 1, True), (x, y, z, y, x & 1, False)]
    rows.append((5, 7, 0, 0, 0, True))
    rows = _tile(rows, n)
    X = _digits([x * z % p for x, _, z, _, _, _ in rows], c, rng, 5)
    Y = _digits([y * z % p for _, y, z, _, _, _ in rows], c, rng, 5)
    Z = _digits([z for _, _, z, _, _, _ in rows], c, rng, 5)
    T = _digits([x * y * z % p for x, y, z, _, _, _ in rows], c, rng)
    packed = np.zeros((n, 128), np.uint8)
    for i, row in enumerate(rows):
        packed[i, 96:] = np.frombuffer(row[3].to_bytes(32, "big"), np.uint8)
    return ((X, Y, Z, T), packed, np.array([r[4] for r in rows], np.int32),
            np.array([r[5] for r in rows], bool))


def ecdsa_prologue_rows(curve, n: int, seed: int = 7):
    """n rows for the ECDSA prologue (ecdsa.ecdsa_prologue) on `curve`:
    ([n, 160] uint8 records z|r|s|qx|qy, [n] bool valid_in). First the
    crafted rows: a valid signature, z >= n and z = 2^256 - 1, r = 0,
    r = n, r = n - 1, s = 0, s = n, s = 2^256 - 1, qx >= p (on the
    curve mod p), qy >= p, Q off the curve, Q = G, a row accepted only
    through r + n, and one with valid_in False; then 24 signatures over
    seeded keys, hashes and nonces with build_requests' kinds (row i has
    kind i % 8: 5 a wrong hash, 6 a flipped byte of s, 7 a truncated
    signature, staged as the benign record with valid_in False); tiled
    to n. Every value comes from the seed, so rows(n) are the first n
    rows of rows(m) for n <= m."""
    import numpy as np

    from ..crypto import refmath
    from ..crypto.encodings import _sqrt_mod

    rng = random.Random(seed)
    c = curve
    G = (c.gx, c.gy)

    def rec(z, r, s, qx, qy) -> bytes:
        return b"".join(v.to_bytes(32, "big") for v in (z, r, s, qx, qy))

    def y_of(x):
        return _sqrt_mod((x ** 3 + c.a * x + c.b) % c.p, c.p)

    def signed():
        d = rng.randrange(1, c.n)
        z = rng.randrange(1 << 256)
        k = rng.randrange(1, c.n)
        r = refmath.wei_mul(c, k, G)[0] % c.n
        return z, r, pow(k, -1, c.n) * (z + r * d) % c.n, refmath.wei_mul(c, d, G)

    z, r, s, Q = signed()
    x0 = 0
    while y_of(x0) is None:
        x0 += 1
    rows = [rec(z, r, s, *Q), rec(c.n + 5, r, s, *Q), rec((1 << 256) - 1, r, s, *Q),
            rec(z, 0, s, *Q), rec(z, c.n, s, *Q), rec(z, c.n - 1, s, *Q),
            rec(z, r, 0, *Q), rec(z, r, c.n, *Q), rec(z, r, (1 << 256) - 1, *Q),
            rec(z, r, s, x0 + c.p, y_of(x0)), rec(z, r, s, Q[0], c.p),
            rec(z, r, s, Q[0], (Q[1] + 1) % c.p), rec(z, r, s, *G)]
    # the c1 = r + n candidate: a point R with n <= x_R < p, r = x_R - n,
    # z = 0 and Q = (s / r) * R make u2 * Q = R: x_R == r + n (mod p)
    x = c.n + rng.randrange(1, 1 << 64)
    while y_of(x) is None or x >= c.p:
        x += 1
    r1, s1 = x - c.n, rng.randrange(1, c.n)
    rows.append(rec(0, r1, s1, *refmath.wei_mul(c, s1 * pow(r1, -1, c.n) % c.n, (x, y_of(x)))))
    valid = [True] * len(rows)
    rows.append(rows[0])
    valid.append(False)
    for i in range(24):
        z, r, s, Q = signed()
        kind = i % 8
        if kind == 7:
            rows.append(rec(0, 1, 1, G[0], G[1]))
        else:
            rows.append(rec(z + (kind == 5), r, s ^ (1 << 128) * (kind == 6), *Q))
        valid.append(kind != 7)
    rows, valid = _tile(rows, n), _tile(valid, n)
    return (np.frombuffer(b"".join(rows), np.uint8).reshape(n, 160).copy(),
            np.array(valid, bool))


def ecdsa_epilogue_rows(curve, n: int, seed: int = 7):
    """n rows for the ECDSA epilogue (ecdsa.ecdsa_epilogue) on `curve`:
    ((X, Y, Z) as [22, n] int32 digits in the 2^264 Montgomery domain,
    some lazily reduced; [n, 160] uint8 records whose r the check reads;
    [n] bool valid). Rows: x_R = r (accepted), x_R = r + n < p
    (accepted through r + n only), r + n >= p with X = (r + n) Z
    (refused by the gate), r = 2^256 - 1 with X = r Z (r + n past
    2^256), a wrong r, Z = 0 (infinity), valid False; tiled to n."""
    import numpy as np

    rng = random.Random(seed)
    c, p = curve, curve.p
    rows = []                 # (x_R, z, r, valid)
    for _ in range(8):
        zz = rng.randrange(1, p)
        xr = rng.randrange(c.n)
        rows += [(xr, zz, xr, True), (xr, zz, (xr + 1) % c.n, True), (xr, zz, xr, False)]
        x1 = c.n + rng.randrange(p - c.n)
        rows += [(x1, zz, x1 - c.n, True)]
        r2 = p - c.n + rng.randrange(1, 1 << 16)
        rows += [(r2 + c.n - p, zz, r2, True)]
        rows += [(((1 << 256) - 1) % p, zz, (1 << 256) - 1, True)]
    rows += [(0, 0, 5, True), (0, 0, 0, True)]
    rows = _tile(rows, n)
    X = _digits([xr * zz % p for xr, zz, _, _ in rows], c, rng, 3)
    Y = _digits([rng.randrange(p) for _ in rows], c, rng)
    Z = _digits([zz for _, zz, _, _ in rows], c, rng, 3)
    packed = np.zeros((n, 160), np.uint8)
    for i, (_, _, r, _) in enumerate(rows):
        packed[i, 32:64] = np.frombuffer(r.to_bytes(32, "big"), np.uint8)
    return (X, Y, Z), packed, np.array([v for _, _, _, v in rows], bool)


def run(n: int = 256, batch_size: int = 256, device: str = "cuda") -> dict:
    """Verify n adversarial requests and the ed25519 edge rows on
    `device` with the plain and the windowed ladders and compare against
    the CPU reference; raises RuntimeError on any mismatch, on a kernel
    that never launched, or on a non-CUDA device."""
    import torch

    from ..crypto import cuda_ec
    from ..crypto.batch_verifier import CpuBatchVerifier, CudaBatchVerifier

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} is not an available CUDA device — the "
            "ladder kernels would not run"
        )
    reqs = build_requests(n) + [r for _, r in ed25519_edge_requests()]
    cpu = CpuBatchVerifier().verify_batch(reqs)
    counters = {
        True: ("wei_ladder_windowed_launches", "ed_ladder_windowed_launches"),
        False: ("wei_ladder_launches", "ed_ladder_launches"),
    }
    runs = []
    for windowed, names in counters.items():
        before = {c: getattr(cuda_ec, c) for c in names}
        t0 = time.perf_counter()
        got = CudaBatchVerifier(
            batch_sizes=(batch_size,), device=dev, windowed=windowed
        ).verify_batch(reqs)
        wall = time.perf_counter() - t0
        launched = {c: getattr(cuda_ec, c) - before[c] for c in names}
        mismatches = [i for i, (a, b) in enumerate(zip(got, cpu)) if a != b]
        if mismatches:   # explicit raise: must fire under python -O too
            raise RuntimeError(
                f"windowed={windowed}: device != CPU at rows {mismatches[:10]}"
            )
        idle = [c for c, k in launched.items() if k == 0]
        if idle:
            raise RuntimeError(f"windowed={windowed}: {idle} never launched")
        runs.append({"windowed": windowed, "launches": launched, "wall_s": wall})
    return {
        "device": torch.cuda.get_device_name(dev),
        "n": len(reqs),
        "accepts": sum(cpu),
        "runs": runs,
    }


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="corda_tpu_torch.testing.selfcheck")
    parser.add_argument("--n", type=int, default=256)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    try:
        print(json.dumps(run(args.n, args.batch_size, args.device)))
    except RuntimeError as e:
        raise SystemExit(str(e))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
