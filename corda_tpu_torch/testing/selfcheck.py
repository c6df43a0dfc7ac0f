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
