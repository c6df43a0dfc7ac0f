"""On-card self-check of the port's ECDSA verification path.

Counterpart of corda_tpu/testing/tpu_selfcheck.py: verifies adversarial
ECDSA requests (p256 and secp256k1, with wrong-message, flipped-byte
and truncated signatures) through CudaBatchVerifier with both ladder
kernels, and holds every row against the CPU reference. Run it on a
machine with a CUDA card:

    python -m corda_tpu_torch.testing.selfcheck [--n 256] [--batch-size 256]

It refuses a non-CUDA device: on the CPU the kernels would not run and
the check would pass vacuously.
"""

from __future__ import annotations

import random
import time


TAMPERED_KINDS = (5, 6, 7)   # i % 8 of a row that must verify False


def build_requests(n: int, seed: int = 99, scheme_ids=None):
    """ECDSA requests incl. tampered/malformed rows: row i has kind
    i % 8, where kind 5 is a wrong message, 6 one flipped signature
    byte, 7 a truncated signature (the reference's kinds,
    tpu_selfcheck.py). Schemes alternate over `scheme_ids` (default
    p256, k1)."""
    from ..crypto import schemes
    from ..crypto.batch_verifier import VerificationRequest

    sids = scheme_ids or (
        schemes.ECDSA_SECP256R1_SHA256, schemes.ECDSA_SECP256K1_SHA256
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


def run(n: int = 256, batch_size: int = 256, device: str = "cuda") -> dict:
    """Verify n adversarial requests on `device` with each ladder and
    compare against the CPU reference; raises RuntimeError on any
    mismatch or on a non-CUDA device."""
    import torch

    from ..crypto import cuda_ec
    from ..crypto.batch_verifier import CpuBatchVerifier, CudaBatchVerifier

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} is not an available CUDA device — the "
            "ladder kernels would not run"
        )
    reqs = build_requests(n)
    cpu = CpuBatchVerifier().verify_batch(reqs)
    runs = []
    for windowed in (True, False):
        counter = "wei_ladder_windowed_launches" if windowed else "wei_ladder_launches"
        before = getattr(cuda_ec, counter)
        t0 = time.perf_counter()
        got = CudaBatchVerifier(
            batch_sizes=(batch_size,), device=dev, windowed=windowed
        ).verify_batch(reqs)
        wall = time.perf_counter() - t0
        launched = getattr(cuda_ec, counter) - before
        mismatches = [i for i, (a, b) in enumerate(zip(got, cpu)) if a != b]
        if mismatches:   # explicit raise: must fire under python -O too
            raise RuntimeError(
                f"windowed={windowed}: device != CPU at rows {mismatches[:10]}"
            )
        if launched == 0:
            raise RuntimeError(f"windowed={windowed}: the ladder kernel never launched")
        runs.append({"windowed": windowed, "launches": launched, "wall_s": wall})
    return {
        "device": torch.cuda.get_device_name(dev),
        "n": n,
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
