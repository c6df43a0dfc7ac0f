#!/usr/bin/env python3
"""Smoke run of corda_tpu_torch's ECDSA verification path on one CUDA card.

    python3 chip_smoke.py [--out PATH]

Phases (any failure raises and exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from corda_tpu_torch/csrc with nvcc;
  3. hold each ladder kernel against its plain torch version on the card
     (p256 and secp256k1, B=256, full 264-bit scan, edge rows u1=0,
     u2=0, Q=G and u2=n-u1 with Q=G) — equal normalised points; time
     each kernel and its plain version at the main path's chunk (4096,
     scalars below n) and hold them equal there too;
  4. the main path: a 16,384-row p256 flush (256 distinct signed
     requests with tampered rows, tiled) through
     CudaBatchVerifier(batch_sizes=(128, 1024, 4096)).verify_batch_async
     (...).chunks(), then 4,096 secp256k1 rows; every row must equal the
     CPU reference for its distinct request and its construction label,
     and each kernel's launch counter must have moved;
  5. print the kernel table as one JSON line, then the result line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or of the corda_tpu package.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

CHUNK = 4096
FLUSH = 16384
PARITY_B = 256
DISTINCT = 256
IMAD_PER_SM_PER_CLK = 64     # CUDA C Programming Guide, throughput table, cc 9.0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()   # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _affine(curve, X, Y, Z):
    """Host normalisation of [22, B] projective Montgomery limbs:
    affine (x, y) ints per row, None at infinity."""
    from corda_tpu_torch.crypto import limbs as L

    xs, ys, zs = (L.batch_to_ints(t.cpu().numpy()) for t in (X, Y, Z))
    out = []
    for x, y, z in zip(xs, ys, zs):
        z %= curve.p
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, curve.p)
            out.append(((x * zi) % curve.p, (y * zi) % curve.p))
    return out


def _max_err(curve, got, want, label: str) -> int:
    """Largest coordinate difference of the normalised points; raises
    unless every row is equal (integers: equality is the tolerance)."""
    import torch

    torch.cuda.synchronize()
    err = 0
    for i, (a, b) in enumerate(zip(_affine(curve, *got), _affine(curve, *want))):
        if a != b:
            raise RuntimeError(f"{label} row {i}: kernel {a} != plain {b}")
        if a is not None:
            err = max(err, abs(a[0] - b[0]), abs(a[1] - b[1]))
    return err


def _ladder_inputs(curve, batch: int, seed: int, device, wide: bool = True):
    """u1, u2, qx_m, qy_m at `batch` rows with the edge rows first; with
    `wide`, every 4th row's scalars use all 264 digit bits, else every
    scalar is below n, as the main path gives them."""
    import torch

    from corda_tpu_torch.crypto import limbs as L
    from corda_tpu_torch.crypto import modmath as M
    from corda_tpu_torch.crypto import refmath

    rng = random.Random(seed)
    G = (curve.gx, curve.gy)
    u1s, u2s, qs = [0, 7, 5, 9], [11, 0, 13, curve.n - 9], [None, None, G, G]
    for i in range(4, batch):
        top = wide and i % 4 == 0
        u1s.append(rng.getrandbits(264) if top else rng.randrange(curve.n))
        u2s.append(rng.getrandbits(264) if top else rng.randrange(curve.n))
        qs.append(None)
    distinct = [refmath.wei_mul(curve, rng.randrange(1, curve.n), G) for _ in range(16)]
    qs = [q if q is not None else distinct[i % 16] for i, q in enumerate(qs)]

    def dev(xs):
        return torch.from_numpy(L.ints_to_batch(xs)).to(device)

    qx_m = M.to_mont(curve.fp, dev([q[0] for q in qs]))
    qy_m = M.to_mont(curve.fp, dev([q[1] for q in qs]))
    return (dev(u1s), dev(u2s), qx_m, qy_m), (u1s, u2s, qs)


def _ladder_ops(curve, windowed: bool, u1s, u2s) -> int:
    """IMAD-rate instructions the ladders need for these scalars: each
    row scans only its scalars' bits (w=4 windows for the windowed
    ladder). A 256-bit Montgomery multiply is 8x8 + 8x8 products of
    32x32->64 bits (2 instructions each) + 8 low-half products; an
    RCB15 add is 12 multiplies + 2 by 3b + 3 by a (none where a = 0);
    5 multiplies convert Q in and R out; the entry folds add 2 x 4 x 8
    products."""
    mul = 2 * (64 + 64) + 8
    per_add = 14 + (3 if curve.a % curve.p else 0)
    ops = 0
    for a, b in zip(u1s, u2s):
        bits = max(a.bit_length(), b.bit_length(), 1)
        adds = 14 + 6 * -(-bits // 4) if windowed else 1 + 2 * bits
        ops += (adds * per_add + 5) * mul + 2 * 4 * 8 * 2
    return ops


def phase_parity(device, report: dict) -> None:
    from corda_tpu_torch.crypto import cuda_ec, refmath
    from corda_tpu_torch.crypto.curves import SECP256K1, SECP256R1

    kernels = {
        "wei_ladder_windowed": (cuda_ec.wei_ladder_windowed_cuda, cuda_ec.wei_ladder_windowed_plain),
        "wei_ladder": (cuda_ec.wei_ladder_cuda, cuda_ec.wei_ladder_plain),
    }
    for name, (kern, plain) in kernels.items():
        err = 0
        for curve in (SECP256R1, SECP256K1):
            args, (u1s, u2s, qs) = _ladder_inputs(curve, PARITY_B, 7, device)
            out = kern(curve, *args)
            err = max(err, _max_err(curve, out, plain(curve, *args), f"{name} {curve.name}"))
            got = _affine(curve, *out)
            G = (curve.gx, curve.gy)
            for i in range(8):   # and the plain version against refmath
                ref = refmath.wei_add(
                    curve, refmath.wei_mul(curve, u1s[i], G), refmath.wei_mul(curve, u2s[i], qs[i])
                )
                if ref != got[i]:
                    raise RuntimeError(f"{name} {curve.name} row {i}: {got[i]} != refmath {ref}")
            if got[3] is not None:
                raise RuntimeError(f"{name} {curve.name}: u2 = n - u1, Q = G must give infinity")
            print(f"parity {name} {curve.name} B={PARITY_B}: {PARITY_B} rows equal")
        report[name] = {"max_abs_err": float(err)}


def phase_timing(device, report: dict) -> None:
    import torch

    from corda_tpu_torch.crypto import cuda_ec
    from corda_tpu_torch.crypto.curves import SECP256R1, SECP256K1

    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rate = IMAD_PER_SM_PER_CLK * sms * clock_mhz * 1e6
    print(f"bound model: {IMAD_PER_SM_PER_CLK} IMAD/clk/SM x {sms} SMs x {clock_mhz:.0f} MHz")
    specs = {
        "wei_ladder_windowed": (SECP256R1, True, cuda_ec.wei_ladder_windowed_cuda,
                                cuda_ec.wei_ladder_windowed_plain, "corda_tpu/crypto/pallas_ec.py:182"),
        "wei_ladder": (SECP256K1, False, cuda_ec.wei_ladder_cuda,
                       cuda_ec.wei_ladder_plain, "corda_tpu/crypto/pallas_ec.py:113"),
    }
    for name, (curve, windowed, kern, plain, replaces) in specs.items():
        args, (u1s, u2s, _) = _ladder_inputs(curve, CHUNK, 11, device, wide=False)
        ms = _cuda_ms(lambda: kern(curve, *args), reps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(curve, *args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _max_err(curve, kern(curve, *args), want, f"{name} {curve.name} B={CHUNK}")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        ops = _ladder_ops(curve, windowed, u1s, u2s)
        nbytes = 7 * 22 * 4 * CHUNK      # 4 inputs read, 3 outputs written
        ops_ms, bytes_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        report[name].update(
            route="cuda", source="corda_tpu_torch/csrc/wei_ladder.cu", replaces=replaces,
            ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=None,
        )
        print(f"time {name} {curve.name} B={CHUNK}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {max(ops_ms, bytes_ms):.3f} ms ({ops / CHUNK:.0f} IMAD/signature)")


def _count_torch_ops(fn) -> int:
    """Non-view aten operations one call of fn dispatches (each is a
    kernel launch on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    views = ("view", "slice", "select", "expand", "alias", "squeeze", "t.default", "detach")

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(v in func.__name__ for v in views):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def phase_prologue(device) -> None:
    import torch

    from corda_tpu_torch.crypto import limbs as L
    from corda_tpu_torch.crypto.curves import SECP256R1
    from corda_tpu_torch.crypto.ecdsa import ecdsa_scalars

    rng = random.Random(3)
    z, r, s = (
        torch.from_numpy(L.ints_to_batch([rng.randrange(1, SECP256R1.n) for _ in range(CHUNK)])).to(device)
        for _ in range(3)
    )
    ms = _cuda_ms(lambda: ecdsa_scalars(SECP256R1, z, r, s), reps=2)
    ops = _count_torch_ops(lambda: ecdsa_scalars(SECP256R1, z, r, s))
    print(f"time prologue ecdsa_scalars (mont_inv mod n as torch ops) p256 B={CHUNK}: {ms:.1f} ms, "
          f"{ops} torch ops = {ms * 1e3 / ops:.1f} us/op")


def _flush(verifier, reqs, distinct_ok, tile: int, label: str) -> None:
    t0 = time.perf_counter()
    pv = verifier.verify_batch_async(reqs)
    seen, order = 0, []
    for idxs, vals in pv.chunks():
        order.append(idxs[0])
        for i, ok in zip(idxs, vals):
            if ok != distinct_ok[i % tile]:
                raise RuntimeError(f"{label} row {i}: device {ok} != CPU {distinct_ok[i % tile]}")
        seen += len(vals)
    wall = time.perf_counter() - t0
    if seen != len(reqs) or order != sorted(order):
        raise RuntimeError(f"{label}: {seen} rows streamed of {len(reqs)}, chunk order {order}")
    dev_s = pv.device_seconds()
    print(f"main {label}: {len(reqs)} rows in {wall:.3f} s = {len(reqs) / wall:.0f} verifies/s; "
          f"host staging {pv.stage_seconds:.3f} s, device (chunk events, summed) {dev_s:.3f} s")


def phase_main(device, report: dict) -> None:
    from corda_tpu_torch.crypto import cuda_ec, schemes
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier, CudaBatchVerifier
    from corda_tpu_torch.testing.selfcheck import TAMPERED_KINDS, build_requests

    runs = []
    for sid, rows, label in (
        (schemes.ECDSA_SECP256R1_SHA256, FLUSH, "p256 flush"),
        (schemes.ECDSA_SECP256K1_SHA256, CHUNK, "secp256k1 batch"),
    ):
        distinct = build_requests(DISTINCT, seed=sid, scheme_ids=(sid,))
        ok = CpuBatchVerifier().verify_batch(distinct)
        labels = [i % 8 not in TAMPERED_KINDS for i in range(DISTINCT)]
        if ok != labels:
            raise RuntimeError(f"{label}: CPU reference disagrees with the construction labels")
        runs.append(((distinct * (rows // DISTINCT))[:rows], ok, label))
    verifier = CudaBatchVerifier(batch_sizes=(128, 1024, 4096), device=device)
    for reqs, ok, label in runs:     # warm-up: allocator, library load
        _flush(verifier, reqs[:DISTINCT], ok, DISTINCT, label + " warm-up")

    cuda_ec.wei_ladder_launches = 0
    cuda_ec.wei_ladder_windowed_launches = 0
    for reqs, ok, label in runs:
        _flush(verifier, reqs, ok, DISTINCT, label)
    launches = {
        "wei_ladder_windowed": cuda_ec.wei_ladder_windowed_launches,
        "wei_ladder": cuda_ec.wei_ladder_launches,
    }
    print(f"main launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"{name} was not launched on the main path")
        report[name]["launches"] = n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the kernel table JSON here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from corda_tpu_torch.crypto import build

    print(_smi("name,power.limit"))
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for stem in libs:
        for line in build.ptxas_report(stem).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {stem}: {line.strip()}")

    report: dict = {}
    phase_parity(device, report)
    phase_timing(device, report)
    phase_prologue(device)
    phase_main(device, report)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = {"kernels": [
        {k: ({"name": n, **r}[k]) for k in keys} for n, r in report.items()
    ]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
