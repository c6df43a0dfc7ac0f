#!/usr/bin/env python3
"""Smoke run of corda_tpu_torch's verification paths on one CUDA card.

    python3 chip_smoke.py [--out PATH]

Phases (any failure raises and exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from corda_tpu_torch/csrc with nvcc (one
     process per source, all started together);
  3. print each kernel's registers, stack, static shared memory and
     resident warps per SM (CUDA runtime); hold each ladder kernel
     against its plain torch version on the card — the Weierstrass
     ladders on p256 and secp256k1, the Edwards ladders on ed25519,
     each at B=256 and at the ragged B=130 and B=1 (partial groups and
     warps; edge rows u1=0, u2=0, Q=G and u2=n-u1 with Q=G; s=0, k=0,
     A=identity, s=L, s+L, all-264-bit scalars, A of order 2 and 4):
     equal normalised points, X*Y == Z*T for the Edwards outputs, and
     the first 8 rows equal to refmath; time each kernel and its plain
     version at the main path's chunk (4096, main-path scalars) and
     hold them equal there too;
  4. count and time the torch prologue and epilogue per 4096 chunk
     (ecdsa_scalars; ed_decompress_neg_batch, ed_ext_to_affine);
  5. the main path through CudaBatchVerifier(batch_sizes=(128, 1024,
     4096)).verify_batch_async(...).chunks(): a 16,384-row p256 flush,
     a 4,096-row secp256k1 batch, a 16,384-row ed25519 flush, a
     4,096-row ed25519 batch with windowed=True, and a 16,384-row mixed
     call (even thirds ed25519 / secp256k1 / p256). Each is built from
     256 distinct signed requests per scheme with tampered rows (and
     the ed25519 edge rows), tiled; every row must equal the CPU
     reference of its distinct request. The launch counters are set to 0
     just before each path and read just after; each path must have
     launched its kernels;
  6. the batching notary (corda_tpu_torch.node.notary) over
     CudaBatchVerifier(batch_sizes=(4096,)): a 16,384-spend flush of
     single-input Cash spends (testing/notary_fixture.py: 3 in 4
     signers ed25519, 1 in 4 p256; 1 in 64 a flipped signature byte, 1
     in 64 a double spend of the spend before it, 1 in 256 naming
     another notary), through the service flow's entry (`process`) and
     one `flush()`, for shards = 1 and 4 (ShardedUniquenessProvider), a
     warm-up pass then a timed one, each with a fresh uniqueness
     provider, degraded_fallback=False, and a fresh decode of the
     spends' wire bytes (outside the timed window, so each pass pays the
     transaction ids and Merkle roots itself). Every pass must answer each
     spend as its label (the first spend of each double-spend pair
     wins; the accepted count exact), the card's verdicts must equal
     CpuBatchVerifier on 256 sampled rows (and reject exactly the
     flipped ones), 8 notary signatures must verify against their
     Merkle proofs, ed_ladder and wei_ladder_windowed must have
     launched, and the notary must not have degraded. Prints
     notarisations/s, the decode and flush walls, phase_seconds, host staging and
     device seconds of the notary's dispatches and the launches;
  7. print the kernel table as one JSON line, then the result line
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
NOTARY_SPENDS = 16384
NOTARY_SAMPLE = 256
NOTARY_PASSES = ("warm-up", "timed")
NOTARY_FIXTURE: dict = {}    # build_fixture's defaults: 1 in 64 bad, 1 in 256 wrong notary
PARITY_B = 256
RAGGED_B = 130
PARITY_SIZES = (PARITY_B, RAGGED_B, 1)
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


def _ed_affine(curve, X, Y, Z, T):
    """Host normalisation of [22, B] extended Montgomery limbs: affine
    (x, y) ints per row; raises unless X*Y == Z*T (mod p)."""
    from corda_tpu_torch.crypto import limbs as L

    p = curve.p
    out = []
    for i, (x, y, z, t) in enumerate(zip(*(L.batch_to_ints(c.cpu().numpy()) for c in (X, Y, Z, T)))):
        if (x * y - z * t) % p:
            raise RuntimeError(f"{curve.name} row {i}: X*Y != Z*T")
        zi = pow(z, -1, p)
        out.append(((x * zi) % p, (y * zi) % p))
    return out


def _normalise(curve, pt):
    return _ed_affine(curve, *pt) if len(pt) == 4 else _affine(curve, *pt)


def _max_err(curve, got, want, label: str) -> int:
    """Largest coordinate difference of the normalised points; raises
    unless every row is equal (integers: equality is the tolerance)."""
    import torch

    torch.cuda.synchronize()
    err = 0
    for i, (a, b) in enumerate(zip(_normalise(curve, got), _normalise(curve, want))):
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
    u1s, u2s, qs = u1s[:batch], u2s[:batch], qs[:batch]

    def dev(xs):
        return torch.from_numpy(L.ints_to_batch(xs)).to(device)

    qx_m = M.to_mont(curve.fp, dev([q[0] for q in qs]))
    qy_m = M.to_mont(curve.fp, dev([q[1] for q in qs]))
    return (dev(u1s), dev(u2s), qx_m, qy_m), (u1s, u2s, qs)


def _ed_inputs(batch: int, seed: int, device, wide: bool = True):
    """s, k, ax_m, ay_m for the Edwards ladders at `batch` rows. With
    `wide`, the edge rows come first (s=0, k=0, A=identity, s=L, s+L,
    all-264-bit scalars, A of order 2 and of order 4) and every 4th row
    uses all 264 digit bits; else s, k < L and A in the prime-order
    subgroup, as the main path gives them (but for s + L rows)."""
    import torch

    from corda_tpu_torch.crypto import limbs as L
    from corda_tpu_torch.crypto import modmath as M
    from corda_tpu_torch.crypto import refmath
    from corda_tpu_torch.crypto.curves import ED25519 as c

    rng = random.Random(seed)
    B = (c.gx, c.gy)
    distinct = [refmath.ed_mul(c, rng.randrange(1, c.L), B) for _ in range(16)]
    ss, ks, As = [], [], []
    if wide:
        sqrt_m1 = pow(2, (c.p - 1) // 4, c.p)
        ss = [0, 5, 9, c.L, c.L + 3, rng.getrandbits(264), 6, 10]
        ks = [7, 0, 4, 8, 6, rng.getrandbits(264), 5, 3]
        As = [distinct[0], distinct[1], (0, 1), distinct[2], distinct[3], distinct[4],
              (0, c.p - 1), (sqrt_m1, 0)]
    for i in range(len(ss), batch):
        top = wide and i % 4 == 0
        ss.append(rng.getrandbits(264) if top else rng.randrange(c.L))
        ks.append(rng.getrandbits(264) if top else rng.randrange(c.L))
        As.append(distinct[i % 16])
    ss, ks, As = ss[:batch], ks[:batch], As[:batch]

    def dev(xs):
        return torch.from_numpy(L.ints_to_batch(xs)).to(device)

    ax_m = M.to_mont(c.fp, dev([a[0] for a in As]))
    ay_m = M.to_mont(c.fp, dev([a[1] for a in As]))
    return (dev(ss), dev(ks), ax_m, ay_m), (ss, ks, As)


MUL_OPS = 2 * (64 + 64) + 8   # 256-bit Montgomery multiply: 8x8 + 8x8 products (2 IMAD each) + 8 low halves
SQR_OPS = 2 * (36 + 64) + 8   # a square: 36 distinct products
# mod 2^255 - 19 (special form): 8x8 products and the high half's 8 words
# times 38 (2 IMAD each); a square: 36 distinct products
ED_MUL_OPS = 2 * (64 + 8)
ED_SQR_OPS = 2 * (36 + 8)


def _cost(mults: int, squares: int = 0, mul: int = MUL_OPS, sqr: int = SQR_OPS) -> int:
    return mults * mul + squares * sqr


def _ed_cost(mults: int, squares: int = 0) -> int:
    return _cost(mults, squares, ED_MUL_OPS, ED_SQR_OPS)


# Edwards (a = -1), each without its T3 product, "t", which _ladder_ops
# counts only where the result must carry T: add-2008-hwcd-3 of a cached
# operand (Y - X, Y + X, 2Z, 2dT) 7M, of a cached affine one (Z2 = 1) 6M,
# dbl-2008-hwcd 3M + 4S; special-form multiplies ("mul": the conversions
# in and out too)
ED_COST = {"add": _ed_cost(7), "madd": _ed_cost(6), "dbl": _ed_cost(3, 4), "t": _ed_cost(1),
           "mul": ED_MUL_OPS}


def _wei_cost(curve) -> dict:
    """RCB15 complete formulas (Renes-Costello-Batina 2016, table 1) for
    a = 0 or a = -3: add 12M + 2 by b, mixed add 11M + 2 by b, doubling
    6M + 2S + 1 by 3b (a = 0) or 8M + 3S + 2 by b (a = -3)."""
    a = curve.a % curve.p
    if a not in (0, curve.p - 3):
        raise ValueError(f"{curve.name}: no dedicated formulas for a = {curve.a}")
    return {"add": _cost(14), "madd": _cost(13), "dbl": _cost(7, 2) if a == 0 else _cost(10, 3), "t": 0,
            "mul": MUL_OPS}


def _step_adds(cost: dict, windowed: bool, x: int, y: int, i: int) -> list:
    """Costs of the adds step i (bit i, or w=4 window i) of R = x*P + y*Q
    needs: none for a zero bit or digit, a mixed add where the operand is
    affine (P, Q, the constant P table), a full add for P + Q or a Q
    multiple."""
    if not windowed:
        pair = ((x >> i) & 1, (y >> i) & 1)
        return [] if pair == (0, 0) else [cost["add"] if pair == (1, 1) else cost["madd"]]
    ds, dk = (x >> 4 * i) & 15, (y >> 4 * i) & 15
    return [cost["madd"]] * (ds > 0) + [cost["madd"] if dk == 1 else cost["add"]] * (dk > 0)


def _ladder_ops(cost: dict, conv_mults: int, windowed: bool, xs, ys) -> int:
    """IMAD-rate instructions the kernel's schedule (plain Shamir, or w=4
    windows) needs for these scalars: each row scans only its scalars'
    bits; doublings at the dedicated doubling formula's cost; no add of
    the identity, and the top step's add a copy; the table the row needs
    (P + Q, or Q multiples 2..15 as 7 doublings and 7 mixed adds; the P
    table is constant). Edwards results carry T (cost["t"]) only where
    an add follows (the doubling before a step's adds, the first of a
    step's two adds), in table entries, and in the result unless it is
    the top step's copy. `conv_mults` multiplies (cost["mul"] each)
    convert the point in and the result out; the entry folds of the two
    input coordinates add 2 x 4 x 8 products."""
    width = 4 if windowed else 1
    t = cost["t"]
    ops = 0
    for x, y in zip(xs, ys):
        steps = -(-max(x.bit_length(), y.bit_length()) // width)
        if steps:
            adds = [_step_adds(cost, windowed, x, y, i) for i in range(steps)]
            ops += sum(map(sum, adds)) - max(adds[-1]) + width * (steps - 1) * cost["dbl"]
            ops += t * (sum(map(len, adds[:-1])) + (steps > 1 or len(adds[-1]) == 2))
            if windowed and y:
                ops += 7 * (cost["dbl"] + cost["madd"] + 2 * t)
            elif not windowed and x & y:
                ops += cost["madd"] + t
        ops += conv_mults * cost["mul"] + 2 * 4 * 8 * 2
    return ops


def _wei_ops(curve, windowed: bool, u1s, u2s) -> int:
    return _ladder_ops(_wei_cost(curve), 5, windowed, u1s, u2s)


def _ed_ops(windowed: bool, ss, ks) -> int:
    # 2 multiplies into the kernel's domain, T = x*y, 4 back to the 2^264 domain
    return _ladder_ops(ED_COST, 7, windowed, ss, ks)


def phase_parity(device, report: dict) -> None:
    from corda_tpu_torch.crypto import cuda_ec, refmath
    from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1

    kernels = {
        "wei_ladder_windowed": (cuda_ec.wei_ladder_windowed_cuda, cuda_ec.wei_ladder_windowed_plain),
        "wei_ladder": (cuda_ec.wei_ladder_cuda, cuda_ec.wei_ladder_plain),
    }
    for name, (kern, plain) in kernels.items():
        err = 0
        for curve in (SECP256R1, SECP256K1):
            for batch in PARITY_SIZES:
                args, (u1s, u2s, qs) = _ladder_inputs(curve, batch, 7, device)
                out = kern(curve, *args)
                label = f"{name} {curve.name} B={batch}"
                err = max(err, _max_err(curve, out, plain(curve, *args), label))
                got = _affine(curve, *out)
                G = (curve.gx, curve.gy)
                for i in range(min(8, batch)):   # and the plain version against refmath
                    ref = refmath.wei_add(
                        curve, refmath.wei_mul(curve, u1s[i], G), refmath.wei_mul(curve, u2s[i], qs[i])
                    )
                    if ref != got[i]:
                        raise RuntimeError(f"{label} row {i}: {got[i]} != refmath {ref}")
                if batch > 3 and got[3] is not None:
                    raise RuntimeError(f"{label}: u2 = n - u1, Q = G must give infinity")
                print(f"parity {label}: {batch} rows equal")
        report[name] = {"max_abs_err": float(err)}

    c = ED25519
    ed_kernels = {
        "ed_ladder_windowed": (cuda_ec.ed_ladder_windowed_cuda, cuda_ec.ed_ladder_windowed_plain),
        "ed_ladder": (cuda_ec.ed_ladder_cuda, cuda_ec.ed_ladder_plain),
    }
    for name, (kern, plain) in ed_kernels.items():
        err = 0
        for batch in PARITY_SIZES:
            args, (ss, ks, As) = _ed_inputs(batch, 7, device)
            out = kern(c, *args)
            err = max(err, _max_err(c, out, plain(c, *args), f"{name} B={batch}"))
            got = _ed_affine(c, *out)
            B = (c.gx, c.gy)
            for i in range(min(8, batch)):   # and against refmath
                ref = refmath.ed_add(c, refmath.ed_mul(c, ss[i], B), refmath.ed_mul(c, ks[i], As[i]))
                if ref != got[i]:
                    raise RuntimeError(f"{name} row {i}: {got[i]} != refmath {ref}")
            print(f"parity {name} ed25519 B={batch}: {batch} rows equal")
        report[name] = {"max_abs_err": float(err)}


def print_resources() -> None:
    """Registers, stack bytes, static shared bytes and resident warps per
    SM of every kernel instantiation, from the CUDA runtime."""
    from corda_tpu_torch.crypto import cuda_ec
    from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1

    libs = [("wei_ladder", c, cuda_ec.kernel_params(c)) for c in (SECP256R1, SECP256K1)]
    libs.append(("ed_ladder", ED25519, cuda_ec.ed_kernel_params(ED25519)))
    for lib, curve, params in libs:
        for windowed in (True, False):
            name = lib + ("_windowed" if windowed else "")
            print(f"resources {name} {curve.name}: "
                  f"{cuda_ec.kernel_resources(lib, windowed, params)}")


def _time_kernel(report: dict, name: str, curve, kern, plain, args, ops: int,
                 nbytes: int, rate: float, source: str, replaces: str) -> None:
    """Kernel ms (CUDA events, 5 launches), plain ms (one call, host
    clock around synchronise), equality at this size, and the bound."""
    import torch

    ms = _cuda_ms(lambda: kern(curve, *args), reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(curve, *args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _max_err(curve, kern(curve, *args), want, f"{name} {curve.name} B={CHUNK}")
    report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    ops_ms, bytes_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    report[name].update(
        route="cuda", source=source, replaces=replaces,
        ms=ms, plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=None,
    )
    print(f"time {name} {curve.name} B={CHUNK}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {max(ops_ms, bytes_ms):.3f} ms ({ops / CHUNK:.0f} IMAD/signature)")


def phase_timing(device, report: dict) -> None:
    import torch

    from corda_tpu_torch.crypto import cuda_ec
    from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1

    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rate = IMAD_PER_SM_PER_CLK * sms * clock_mhz * 1e6
    print(f"bound model: {IMAD_PER_SM_PER_CLK} IMAD/clk/SM x {sms} SMs x {clock_mhz:.0f} MHz")
    wei = {
        "wei_ladder_windowed": (SECP256R1, True, cuda_ec.wei_ladder_windowed_cuda,
                                cuda_ec.wei_ladder_windowed_plain, "corda_tpu/crypto/pallas_ec.py:182"),
        "wei_ladder": (SECP256K1, False, cuda_ec.wei_ladder_cuda,
                       cuda_ec.wei_ladder_plain, "corda_tpu/crypto/pallas_ec.py:113"),
    }
    for name, (curve, windowed, kern, plain, replaces) in wei.items():
        args, (u1s, u2s, _) = _ladder_inputs(curve, CHUNK, 11, device, wide=False)
        _time_kernel(report, name, curve, kern, plain, args, _wei_ops(curve, windowed, u1s, u2s),
                     7 * 22 * 4 * CHUNK,      # 4 inputs read, 3 outputs written
                     rate, "corda_tpu_torch/csrc/wei_ladder.cu", replaces)
    ed = {
        "ed_ladder_windowed": (True, cuda_ec.ed_ladder_windowed_cuda,
                               cuda_ec.ed_ladder_windowed_plain, "corda_tpu/crypto/pallas_ec.py:249"),
        "ed_ladder": (False, cuda_ec.ed_ladder_cuda,
                      cuda_ec.ed_ladder_plain, "corda_tpu/crypto/pallas_ec.py:311"),
    }
    args, (ss, ks, _) = _ed_inputs(CHUNK, 13, device, wide=False)
    for name, (windowed, kern, plain, replaces) in ed.items():
        _time_kernel(report, name, ED25519, kern, plain, args, _ed_ops(windowed, ss, ks),
                     8 * 22 * 4 * CHUNK,      # 4 inputs read, 4 outputs written
                     rate, "corda_tpu_torch/csrc/ed_ladder.cu", replaces)


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


def _torch_phase(label: str, fn) -> None:
    ms = _cuda_ms(fn, reps=2)
    ops = _count_torch_ops(fn)
    print(f"time {label} B={CHUNK}: {ms:.1f} ms, {ops} torch ops = {ms * 1e3 / ops:.1f} us/op")


def phase_prologue(device) -> None:
    import torch

    from corda_tpu_torch.crypto import limbs as L
    from corda_tpu_torch.crypto import modmath as M
    from corda_tpu_torch.crypto import refmath
    from corda_tpu_torch.crypto.curves import ED25519, SECP256R1
    from corda_tpu_torch.crypto.ec import ed_ext_to_affine
    from corda_tpu_torch.crypto.ecdsa import ecdsa_scalars
    from corda_tpu_torch.crypto.eddsa import ed_decompress_neg_batch

    rng = random.Random(3)

    def dev(xs):
        return torch.from_numpy(L.ints_to_batch(xs)).to(device)

    z, r, s = (dev([rng.randrange(1, SECP256R1.n) for _ in range(CHUNK)]) for _ in range(3))
    _torch_phase("prologue ecdsa_scalars (mont_inv mod n as torch ops) p256",
                 lambda: ecdsa_scalars(SECP256R1, z, r, s))
    c = ED25519
    pts = [refmath.ed_mul(c, rng.randrange(1, c.L), (c.gx, c.gy)) for _ in range(16)]
    y_raw = dev([pts[i % 16][1] for i in range(CHUNK)])
    a_sign = torch.tensor([pts[i % 16][0] & 1 for i in range(CHUNK)], dtype=torch.int32, device=device)
    _torch_phase("prologue ed_decompress_neg_batch (252-bit sqrt pow as torch ops)",
                 lambda: ed_decompress_neg_batch(y_raw, a_sign))
    ext = tuple(M.to_mont(c.fp, dev([rng.randrange(1, c.p) for _ in range(CHUNK)])) for _ in range(4))
    _torch_phase("epilogue ed_ext_to_affine (mont_inv mod p as torch ops)",
                 lambda: ed_ext_to_affine(c.fp, ext))


def _dispatch_order(reqs) -> list:
    """Request indices in the order the verifier dispatches them: one
    bucket per scheme, in the order of each scheme's first row."""
    buckets: dict = {}
    for i, r in enumerate(reqs):
        buckets.setdefault(r.key.scheme_id, []).append(i)
    return [i for idxs in buckets.values() for i in idxs]


def _flush(verifier, reqs, expect, label: str) -> None:
    t0 = time.perf_counter()
    pv = verifier.verify_batch_async(reqs)
    streamed = []
    for idxs, vals in pv.chunks():
        for i, ok in zip(idxs, vals):
            if ok != expect[i]:
                raise RuntimeError(f"{label} row {i}: device {ok} != CPU {expect[i]}")
        streamed.extend(idxs)
    wall = time.perf_counter() - t0
    if streamed != _dispatch_order(reqs):
        raise RuntimeError(f"{label}: {len(streamed)} rows of {len(reqs)} streamed, "
                           "not once each in dispatch order")
    dev_s = pv.device_seconds()
    print(f"main {label}: {len(reqs)} rows in {wall:.3f} s = {len(reqs) / wall:.0f} verifies/s; "
          f"host staging {pv.stage_seconds:.3f} s, device (chunk events, summed) {dev_s:.3f} s")


COUNTERS = {
    "wei_ladder_windowed": "wei_ladder_windowed_launches",
    "wei_ladder": "wei_ladder_launches",
    "ed_ladder_windowed": "ed_ladder_windowed_launches",
    "ed_ladder": "ed_ladder_launches",
}


def phase_main(device, report: dict) -> None:
    from corda_tpu_torch.crypto import cuda_ec, schemes
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier, CudaBatchVerifier
    from corda_tpu_torch.testing.selfcheck import (
        TAMPERED_KINDS,
        build_requests,
        ed25519_edge_requests,
    )

    p256, k1, ed = (schemes.ECDSA_SECP256R1_SHA256, schemes.ECDSA_SECP256K1_SHA256,
                    schemes.EDDSA_ED25519_SHA512)
    distinct, ok = {}, {}
    for sid in (p256, k1, ed):
        edges = [r for _, r in ed25519_edge_requests()] if sid == ed else []
        n = DISTINCT - len(edges)
        distinct[sid] = build_requests(n, seed=sid, scheme_ids=(sid,)) + edges
        ok[sid] = CpuBatchVerifier().verify_batch(distinct[sid])
        if ok[sid][:n] != [i % 8 not in TAMPERED_KINDS for i in range(n)]:
            raise RuntimeError(f"scheme {sid}: CPU reference disagrees with the construction labels")

    def tiled(sids, rows):
        """rows requests cycling over sids, each scheme's distinct set
        tiled; with the CPU reference's decision per row"""
        picks = [(sids[i % len(sids)], (i // len(sids)) % DISTINCT) for i in range(rows)]
        return [distinct[s][j] for s, j in picks], [ok[s][j] for s, j in picks]

    plain = CudaBatchVerifier(batch_sizes=(128, 1024, 4096), device=device)
    windowed = CudaBatchVerifier(batch_sizes=(128, 1024, 4096), device=device, windowed=True)
    # (label, verifier, schemes, rows, kernels that must launch)
    paths = [
        ("p256 flush", plain, (p256,), FLUSH, ("wei_ladder_windowed",)),
        ("secp256k1 batch", plain, (k1,), CHUNK, ("wei_ladder",)),
        ("ed25519 flush", plain, (ed,), FLUSH, ("ed_ladder",)),
        ("ed25519 windowed batch", windowed, (ed,), CHUNK, ("ed_ladder_windowed",)),
        ("mixed flush (ed25519 / secp256k1 / p256)", plain, (ed, k1, p256), FLUSH,
         ("ed_ladder", "wei_ladder", "wei_ladder_windowed")),
    ]
    for label, verifier, sids, _, _ in paths:    # warm-up: allocator, library load
        reqs, expect = tiled(sids, DISTINCT)
        _flush(verifier, reqs, expect, label + " warm-up")

    for label, verifier, sids, rows, must in paths:
        reqs, expect = tiled(sids, rows)
        for counter in COUNTERS.values():
            setattr(cuda_ec, counter, 0)
        _flush(verifier, reqs, expect, label)
        launches = {name: getattr(cuda_ec, counter) for name, counter in COUNTERS.items()}
        print(f"main {label} launches: {launches}")
        for name in must:
            if launches[name] == 0:
                raise RuntimeError(f"{name} was not launched on the {label}")
            report[name].setdefault("launches", launches[name])


def _check_notary(fx, svc, answers, calls, label: str) -> dict:
    """Hold one notary pass to its fixture; returns the pass's dispatch
    figures (host staging s, device s, rows)."""
    import random as _random

    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing.notary_fixture import answer_kind

    kinds = [answer_kind(a) for a in answers]
    bad = [i for i, (k, want) in enumerate(zip(kinds, fx.labels)) if k != want]
    if bad:
        i = bad[0]
        raise RuntimeError(f"{label}: {len(bad)} answers differ from their labels; spend {i}: "
                           f"{answers[i]!r}, label {fx.labels[i]}")
    for i, want in enumerate(fx.labels):
        if want == "conflict":   # the first spend of the pair won
            if list(answers[i].conflict.values()) != [fx.spends[i - 1].id]:
                raise RuntimeError(f"{label}: spend {i} lost to {answers[i].conflict}")
    n_ok = fx.labels.count("ok")
    if len(svc.uniqueness.committed) != n_ok:
        raise RuntimeError(f"{label}: {len(svc.uniqueness.committed)} inputs committed, "
                           f"{n_ok} accepted")
    reqs = [r for rs, _ in calls for r in rs]
    verdicts = [v for _, pv in calls for v in pv.result()]
    if len(reqs) != len(verdicts) or verdicts.count(False) != fx.labels.count("invalid-signature"):
        raise RuntimeError(f"{label}: the card rejected {verdicts.count(False)} of "
                           f"{len(verdicts)} rows")
    sample = sorted(_random.Random(len(reqs)).sample(range(len(reqs)), min(NOTARY_SAMPLE, len(reqs))))
    if CpuBatchVerifier().verify_batch([reqs[i] for i in sample]) != [verdicts[i] for i in sample]:
        raise RuntimeError(f"{label}: the card's verdicts differ from CpuBatchVerifier")
    signed = [i for i, k in enumerate(kinds) if k == "ok"]
    for i in signed[:: max(1, len(signed) // 8)][:8]:
        if not answers[i].is_valid(fx.spends[i].id):   # schemes.verify_one over its proof
            raise RuntimeError(f"{label}: the notary signature of spend {i} does not verify")
    if svc.degraded or svc.metrics.counter("Notary.DegradedFlushes").count:
        raise RuntimeError(f"{label}: the notary degraded: {svc.degraded_evidence}")
    return {"stage_s": sum(pv.stage_seconds for _, pv in calls),
            "device_s": sum(pv.device_seconds() for _, pv in calls), "rows": len(reqs)}


def phase_notary(device, card: str) -> dict:
    """The batching notary's flush over the card (phase 6); returns
    {shards: notarisations/s of the last pass}."""
    import os

    os.environ["CORDA_TPU_NOTARY_PROFILE"] = "1"   # the notary's phase_seconds
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.crypto import cuda_ec
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier
    from corda_tpu_torch.node.notary import (
        BatchingNotaryService,
        InMemoryUniquenessProvider,
        ShardedUniquenessProvider,
        finish_process,
        run_process,
    )
    from corda_tpu_torch.testing.notary_fixture import build_fixture, notary_hub

    spends = NOTARY_SPENDS
    fx = build_fixture(spends, **NOTARY_FIXTURE)
    counts = {k: fx.labels.count(k) for k in sorted(set(fx.labels))}
    print(f"notary fixture: {spends} spends {counts}, {len(fx.issues)} issue transactions, "
          f"built in {fx.build_seconds:.1f} s, signing by "
          + ("OpenSSL" if fx.openssl else f"pure Python over {os.cpu_count()} processes"))

    class Recording(CudaBatchVerifier):
        """The notary's verifier, keeping each dispatch's requests and
        handle for the checks."""

        def verify_batch_async(self, requests):
            pv = super().verify_batch_async(requests)
            self.calls.append((list(requests), pv))
            return pv

    # the spends as a notary receives them: each pass decodes its own
    # copy, so no transaction id or Merkle root is cached from the last
    wire = [ser.encode(stx) for stx in fx.spends]
    verifier = Recording(batch_sizes=(CHUNK,), device=device)
    verifier.calls = []
    hub = notary_hub(fx, verifier)
    rates = {}
    for shards in (1, 4):
        def fresh():
            return ShardedUniquenessProvider(shards) if shards > 1 else InMemoryUniquenessProvider()

        svc = BatchingNotaryService(hub, fresh(), max_batch=spends, shards=shards,
                                    shard_workers=False, shard_queue_depth=spends,
                                    degraded_fallback=False)
        for pass_name in NOTARY_PASSES:
            label = f"notary shards={shards} {pass_name}"
            svc.uniqueness = fresh()
            verifier.calls = []
            svc.phase_seconds.clear()
            for counter in COUNTERS.values():
                setattr(cuda_ec, counter, 0)
            td = time.perf_counter()
            received = [ser.decode(b) for b in wire]
            t0 = time.perf_counter()
            started = run_process([svc.process(stx, fx.requester) for stx in received])
            t1 = time.perf_counter()
            svc.flush()
            t2 = time.perf_counter()
            answers = finish_process(started)
            wall = time.perf_counter() - t0
            launches = {name: getattr(cuda_ec, counter) for name, counter in COUNTERS.items()}
            disp = _check_notary(fx, svc, answers, verifier.calls, label)
            for kernel in ("ed_ladder", "wei_ladder_windowed"):
                if launches[kernel] == 0:
                    raise RuntimeError(f"{kernel} was not launched on the {label} pass")
            phases = {k: round(v, 6) for k, v in svc.phase_seconds.items()}
            print(f"{label}: {spends} spends in {wall:.3f} s = {spends / wall:.1f} notarisations/s "
                  f"(intake {t1 - t0:.3f} s, flush {t2 - t1:.3f} s; decode before it "
                  f"{t0 - td:.3f} s); {card}")
            print(f"{label} phase_seconds: {json.dumps(phases)}; {card}")
            print(f"{label} dispatch: {len(verifier.calls)} calls, {disp['rows']} rows, "
                  f"host staging {disp['stage_s']:.3f} s, device (chunk events, summed) "
                  f"{disp['device_s']:.3f} s; launches {launches}; {card}")
            rates[shards] = spends / wall
    return rates


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the kernel table JSON here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from corda_tpu_torch.crypto import build

    card = _smi("name,power.limit")
    print(card)
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

    print_resources()
    report: dict = {}
    phase_parity(device, report)
    phase_timing(device, report)
    phase_prologue(device)
    phase_main(device, report)
    phase_notary(device, card)

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
