#!/usr/bin/env python3
"""Smoke run of corda_tpu_torch's verification paths on one CUDA card.

    python3 chip_smoke.py [--out PATH]

Phases (any failure raises and exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from corda_tpu_torch/csrc with nvcc (one
     process per source, all started together) and, beside them, the
     native host library (corda_tpu_torch/native/cts_hash.cpp: the CTS
     codec, SHA-256, Merkle trees, the staging sweeps and the asset
     sweep) with g++; print the compiler, the seconds the build took and
     whether the CPU takes the SHA-NI path;
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
     device seconds of the notary's dispatches and the launches. Before
     the passes, outside their windows, every spend's wire bytes are
     encoded again by the native and the Python codec, and decoded by
     each: equal bytes, equal transaction ids (native tree against the
     Python tree over Python encodings) and equal Merkle roots over the
     ids, or the script raises; the per-spend times of both are printed;
  7. every scheme and attachment code: a flush of the first 64 phase-6
     spends plus spends with an added RSA-2048 signature (one flipped),
     an added SPHINCS-256 signature (one flipped) and outputs under a
     contract that travels only as an attachment (one spend satisfies it,
     one breaks it) — RSA and SPHINCS rows verified on the host in the
     same dispatch, the contract run in the sandbox. Every answer must
     equal its label (the reference's answer, held by
     tests/test_torch_chip_smoke.py on the CPU), the verdicts equal
     CpuBatchVerifier, ed_ladder and wei_ladder_windowed launch, and no
     flush degrades; prints host_rows and host_seconds;
  8. the flows, the in-memory fabric and MockNetwork over
     CudaBatchVerifier(batch_sizes=(128, 4096)) on the card: (a) drive
     1 with a validating notary — Bank issues to Alice (ed25519), Alice
     pays Bob (p256), Bob pays Carol (secp256k1) and Carol pays Bank,
     each recipient resolving the backchain through the card; a payment
     interrupted while it awaits the notary restores from its checkpoint
     in a fresh state machine and completes; a spend with a flipped
     signature byte is refused by FinalityFlow (InvalidSignature) and by
     the notary ("invalid-transaction"); a double spend raises
     NotaryException "conflict"; every balance exact; (b) a batching
     notary for shards 1 and 4: 32 payments from 8 payers (issuance
     recorded straight into the vaults) started before one pump round
     and notarised in one flush (one dispatch per shard holding
     requests), every payment completed and every balance exact, no
     degraded flush, answers spread over the shards; (c) (a) again over
     CpuBatchVerifier: the same transaction ids, notary signatures,
     refusals and balances. ed_ladder, wei_ladder_windowed and wei_ladder
     must launch within (a) and (b). Prints flows/s, card verify calls per
     payment and rows per call, their summed chunk-event seconds, the
     notary flush's rows and walls, and the phase's wall;
  9. the out-of-process verifier pool and the pipelined wire ingest
     (node/verifier.py, node/ingest.py) on the phase-6 fixture, over
     one CudaBatchVerifier(batch_sizes=(4096,)) that two VerifierWorkers
     share (batch_window 8,192): (a) all 16,384 spends sent with
     `verify(ltx, stx)` from a node endpoint of an
     InMemoryMessagingNetwork, each ltx resolved on the fixture's hub;
     each worker answers its 8,192 in one drain and one verify_batch
     dispatch (Verifier.BatchSize); every answer must be its label (an
     InvalidSignature failure exactly for the flipped signatures,
     success for the rest: the worker checks no uniqueness or notary),
     256 sampled answers must equal a CpuBatchVerifier worker's, and
     ed_ladder and wei_ladder_windowed must launch in the drains;
     prints verified transactions/s from the first verify to the last
     answer, each drain's decode / dispatch / contract / answer seconds
     and the frame bytes per request; (b) the same through
     request_ingest_pipeline(shards=4): answers equal to (a)'s, with
     the pipeline's stage seconds and frame-cache hits, then the
     ingest's Merkle-id stage timed on fresh decodes of every spend
     with its caches, without them and against the native id walk,
     ids held equal, with the garbage collection inside each run (and
     inside each pass of 9a, 9b and 9d); (c) 256
     requests, one worker lost with its half received and unanswered:
     on a TestClock its lease expires, its nonces re-dispatch and every
     future is answered exactly once, by the survivor on the card
     (Verifier.Redispatched > 0); (d) the batching notary fed from its
     ingest ring: an IngestPipeline feeds the wire bytes of every spend
     naming this notary from its thread into attach_ingest (the ring
     path checks no notary; the spends naming another go through
     `process`), one flush, every answer its phase-6 label under
     phase 6's checks;
 10. print the kernel table as one JSON line, then the result line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or of the corda_tpu package.
"""

from __future__ import annotations

import argparse
import gc
import json
from concurrent.futures import ThreadPoolExecutor
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
SCHEME_BASE = 64             # phase 7: phase-6 spends beside the every-scheme ones
SCHEME_BATCHES = (128, 4096)
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


def _recording_verifier(batch_sizes, device):
    """A CudaBatchVerifier that keeps each dispatch's requests and handle
    (in `.calls`) for the checks."""
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier

    class Recording(CudaBatchVerifier):
        def verify_batch_async(self, requests):
            pv = super().verify_batch_async(requests)
            self.calls.append((list(requests), pv))
            return pv

    verifier = Recording(batch_sizes=batch_sizes, device=device)
    verifier.calls = []
    return verifier


def _zero_counters() -> None:
    from corda_tpu_torch.crypto import cuda_ec

    for counter in COUNTERS.values():
        setattr(cuda_ec, counter, 0)


def _read_counters() -> dict:
    from corda_tpu_torch.crypto import cuda_ec

    return {name: getattr(cuda_ec, counter) for name, counter in COUNTERS.items()}


def _check_codecs(wire: list, card: str) -> None:
    """Phase 6's codec check, outside the timed passes: the native and
    the Python codec on every spend's wire bytes. Raises on any
    difference in bytes, transaction ids or Merkle roots; prints each
    path's seconds per spend."""
    import hashlib

    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.crypto import merkle
    from corda_tpu_torch.crypto.hashes import SecureHash

    def py_id(wtx):
        return merkle.merkle_root_py([
            SecureHash(hashlib.sha256(ser.encode_py([g, i, c])).digest())
            for g, i, c in wtx.component_leaves()])

    n = len(wire)
    t0 = time.perf_counter()
    nat = [ser.decode(b) for b in wire]
    t1 = time.perf_counter()
    nat_ids = [stx.id for stx in nat]
    t2 = time.perf_counter()
    nat_wire = [ser.encode(stx) for stx in nat]
    t3 = time.perf_counter()
    py = [ser.decode_py(b) for b in wire]
    t4 = time.perf_counter()
    py_ids = [py_id(stx.wtx) for stx in py]
    t5 = time.perf_counter()
    py_wire = [ser.encode_py(stx) for stx in py]
    t6 = time.perf_counter()
    for i in range(n):
        if not (nat_wire[i] == py_wire[i] == wire[i]):
            raise RuntimeError(f"codec check: spend {i} re-encodes differently (native/Python)")
        if nat_ids[i] != py_ids[i]:
            raise RuntimeError(f"codec check: spend {i} id {nat_ids[i]} (native) != {py_ids[i]} (Python)")
    root, proofs = merkle.single_leaf_proofs(nat_ids)
    root_py, proofs_py = merkle.single_leaf_proofs_py(py_ids)
    if root != root_py or root != merkle.merkle_root_py(py_ids) or proofs != proofs_py:
        raise RuntimeError("codec check: the Merkle root or proofs over the ids differ (native/Python)")
    us = 1e6 / n
    print(f"codec check: {n} spends byte-equal, ids equal, root over the ids "
          f"{root.bytes_.hex()[:16]} equal; us per spend native / Python: decode "
          f"{(t1 - t0) * us:.1f} / {(t4 - t3) * us:.1f}, id walk {(t2 - t1) * us:.1f} / "
          f"{(t5 - t4) * us:.1f}, encode {(t3 - t2) * us:.1f} / {(t6 - t5) * us:.1f}; {card}")


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


def phase_notary(device, card: str) -> tuple:
    """The batching notary's flush over the card (phase 6); returns
    ({shards: notarisations/s of the last pass}, the fixture)."""
    import os

    os.environ["CORDA_TPU_NOTARY_PROFILE"] = "1"   # the notary's phase_seconds
    from corda_tpu_torch.core import serialization as ser
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

    # the spends as a notary receives them: each pass decodes its own
    # copy, so no transaction id or Merkle root is cached from the last
    wire = [ser.encode(stx) for stx in fx.spends]
    _check_codecs(wire, card)
    verifier = _recording_verifier((CHUNK,), device)
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
            _zero_counters()
            td = time.perf_counter()
            received = [ser.decode(b) for b in wire]
            t0 = time.perf_counter()
            started = run_process([svc.process(stx, fx.requester) for stx in received])
            t1 = time.perf_counter()
            svc.flush()
            t2 = time.perf_counter()
            answers = finish_process(started)
            wall = time.perf_counter() - t0
            launches = _read_counters()
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
    return rates, fx


def phase_schemes(device, card: str, fx) -> dict:
    """Phase 7: one notary flush over every scheme and over attachment
    code (module docstring); returns the launches of its run."""
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.batch_verifier import HOST_SCHEMES, CpuBatchVerifier
    from corda_tpu_torch.node.notary import (
        BatchingNotaryService,
        InMemoryUniquenessProvider,
        finish_process,
        run_process,
    )
    from corda_tpu_torch.testing.notary_fixture import (
        answer_kind,
        build_scheme_fixture,
        notary_hub,
    )

    t0 = time.perf_counter()
    rsa = schemes.generate_keypair(schemes.RSA_SHA256)
    sphincs = schemes.generate_keypair(schemes.SPHINCS256_SHA256, seed=SCHEME_BASE)
    sf = build_scheme_fixture(fx, rsa, sphincs, base=SCHEME_BASE)
    counts = {k: sf.kinds.count(k) for k in sorted(set(sf.kinds))}
    print(f"every-scheme fixture: {len(sf.spends)} spends {counts}, labels "
          f"{ {k: sf.labels.count(k) for k in sorted(set(sf.labels))} }, built in "
          f"{time.perf_counter() - t0:.1f} s")
    verifier = _recording_verifier(SCHEME_BATCHES, device)
    hub = notary_hub(fx, verifier)
    for data in sf.attachments:
        hub.attachments.import_attachment(data)
    svc = BatchingNotaryService(hub, InMemoryUniquenessProvider(), max_batch=len(sf.spends),
                                degraded_fallback=False)
    _zero_counters()
    t0 = time.perf_counter()
    started = run_process([svc.process(stx, fx.requester) for stx in sf.spends])
    svc.flush()
    answers = finish_process(started)
    wall = time.perf_counter() - t0
    launches = _read_counters()
    label = "every-scheme flush"
    kinds = [answer_kind(a) for a in answers]
    bad = [i for i, (k, want) in enumerate(zip(kinds, sf.labels)) if k != want]
    if bad:
        i = bad[0]
        raise RuntimeError(f"{label}: {len(bad)} answers differ from their labels; spend {i} "
                           f"({sf.kinds[i]}): {answers[i]!r}, label {sf.labels[i]}")
    for kernel in ("ed_ladder", "wei_ladder_windowed"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched on the {label}")
    if len(verifier.calls) != 1 or svc.batches_dispatched != 1:
        raise RuntimeError(f"{label}: {len(verifier.calls)} dispatches, expected one")
    reqs, pv = verifier.calls[0]
    verdicts = pv.result()
    if CpuBatchVerifier().verify_batch(reqs) != verdicts:
        raise RuntimeError(f"{label}: the verdicts differ from CpuBatchVerifier")
    host = [i for i, r in enumerate(reqs) if r.key.scheme_id in HOST_SCHEMES]
    if pv.host_rows != host or len(host) != 6:
        raise RuntimeError(f"{label}: host rows {pv.host_rows}, expected {host} (6)")
    for i, k in enumerate(kinds):
        if k == "ok" and not answers[i].is_valid(sf.spends[i].id):
            raise RuntimeError(f"{label}: the notary signature of spend {i} does not verify")
    if svc.degraded or svc.metrics.counter("Notary.DegradedFlushes").count:
        raise RuntimeError(f"{label}: the notary degraded: {svc.degraded_evidence}")
    print(f"{label}: {len(sf.spends)} spends in {wall:.3f} s, every answer its label; "
          f"{len(reqs)} rows in one dispatch, host_rows {len(pv.host_rows)}, host_seconds "
          f"{pv.host_seconds:.6f}, host staging {pv.stage_seconds:.3f} s, device (chunk events, "
          f"summed) {pv.device_seconds():.3f} s; launches {launches}; {card}")
    return launches

FLOW_SEED = 11
FLOW_BATCHES = (128, 4096)
FLOW_PAYERS = 8              # phase 8b: payer nodes (1 in 4 p256, 1 in 4 secp256k1)
FLOW_COINS = 4               # phase 8b: issued coins per payer, one payment each
FLOW_SHARDS = (1, 4)         # phase 8b: the batching notary's shards


def _cash_of(node) -> int:
    """The node's own unspent Cash (states its legal key owns)."""
    from corda_tpu_torch.finance import CashState

    return sum(s.state.data.amount.quantity for s in node.vault.unconsumed_states(CashState)
               if s.state.data.owner == node.party.owning_key)


def flow_drive(verifier, seed: int = FLOW_SEED) -> dict:
    """Phase 8a, drive 1 through the flows over `verifier`: a validating
    notary, Bank and Alice (ed25519), Bob (p256), Carol (secp256k1).
    Bank issues to Alice; Alice pays Bob; Bob pays Carol and Carol pays
    Bank (each recipient resolves the backchain); a payment of Alice's
    is interrupted while it awaits the notary and restored from its
    checkpoint by a fresh state machine; a spend with a flipped signature
    byte is refused by FinalityFlow and by the notary; a double spend
    loses with a "conflict". Raises unless every outcome and balance is
    the expected one; returns the ledger (ids, notary signatures,
    balances, refusals) and the verify calls of each payment."""
    import dataclasses
    import random as _random

    from corda_tpu_torch.core.transactions import TransactionBuilder
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.tx_signature import InvalidSignature
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState
    from corda_tpu_torch.finance.cash import CASH_CONTRACT, CashMove
    from corda_tpu_torch.flows.core_flows import FinalityFlow, NotaryFlow
    from corda_tpu_torch.flows.statemachine import StateMachineManager
    from corda_tpu_torch.node.notary import NotaryException
    from corda_tpu_torch.testing import MockNetwork

    calls = getattr(verifier, "calls", [])    # a recording verifier's dispatches
    net = MockNetwork(seed=seed, batch_verifier=verifier)
    notary = net.create_notary("Notary", validating=True)
    bank = net.create_node("Bank")
    alice = net.create_node("Alice")
    bob = net.create_node("Bob", scheme_id=schemes.ECDSA_SECP256R1_SHA256)
    carol = net.create_node("Carol", scheme_id=schemes.ECDSA_SECP256K1_SHA256)
    ledger = {"ids": [], "notary_sigs": [], "refused": [], "calls": {}}

    def record(label, stx, n_calls):
        ledger["ids"].append(str(stx.id))
        ledger["notary_sigs"].append(
            [s.signature.hex() for s in stx.sigs if s.by == notary.party.owning_key])
        ledger["calls"][label] = len(calls) - n_calls

    def run(label, node, logic):
        n_calls = len(calls)
        stx = node.run_flow(logic)
        record(label, stx, n_calls)
        return stx

    def refused(label, node, logic, exc_type, kind=None):
        try:
            node.run_flow(logic)
        except exc_type as e:
            got = getattr(getattr(e, "error", None), "kind", None)
            if got != kind:
                raise RuntimeError(f"flow drive: {label} refused as {got!r}, not {kind!r}: {e}")
            ledger["refused"].append([label, type(e).__name__, got])
            return
        raise RuntimeError(f"flow drive: {label} was not refused")

    run("issue Bank -> Alice", bank, CashIssueFlow(1000, "USD", alice.party, notary.party))
    run("pay Alice -> Bob", alice, CashPaymentFlow(400, "USD", bob.party))
    run("pay Bob -> Carol", bob, CashPaymentFlow(150, "USD", carol.party))
    run("pay Carol -> Bank", carol, CashPaymentFlow(50, "USD", bank.party))

    # a payment interrupted while it awaits the notary's answer
    n_calls = len(calls)
    fsm = alice.start_flow(CashPaymentFlow(100, "USD", carol.party))
    waiting = fsm.waiting
    if fsm.done or waiting is None or waiting[0] != "recv" or \
            alice.smm.sessions_by_id[waiting[1]][1].party != notary.party:
        raise RuntimeError(f"flow drive: the payment is not awaiting the notary ({waiting})")
    net.fabric.pump(1)               # the notary takes the request
    alice.smm.stop()
    alice.smm = StateMachineManager(alice.services, alice.messaging,
                                    rng=_random.Random(seed + 1))
    if alice.smm.restore_checkpoints() != 1:
        raise RuntimeError("flow drive: the interrupted payment did not restore")
    restored, = alice.smm.flows.values()
    net.run()
    record("pay Alice -> Carol (restored)", restored.result_or_throw(), n_calls)

    coin, = alice.vault.unconsumed_states(CashState)

    def spend_to(party):
        b = TransactionBuilder(notary.party)
        b.add_input_state(coin)
        b.add_output_state(coin.state.data.with_owner(party.owning_key), CASH_CONTRACT)
        b.add_command(CashMove(), alice.party.owning_key)
        return alice.services.sign_initial_transaction(b)

    good = spend_to(bob.party)
    sig = good.sigs[0]
    flipped = dataclasses.replace(good, sigs=(dataclasses.replace(
        sig, signature=bytes([sig.signature[0] ^ 1]) + sig.signature[1:]),))
    refused("flipped signature at finality", alice, FinalityFlow(flipped), InvalidSignature)
    refused("flipped signature at the notary", alice, NotaryFlow(flipped), NotaryException,
            "invalid-transaction")
    run("spend Alice -> Bob", alice, FinalityFlow(good))
    refused("double spend Alice -> Carol", alice, FinalityFlow(spend_to(carol.party)),
            NotaryException, "conflict")

    ledger["balances"] = {n.name: _cash_of(n) for n in (bank, alice, bob, carol)}
    want = {"Bank": 50, "Alice": 0, "Bob": 750, "Carol": 200}
    if ledger["balances"] != want:
        raise RuntimeError(f"flow drive: balances {ledger['balances']}, expected {want}")
    if sum(_cash_of(n) for n in net.nodes) != 1000:
        raise RuntimeError("flow drive: cash was created or destroyed")
    return ledger


def flow_flush(verifier, shards: int, seed: int = FLOW_SEED) -> dict:
    """Phase 8b: FLOW_PAYERS x FLOW_COINS CashPaymentFlows to one node,
    all started before one pump round, notarised by a batching notary
    with `shards` shards in one flush (one tick: one dispatch per shard
    that holds requests). The payers' issuance is recorded straight into
    the vaults (and the notary's and the recipient's stores) before the
    window. Raises unless every payment completes, the balances are
    exact, the notary did not degrade and, for shards > 1, the answers
    spread over more than one shard; returns the window's figures."""
    from corda_tpu_torch.core.contracts import Amount, Issued
    from corda_tpu_torch.core.identity import PartyAndReference
    from corda_tpu_torch.core.transactions import TransactionBuilder
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.finance import CashPaymentFlow
    from corda_tpu_torch.finance.cash import CASH_CONTRACT, CashIssue, CashState
    from corda_tpu_torch.testing import MockNetwork

    kinds = (schemes.EDDSA_ED25519_SHA512, schemes.ECDSA_SECP256R1_SHA256,
             schemes.EDDSA_ED25519_SHA512, schemes.ECDSA_SECP256K1_SHA256)
    net = MockNetwork(seed=seed, batch_verifier=verifier)
    notary = net.create_notary("Notary", batching=True, shards=shards)
    bank = net.create_node("Bank")
    sink = net.create_node("Sink")
    payers = [net.create_node(f"Payer{i}", scheme_id=kinds[i % 4]) for i in range(FLOW_PAYERS)]
    token = Issued(PartyAndReference(bank.party, b"\x01"), "USD")
    for p in payers:
        b = TransactionBuilder(notary.party)
        for j in range(FLOW_COINS):
            b.add_output_state(CashState(Amount(100 + j, token), p.party.owning_key), CASH_CONTRACT)
        b.add_command(CashIssue(), bank.party.owning_key)
        issue = bank.services.sign_initial_transaction(b)
        for node in (p, notary, sink):
            node.services.record_transactions([issue])

    svc = notary.services.notary_service
    flushes = []
    tick = notary.ticks[0]

    def timed_tick():
        n_calls, t = len(verifier.calls), time.perf_counter()
        answered = tick()
        if answered:
            mine = verifier.calls[n_calls:]
            flushes.append({"answered": answered, "wall_s": time.perf_counter() - t,
                            "rows": sum(len(r) for r, _ in mine), "dispatches": len(mine),
                            "device_s": sum(pv.device_seconds() for _, pv in mine)})
        return answered

    notary.ticks[0] = timed_tick
    n_pay = FLOW_PAYERS * FLOW_COINS
    verifier.calls = []
    t0 = time.perf_counter()
    fsms = [p.start_flow(CashPaymentFlow(10, "USD", sink.party))
            for p in payers for _ in range(FLOW_COINS)]
    net.run()
    wall = time.perf_counter() - t0
    label = f"flow flush shards={shards}"
    for f in fsms:
        f.result_or_throw()
    if len(flushes) != 1 or flushes[0]["answered"] != n_pay:
        raise RuntimeError(f"{label}: {n_pay} payments answered in flushes {flushes}, not one")
    if svc.batches_dispatched != flushes[0]["dispatches"]:
        raise RuntimeError(f"{label}: {svc.batches_dispatched} notary dispatches counted")
    if _cash_of(sink) != 10 * n_pay or any(
            _cash_of(p) != sum(range(100, 100 + FLOW_COINS)) - 10 * FLOW_COINS for p in payers):
        raise RuntimeError(f"{label}: balances are not exact")
    if svc.degraded or svc.metrics.counter("Notary.DegradedFlushes").count:
        raise RuntimeError(f"{label}: the notary degraded: {svc.degraded_evidence}")
    answered = [svc.metrics.counter(f"Notary.Shard{k}.Answered").count for k in range(shards)]
    if shards > 1 and (sum(map(bool, answered)) < 2 or sum(answered) != n_pay):
        raise RuntimeError(f"{label}: answers per shard {answered}, not spread")
    flush = flushes[0]
    return {"payments": n_pay, "wall_s": wall, "flush": flush, "shard_answered": answered,
            "flow_calls": len(verifier.calls) - flush["dispatches"],
            "flow_rows": sum(len(r) for r, _ in verifier.calls) - flush["rows"],
            "flow_device_s": sum(pv.device_seconds() for _, pv in verifier.calls)
            - flush["device_s"]}


def phase_flows(device, card: str) -> dict:
    """Phase 8: drive 1 through the flows, the in-memory fabric and
    MockNetwork over CudaBatchVerifier on the card (8a), the batching
    notary under concurrent payments for shards 1 and 4 (8b), and 8a
    again over CpuBatchVerifier, whose ledger must equal the card's
    (8c). Returns the launches of 8a and 8b."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

    verifier = _recording_verifier(FLOW_BATCHES, device)
    t_phase = time.perf_counter()
    _zero_counters()
    t0 = time.perf_counter()
    ledger = flow_drive(verifier)
    wall_a = time.perf_counter() - t0
    rows = [len(r) for r, _ in verifier.calls]
    device_s = sum(pv.device_seconds() for _, pv in verifier.calls)
    pays = {k: v for k, v in ledger["calls"].items() if k.startswith("pay")}
    print(f"flow drive (8a): {len(ledger['ids'])} flows completed and "
          f"{len(ledger['refused'])} refused in {wall_a:.3f} s = "
          f"{len(ledger['ids']) / wall_a:.3f} completed flows/s; {len(rows)} card verify calls, rows per "
          f"call {min(rows)}-{max(rows)} (mean {sum(rows) / len(rows):.2f}), chunk events "
          f"summed {device_s:.3f} s; card verify calls "
          f"per payment {json.dumps(pays)}; per flow {json.dumps(ledger['calls'])}; refused "
          f"{ledger['refused']}; balances {ledger['balances']}; {card}")
    for shards in FLOW_SHARDS:
        verifier.calls = []
        fl = flow_flush(verifier, shards)
        f = fl["flush"]
        print(f"flow flush (8b) shards={shards}: {fl['payments']} payments in {fl['wall_s']:.3f} s "
              f"= {fl['payments'] / fl['wall_s']:.3f} flows/s; notary flush {f['answered']} "
              f"answers, {f['dispatches']} dispatch(es), {f['rows']} rows, wall "
              f"{f['wall_s']:.3f} s (chunk events {f['device_s']:.3f} s); flow verify calls "
              f"{fl['flow_calls']} = {fl['flow_calls'] / fl['payments']:.2f} per payment, "
              f"{fl['flow_rows']} rows, chunk events summed {fl['flow_device_s']:.3f} s; "
              f"answered per shard {fl['shard_answered']}; {card}")
    launches = _read_counters()
    for kernel in ("ed_ladder", "wei_ladder_windowed", "wei_ladder"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched in the flow phase")
    t0 = time.perf_counter()
    cpu = flow_drive(CpuBatchVerifier())
    for key in ("ids", "notary_sigs", "refused", "balances"):
        if cpu[key] != ledger[key]:
            raise RuntimeError(f"flow drive: the card's {key} differ from CpuBatchVerifier's")
    print(f"flow drive (8c) over CpuBatchVerifier in {time.perf_counter() - t0:.3f} s: the same "
          f"{len(cpu['ids'])} transaction ids, notary signatures, refusals and balances")
    print(f"flow phase: launches {launches}; wall {time.perf_counter() - t_phase:.3f} s; {card}")
    return launches


POOL_WORKERS = 2
POOL_WINDOW = 8192           # VerifierWorker's default ingest_window
POOL_INGEST_SHARDS = 4       # phase 9b's decode shards
POOL_SAMPLE = 256            # phase 9a: answers held against a CpuBatchVerifier worker
POOL_LOSS = 256              # phase 9c: requests when a worker is lost
POOL_CHUNK = 512             # phase 9d: spends per ingest batch


class _GcClock:
    """Seconds the interpreter spends in garbage collection while the
    clock is entered, and its collections per generation (gc.callbacks)."""

    def __init__(self):
        self.seconds = 0.0
        self.collections = [0, 0, 0]
        self._t0 = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def __str__(self):
        return f"gc {self.seconds:.3f} s in {self.collections} collections (gen 0/1/2)"


def _verdict(fut) -> str:
    """A pool future's answer: "ok", or its failure as `Type: message`."""
    if not fut.done:
        return "unanswered"
    try:
        fut.result()
    except Exception as e:   # noqa: BLE001 - the failure is the answer
        return f"{type(e).__name__}: {e}"
    return "ok"


def _check_pool_answers(answers, labels, label: str) -> None:
    """The worker's answers against the fixture's labels: an
    InvalidSignature failure exactly for the flipped signatures, success
    for the rest (no uniqueness or notary check runs in a worker)."""
    want_bad = "VerificationFailedError: InvalidSignature: "
    for i, (a, kind) in enumerate(zip(answers, labels)):
        if (a.startswith(want_bad) if kind == "invalid-signature" else a == "ok"):
            continue
        raise RuntimeError(f"{label}: request {i} ({kind}) answered {a!r}")


def _pool(verifier, window: int, ingest_shards: int = 0, clock=None, faults=None, policy=None):
    """A node endpoint with an OutOfProcessTransactionVerifierService and
    POOL_WORKERS VerifierWorkers sharing `verifier`, attached. Returns
    (network, service, workers, sizes): `sizes` gets the length of every
    request frame a worker's handler receives (a ring-fed worker's
    frames go to its ring instead)."""
    from corda_tpu_torch.node import messaging as msglib
    from corda_tpu_torch.node.verifier import (
        OutOfProcessTransactionVerifierService,
        VerifierWorker,
        request_ingest_pipeline,
    )

    net = msglib.InMemoryMessagingNetwork(clock=clock, faults=faults)
    sizes = []
    svc = OutOfProcessTransactionVerifierService(net.endpoint("Node"), clock=clock, policy=policy)
    workers = []
    for k in range(POOL_WORKERS):
        ep = net.endpoint(f"worker-{k}")
        ep.add_handler(msglib.TOPIC_VERIFIER_REQ, lambda msg: sizes.append(len(msg.payload)))
        workers.append(VerifierWorker(
            ep, "Node", batch_verifier=verifier, batch_window=window, clock=clock,
            heartbeat_micros=50_000 if clock else 0,
            ingest=request_ingest_pipeline(shards=ingest_shards) if ingest_shards else None))
    net.run()
    if svc.worker_count != POOL_WORKERS:
        raise RuntimeError(f"pool: {svc.worker_count} workers attached")
    return net, svc, workers, sizes


def pool_pass(verifier, ltxs, stxs, ingest_shards: int = 0) -> dict:
    """Phase 9a (9b with ingest shards): every (ltx, stx) through the
    pool, one drain per worker; returns the answers and the figures."""
    net, svc, workers, sizes = _pool(verifier, POOL_WINDOW, ingest_shards)
    _zero_counters()
    t0 = time.perf_counter()
    futs = [svc.verify(ltx, stx) for ltx, stx in zip(ltxs, stxs)]
    t1 = time.perf_counter()
    net.run()
    t2 = time.perf_counter()
    drained = [w.drain() for w in workers]
    t3 = time.perf_counter()
    net.run()
    t4 = time.perf_counter()
    launches = _read_counters()
    answers = [_verdict(f) for f in futs]
    n = len(futs)
    batches = [w.metrics.histogram("Verifier.BatchSize") for w in workers]
    round_robin = [len(range(k, n, POOL_WORKERS)) for k in range(POOL_WORKERS)]
    if drained != round_robin or any(h.count != 1 for h in batches):
        raise RuntimeError(f"pool: drains took {drained} requests in "
                           f"{[h.count for h in batches]} dispatches, not one each")
    return {"answers": answers, "wall_s": t4 - t0, "send_s": t1 - t0, "deliver_s": t2 - t1,
            "drain_s": t3 - t2, "answer_s": t4 - t3, "launches": launches,
            "drains": [dict(w.drain_seconds[-1]) for w in workers],
            "rows": [int(h.max) for h in batches],
            "request_bytes": sum(sizes) / len(sizes) if sizes else None,
            "pipelines": [w._ingest for w in workers]}


def pool_loss(verifier, ltxs, stxs) -> dict:
    """Phase 9c: a worker lost with its half of the requests received and
    unanswered; on a TestClock its lease expires and its nonces
    re-dispatch to the survivor. Raises unless every future is answered
    exactly once, all by the survivor; returns the answers and figures."""
    from corda_tpu_torch.node.messaging import FabricFaults
    from corda_tpu_torch.node.services import TestClock
    from corda_tpu_torch.node.verifier import RedispatchPolicy

    clock = TestClock()
    faults = FabricFaults(clock)
    policy = RedispatchPolicy(lease_micros=100_000, request_timeout_micros=100_000_000,
                              backoff_base_micros=50_000, backoff_cap_micros=200_000)
    net, svc, (lost, survivor), _ = _pool(verifier, POOL_WINDOW, clock=clock, faults=faults,
                                          policy=policy)
    t0 = time.perf_counter()
    futs = [svc.verify(ltx, stx) for ltx, stx in zip(ltxs, stxs)]
    net.run()                    # both workers hold their halves
    faults.kill("worker-0")      # lost mid-batch: received, never answered
    net.endpoint("worker-0").running = False
    survivor.drain()
    net.run()
    clock.advance(150_000)
    survivor.drain()             # its heartbeat renews its lease
    net.run()
    svc.tick()                   # worker-0's lease expired: detached
    clock.advance(80_000)        # past the jittered backoff
    svc.tick()                   # re-dispatch to the survivor
    net.run()
    survivor.drain()
    net.run()
    wall = time.perf_counter() - t0
    answers = [_verdict(f) for f in futs]
    m = svc.metrics
    answered = (m.meter("TransactionVerifierService.Verification.Success").count
                + m.meter("TransactionVerifierService.Verification.Failure").count)
    by_worker = [w.metrics.meter("Verifier.Verified").count
                 + w.metrics.meter("Verifier.Failed").count for w in (lost, survivor)]
    redispatched = m.meter("Verifier.Redispatched").count
    label = "pool worker loss (9c)"
    if "unanswered" in answers or answered != len(futs) or svc.in_flight:
        raise RuntimeError(f"{label}: {answers.count('unanswered')} unanswered, {answered} "
                           f"answers accepted for {len(futs)} requests")
    if by_worker != [0, len(futs)] or redispatched == 0 or svc.worker_count != 1:
        raise RuntimeError(f"{label}: answered per worker {by_worker}, redispatched "
                           f"{redispatched}, {svc.worker_count} workers left")
    return {"answers": answers, "wall_s": wall, "redispatched": redispatched,
            "lost": m.meter("Verifier.WorkersLost").count,
            "survivor_drains": len(survivor.drain_seconds)}


def ring_flush(fx, hub, shards: int = 1) -> tuple:
    """Phase 9d: the wire bytes of every spend naming this notary fed by
    an IngestPipeline, from its own thread, into a batching notary's
    ring, then one flush. The ring path checks no notary, so the spends
    naming another notary go through `process`, as a flow's request
    does. Returns (svc, answers, wall seconds, pipeline)."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.flows.api import FlowFuture
    from corda_tpu_torch.node.ingest import IngestPipeline
    from corda_tpu_torch.node.notary import (
        BatchingNotaryService,
        InMemoryUniquenessProvider,
        ShardedUniquenessProvider,
        _PendingNotarisation,
        finish_process,
        run_process,
    )

    n = len(fx.spends)
    uniq = ShardedUniquenessProvider(shards) if shards > 1 else InMemoryUniquenessProvider()
    svc = BatchingNotaryService(hub, uniq, max_batch=n, shards=shards, shard_queue_depth=n,
                                degraded_fallback=False)
    mine = [i for i, stx in enumerate(fx.spends) if stx.wtx.notary == svc.identity]
    others = sorted(set(range(n)) - set(mine))
    wire = [ser.encode(fx.spends[i]) for i in mine]
    batches = [wire[k : k + POOL_CHUNK] for k in range(0, len(wire), POOL_CHUNK)]
    pipe = IngestPipeline(ring_depth=len(batches))    # one flush takes every batch
    svc.attach_ingest(pipe.ring)
    futs, errors = [], []

    def wrap(entries):
        batch = []
        for e in entries:
            if e.error is not None:
                errors.append(e.error)
                continue
            fut = FlowFuture()
            futs.append(fut)
            batch.append(_PendingNotarisation(e.stx, fx.requester, fut))
        return batch

    t0 = time.perf_counter()
    feeder = pipe.feed(batches, wrap=wrap)
    started = run_process([svc.process(fx.spends[i], fx.requester) for i in others])
    feeder.join()
    dispatched = svc.batches_dispatched
    svc.flush()
    answers = [None] * n
    for i, a in zip(others, finish_process(started)):
        answers[i] = a
    for i, fut in zip(mine, futs):
        answers[i] = fut.result()
    wall = time.perf_counter() - t0
    pipe.close()
    if errors or len(futs) != len(mine) or svc.batches_dispatched - dispatched != shards:
        raise RuntimeError(f"ring flush: {svc.batches_dispatched - dispatched} dispatches for "
                           f"{len(futs)} of {len(mine)} fed spends, ingest errors {errors[:2]}")
    return svc, answers, wall, pipe


def id_stage(fx, card: str) -> None:
    """The ingest's batched Merkle-id stage (`install_tx_ids`) on fresh
    decodes of every spend: with the leaf and root caches an
    IngestPipeline starts with, without caches, and the native
    per-transaction id walk (`wtx.id`). Two rounds in that order;
    every run's ids must equal the spends'. Prints microseconds per
    transaction, the garbage collection inside each run and the share
    of distinct component leaves."""
    from corda_tpu_torch.core import serialization as ser
    from corda_tpu_torch.node import ingest

    wtxs = [ser.decode(ser.encode(stx)).wtx for stx in fx.spends]
    want = [stx.id for stx in fx.spends]
    leaves = [p for w in wtxs for p in w.leaf_preimages()]
    runs = {
        "cached": lambda: ingest.install_tx_ids(
            wtxs, ingest.DigestCache(ingest.LEAF_CACHE_SIZE),
            ingest.DigestCache(ingest.ROOT_CACHE_SIZE)),
        "uncached": lambda: ingest.install_tx_ids(wtxs, None, None),
        "walk": lambda: [w.id for w in wtxs],
    }
    us = {k: [] for k in runs}
    gcs = {k: [] for k in runs}
    for _ in range(2):
        for name, run in runs.items():
            for w in wtxs:
                object.__setattr__(w, "_id_cache", None)
            with _GcClock() as clock:
                t0 = time.perf_counter()
                run()
                us[name].append(round((time.perf_counter() - t0) * 1e6 / len(wtxs), 3))
            gcs[name].append(f"{clock.seconds:.3f} s/{clock.collections[2]}")
            if [w.__dict__["_id_cache"] for w in wtxs] != want:
                raise RuntimeError(f"id stage: {name} gives other ids than the spends'")
    print(f"id stage: {len(wtxs)} transactions, {len(leaves) / len(wtxs):.2f} leaves each, "
          f"{len(set(leaves)) / len(leaves):.4f} of them distinct; us per transaction (two "
          f"rounds) install_tx_ids with caches {us['cached']}, without {us['uncached']}, native "
          f"id walk {us['walk']}; gc seconds/gen-2 collections in each run: with caches "
          f"{gcs['cached']}, without {gcs['uncached']}, walk {gcs['walk']}; {card}")


def phase_pool(device, card: str, fx) -> dict:
    """Phase 9 (module docstring); returns the launches of 9a-9d."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing.notary_fixture import notary_hub

    verifier = _recording_verifier((CHUNK,), device)
    hub = notary_hub(fx, verifier)
    t0 = time.perf_counter()
    ltxs = [stx.to_ledger_transaction(hub) for stx in fx.spends]
    print(f"pool: {len(ltxs)} ledger transactions resolved in {time.perf_counter() - t0:.3f} s")
    launches = {}
    results = {}
    for tag, shards in (("9a", 0), ("9b", POOL_INGEST_SHARDS)):
        label = f"pool ({tag}" + (f", ingest shards={shards})" if shards else ")")
        verifier.calls = []
        with _GcClock() as gc_clock:
            r = pool_pass(verifier, ltxs, fx.spends, shards)
        _check_pool_answers(r["answers"], fx.labels, label)
        for kernel in ("ed_ladder", "wei_ladder_windowed"):
            if r["launches"][kernel] == 0:
                raise RuntimeError(f"{kernel} was not launched in the {label} drains")
        if [len(rs) for rs, _ in verifier.calls] != r["rows"]:
            raise RuntimeError(f"{label}: dispatches of {[len(rs) for rs, _ in verifier.calls]} "
                               f"rows, BatchSize {r['rows']}")
        n = len(ltxs)
        frames = (f"{r['request_bytes']:.1f} frame bytes per request"
                  if r["request_bytes"] is not None else "request frames to the workers' rings")
        print(f"{label}: {n} requests in {r['wall_s']:.3f} s = {n / r['wall_s']:.1f} verified "
              f"transactions/s (send {r['send_s']:.3f}, deliver {r['deliver_s']:.3f}, drains "
              f"{r['drain_s']:.3f}, answers {r['answer_s']:.3f} s; {gc_clock}); {frames}; rows "
              f"per dispatch {r['rows']}; launches {r['launches']}; {card}")
        for k, d in enumerate(r["drains"]):
            print(f"{label} worker-{k} drain: {d['requests']} requests, {d['rows']} rows, decode "
                  f"{d['decode']:.3f} s, dispatch {d['dispatch']:.3f} s, contract "
                  f"{d['contract']:.3f} s, answer {d['answer']:.3f} s; {card}")
        if shards:
            pipes = r["pipelines"]
            stages = {k: round(sum(p.stage_seconds[k] for p in pipes), 6)
                      for k in pipes[0].stage_seconds}
            print(f"{label} pipeline stage seconds (both workers): {json.dumps(stages)}; "
                  f"frame-cache hits {sum(p.frame_hits for p in pipes)}")
            for p in pipes:
                p.close()
            if r["answers"] != results["9a"]["answers"]:
                raise RuntimeError(f"{label}: answers differ from 9a's")
        results[tag] = r
        launches[tag] = r["launches"]

    id_stage(fx, card)

    import random as _random

    sample = sorted(_random.Random(POOL_SAMPLE).sample(range(len(ltxs)),
                                                       min(POOL_SAMPLE, len(ltxs))))
    cpu = pool_pass(CpuBatchVerifier(), [ltxs[i] for i in sample],
                    [fx.spends[i] for i in sample])
    if cpu["answers"] != [results["9a"]["answers"][i] for i in sample]:
        raise RuntimeError("pool (9a): the card's answers differ from a CpuBatchVerifier worker's")
    print(f"pool (9a): {len(sample)} sampled answers equal a CpuBatchVerifier worker's")

    k = min(POOL_LOSS, len(ltxs))
    _zero_counters()
    loss = pool_loss(verifier, ltxs[:k], fx.spends[:k])
    launches["9c"] = _read_counters()
    _check_pool_answers(loss["answers"], fx.labels[:k], "pool worker loss (9c)")
    if launches["9c"]["ed_ladder"] == 0:
        raise RuntimeError("ed_ladder was not launched by the surviving worker (9c)")
    print(f"pool worker loss (9c): {k} requests answered exactly once by the survivor in "
          f"{loss['wall_s']:.3f} s; workers lost {loss['lost']}, redispatched "
          f"{loss['redispatched']}, survivor drains {loss['survivor_drains']}; launches "
          f"{launches['9c']}; {card}")

    verifier.calls = []
    _zero_counters()
    with _GcClock() as gc_clock:
        svc, answers, wall, pipe = ring_flush(fx, hub)
    launches["9d"] = _read_counters()
    disp = _check_notary(fx, svc, answers, verifier.calls, "ring-fed notary (9d)")
    for kernel in ("ed_ladder", "wei_ladder_windowed"):
        if launches["9d"][kernel] == 0:
            raise RuntimeError(f"{kernel} was not launched on the ring-fed notary flush (9d)")
    n = len(fx.spends)
    stages = {k: round(v, 6) for k, v in pipe.stage_seconds.items()}
    print(f"ring-fed notary (9d): {n} spends fed and flushed in {wall:.3f} s = "
          f"{n / wall:.1f} notarisations/s, every answer its label ({gc_clock}); pipeline "
          f"stage seconds "
          f"{json.dumps(stages)}, frame-cache hits {pipe.frame_hits}; flush phase_seconds "
          f"{json.dumps({k: round(v, 6) for k, v in (svc.phase_seconds or {}).items()})}; "
          f"{disp['rows']} rows in {len(verifier.calls)} dispatch(es), device (chunk events) "
          f"{disp['device_s']:.3f} s; launches {launches['9d']}; {card}")
    print(f"pool phase launches: {json.dumps(launches)}")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the kernel table JSON here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from corda_tpu_torch import native
    from corda_tpu_torch.crypto import build

    card = _smi("name,power.limit")
    print(card)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.build_info)   # g++ beside the nvcc processes
        libs = build.build_all()
        print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
        info = native_build.result()
    print(f"native: {info.path.name} with {info.compiler}, "
          + (f"built in {info.seconds:.1f} s" if info.built else "reused")
          + f"; SHA-NI {'used' if native.get().sha_ni else 'not used'}")
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
    _, fx = phase_notary(device, card)
    phase_schemes(device, card, fx)
    phase_flows(device, card)
    phase_pool(device, card, fx)

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
