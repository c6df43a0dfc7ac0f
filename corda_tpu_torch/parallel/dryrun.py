"""The flagship step and the several-card dry run.

Counterparts of __graft_entry__.py's `entry` and `dryrun_multichip`:

    python -m corda_tpu_torch.parallel.dryrun N

`dryrun_multigpu(n)` drives the production SPI over n cards, each
answer held against CpuBatchVerifier:

1. the tiny pass: a 2n-row p256 batch with tampered rows over
   `make_mesh` (and over `make_mesh_2d(2, n // 2)` when n >= 4 is even);
2. the serving pass: one 4,096-row p256 chunk over the mesh, its shard
   layout printed from `shard_shape`, every row held against the CPU
   answer of the row it repeats;
3. the per-shard pass: `per_shard_verifiers(n)`, every verifier
   dispatched with `verify_batch_async` before any is read, every row
   checked;
4. the notary pass (beyond the reference): a 4-shard
   BatchingNotaryService flush of `testing/notary_fixture.py` spends
   over `per_shard_verifiers(4)`, every answer held to its label: the
   path a node with several cards serves.

It ends with each card's launches and device-ledger rows. Without n
cards it raises (D12: the reference's dry run falls back to virtual CPU
devices); `device="cpu"` runs the same passes over n CPU devices, on the
plain versions.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from functools import partial
from typing import Optional

import torch

from . import mesh as meshlib

SERVING_ROWS = 4096
NOTARY_SPENDS = 4096
NOTARY_SHARDS = 4


def _staged_example(batch: int):
    from ..crypto import encodings, schemes
    from ..crypto.curves import SECP256R1

    rng = random.Random(7)
    items = []
    for _ in range(batch):
        kp = schemes.generate_keypair(schemes.ECDSA_SECP256R1_SHA256, seed=rng.getrandbits(64))
        msg = rng.randbytes(32)
        items.append((kp.public.data, kp.private.sign(msg), msg))
    return encodings.stage_ecdsa_packed(SECP256R1, items, batch)


def entry(device="cuda"):
    """(fn, example_args) for the flagship forward step: ECDSA p256
    verification of 8 staged rows (`ecdsa_verify_packed` on [8, 160]
    records and their [8] mask), the operands on `device`."""
    from ..crypto.curves import SECP256R1
    from ..crypto.ecdsa import ecdsa_verify_packed

    if torch.device(device).type == "cuda":
        meshlib.cuda_devices()          # raises where there is no card
    packed, valid = _staged_example(8)
    args = (torch.from_numpy(packed.copy()).to(device), torch.from_numpy(valid).to(device))
    return partial(ecdsa_verify_packed, SECP256R1), args


def devices_for(n: int, device: str = "cuda") -> list:
    """n devices: `cuda:0` .. `cuda:n-1`, or n CPU devices for
    device="cpu". Raises where fewer than n cards are visible."""
    if n < 1:
        raise ValueError(f"need at least one device, not {n}")
    if device == "cpu":
        return [torch.device("cpu", k) for k in range(n)]
    cards = meshlib.cuda_devices()
    if len(cards) < n:
        raise RuntimeError(
            f"need {n} cards, {len(cards)} visible: the dry run does not fall back "
            "to CPU devices (pass device='cpu' for that)"
        )
    return cards[:n]


def _requests(batch: int) -> list:
    from ..crypto import schemes
    from ..crypto.batch_verifier import VerificationRequest

    rng = random.Random(7)
    reqs = []
    for i in range(batch):
        kp = schemes.generate_keypair(schemes.ECDSA_SECP256R1_SHA256, seed=rng.getrandbits(64))
        msg = rng.randbytes(32)
        sig = kp.private.sign(msg)
        if i % 4 == 3 or i == batch - 1:
            msg = b"tampered:" + msg   # reject rows must scatter back right
        reqs.append(VerificationRequest(kp.public, sig, msg))
    return reqs


def _launches() -> dict:
    from ..crypto import cuda_ec

    return dict(cuda_ec.launches_by_device)


def _since(before: dict) -> dict:
    """{card index: launches} since `before` (cuda_ec.launches_by_device)."""
    out: dict = {}
    for (kernel, idx), n in _launches().items():
        if n - before.get((kernel, idx), 0):
            out[idx] = out.get(idx, 0) + n - before.get((kernel, idx), 0)
    return dict(sorted(out.items()))


def notary_pass(fx, verifiers, shards: int = NOTARY_SHARDS) -> dict:
    """Every spend of `fx` through a `shards`-shard BatchingNotaryService
    whose shards verify on `verifiers` (shard k on verifiers[k % len]),
    in one flush; raises unless every answer is its label, every accepted
    input is committed and nothing degraded. Returns the wall and the
    answers."""
    from ..node.notary import (
        BatchingNotaryService,
        ShardedUniquenessProvider,
        finish_process,
        run_process,
    )
    from ..testing.notary_fixture import answer_kind, notary_hub

    n = len(fx.spends)
    svc = BatchingNotaryService(notary_hub(fx, verifiers[0]), ShardedUniquenessProvider(shards),
                                max_batch=n, shards=shards, shard_workers=False,
                                shard_verifiers=list(verifiers), shard_queue_depth=n)
    t0 = time.perf_counter()
    started = run_process([svc.process(stx, fx.requester) for stx in fx.spends])
    svc.flush()
    answers = finish_process(started)
    wall = time.perf_counter() - t0
    kinds = [answer_kind(a) for a in answers]
    bad = [i for i, (k, want) in enumerate(zip(kinds, fx.labels)) if k != want]
    if bad:
        raise RuntimeError(f"notary pass: {len(bad)} answers differ from their labels; spend "
                           f"{bad[0]}: {answers[bad[0]]!r}, label {fx.labels[bad[0]]}")
    if len(svc.uniqueness.committed) != fx.labels.count("ok"):
        raise RuntimeError(f"notary pass: {len(svc.uniqueness.committed)} inputs committed, "
                           f"{fx.labels.count('ok')} accepted")
    if svc.degraded:
        raise RuntimeError(f"notary pass: the notary degraded: {svc.degraded_evidence}")
    return {"wall_s": wall, "answers": answers, "kinds": kinds, "service": svc}


def dryrun_multigpu(n_devices: int, device: str = "cuda", serving: int = SERVING_ROWS,
                    notary_spends: int = NOTARY_SPENDS, fixture: Optional[dict] = None) -> dict:
    """The four passes of the module docstring over `n_devices` cards (or
    CPU devices); raises on any wrong answer. `serving` rows in the
    serving pass (0 skips it) and `notary_spends` in the notary pass (0
    skips it; `fixture`: build_fixture's keywords) keep a CPU run small.
    Returns each pass's wall, the launches by card and the device
    ledger's rows."""
    from ..crypto.batch_verifier import CpuBatchVerifier, CudaBatchVerifier, per_shard_verifiers
    from ..utils import device_telemetry as devlib

    devices = devices_for(n_devices, device)
    ledger = devlib.DeviceAccounting()
    saved = devlib.get_device_accounting()
    devlib.set_device_accounting(ledger)
    walls, per_pass = {}, {}
    try:
        mesh = meshlib.make_mesh(devices)
        batch = 2 * n_devices
        reqs = _requests(batch)
        want = CpuBatchVerifier().verify_batch(reqs)
        before, t = _launches(), time.perf_counter()
        got = CudaBatchVerifier(batch_sizes=(batch,), mesh=mesh).verify_batch(reqs)
        if got != want:
            raise RuntimeError(f"mesh path diverged from the CPU reference: {got} vs {want}")
        if all(got) or not any(got):
            raise RuntimeError("expected a mix of accept and reject rows")
        if n_devices >= 4 and n_devices % 2 == 0:
            mesh2 = meshlib.make_mesh_2d(2, n_devices // 2, devices)
            if CudaBatchVerifier(batch_sizes=(batch,), mesh=mesh2).verify_batch(reqs) != want:
                raise RuntimeError("2-D (dcn x ici) mesh diverged from the CPU reference")
        walls["tiny"], per_pass["tiny"] = time.perf_counter() - t, _since(before)
        print(f"dryrun_multigpu ok: {n_devices} devices, batch {batch}", flush=True)

        if serving > 0:
            from ..crypto import encodings
            from ..crypto.curves import SECP256R1

            serving = max(-(-serving // n_devices) * n_devices, batch)
            chunk = min(serving, 4096)
            big = (reqs * ((serving + batch - 1) // batch))[:serving]
            tile = [(r.key.data, r.signature, r.message) for r in reqs]
            packed, valid = encodings.stage_ecdsa_packed(SECP256R1, tile, batch)
            for name, shape, ax in (("packed", (chunk,) + packed.shape[1:], 0),
                                    ("valid_in", (chunk,) + valid.shape[1:], -1)):
                per = meshlib.batch_sharding(mesh, len(shape), batch_axis=ax).shard_shape(shape)
                print(f"serving shard layout: {name} chunk {shape} -> {n_devices} shards of "
                      f"{per}", flush=True)
            sv = CudaBatchVerifier(batch_sizes=(chunk,), mesh=mesh)
            before, t = _launches(), time.perf_counter()     # the tiny pass loaded the kernels
            got_big = sv.verify_batch(big)
            walls["serving"], per_pass["serving"] = time.perf_counter() - t, _since(before)
            # `big` tiles `reqs`, so row i's CPU answer is want[i % batch]
            wrong = [i for i in range(serving) if got_big[i] != want[i % batch]]
            if wrong:
                raise RuntimeError(f"serving pass diverged from the CPU reference on "
                                   f"{len(wrong)} rows, the first {wrong[0]}")
            if all(got_big) or not any(got_big):
                raise RuntimeError("serving pass: expected a mix of accept and reject rows")
            print(f"serving pass ok: chunk {chunk} x {-(-serving // chunk)} over {n_devices} "
                  f"devices in {walls['serving']:.3f} s, accepts {sum(got_big)}/{serving}, "
                  f"every row equal to the CPU's; launches by device "
                  f"{json.dumps(per_pass['serving'])}", flush=True)

        shard_vs = per_shard_verifiers(n_devices, batch_sizes=(batch,), devices=devices)
        shard_batches = [reqs[(k * batch) // n_devices: ((k + 1) * batch) // n_devices]
                         for k in range(n_devices)]
        before, t = _launches(), time.perf_counter()
        handles = [v.verify_batch_async(b) for v, b in zip(shard_vs, shard_batches) if b]
        got_sharded = [ok for h in handles for ok in h.result()]
        walls["per_shard"], per_pass["per_shard"] = time.perf_counter() - t, _since(before)
        if got_sharded != want:
            raise RuntimeError("per-device sharded dispatch diverged from the CPU reference")
        pinned = sum(1 for v in shard_vs if v.device.index is not None)
        print(f"sharded dispatch ok: {len(handles)} per-shard batches on {n_devices} devices "
              f"({pinned} device-pinned), {len(got_sharded)} rows bit-exact vs CPU", flush=True)

        if notary_spends > 0:
            from ..testing.notary_fixture import build_fixture

            fx = build_fixture(notary_spends, **(fixture or {}))
            verifiers = per_shard_verifiers(NOTARY_SHARDS, devices=devices)
            before = _launches()
            out = notary_pass(fx, verifiers)
            walls["notary"], per_pass["notary"] = out["wall_s"], _since(before)
            counts = {k: out["kinds"].count(k) for k in sorted(set(out["kinds"]))}
            print(f"notary pass ok: {notary_spends} spends over {NOTARY_SHARDS} shards on "
                  f"{n_devices} devices in {out['wall_s']:.3f} s = "
                  f"{notary_spends / out['wall_s']:.1f} notarisations/s, answers {counts} "
                  f"equal to their labels; launches by device "
                  f"{json.dumps(per_pass['notary'])}", flush=True)
    finally:
        devlib.set_device_accounting(saved)
    rows = ledger.snapshot()["devices"]
    for key, row in rows.items():
        who = "the mesh (every device)" if key == -1 else f"device {key}"
        print(f"device ledger, {who}: dispatches {row['dispatches']}, requests "
              f"{row['requests']}, busy {row['busy_seconds']:.3f} s", flush=True)
    print(f"dryrun walls (s): {json.dumps({k: round(v, 3) for k, v in walls.items()})}; "
          f"launches by device per pass {json.dumps(per_pass)}", flush=True)
    return {"walls": walls, "launches": per_pass, "ledger": rows}


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="corda_tpu_torch.parallel.dryrun",
                                description="The several-card dry run of the verify SPI.")
    p.add_argument("n", type=int, help="cards")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("dryrun: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    print(_smi(), flush=True)
    from ..crypto import build

    t = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    dryrun_multigpu(args.n)
    print(f"dryrun ok: {args.n} cards in {time.perf_counter() - t:.1f} s", flush=True)
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
