"""Kernel tests that need a CUDA card (marker `gpu`; they skip
elsewhere). Run them on a machine with the card:

    python -m pytest tests/test_torch_gpu.py -m gpu

Each CUDA kernel is held against its plain torch version on the same
card tensors; points compare after normalisation, exactly.
"""

import random

import pytest

torch = pytest.importorskip("torch")

from corda_tpu_torch.crypto import cuda_ec, refmath  # noqa: E402
from corda_tpu_torch.crypto import limbs as L  # noqa: E402
from corda_tpu_torch.crypto import modmath as M  # noqa: E402
from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _affine(curve, P):
    X, Y, Z = (L.batch_to_ints(c.cpu().numpy()) for c in P)
    out = []
    for x, y, z in zip(X, Y, Z):
        z %= curve.p
        out.append(None if z == 0 else (x * pow(z, -1, curve.p) % curve.p,
                                        y * pow(z, -1, curve.p) % curve.p))
    return out


@pytest.mark.parametrize("curve", [SECP256R1, SECP256K1], ids=["p256", "k1"])
@pytest.mark.parametrize("kind", ["plain", "windowed"])
@pytest.mark.parametrize("B", [130, 1])
def test_kernel_matches_plain(cuda, curve, kind, B):
    """Each kernel equals its plain version at B=130 and B=1 (partial
    groups, warps and blocks), edge rows included; exact."""
    rng = random.Random(1)
    G = (curve.gx, curve.gy)
    u1s = ([0, 5] + [rng.randrange(curve.n) for _ in range(128)])[:B]
    u2s = ([7, curve.n - 5] + [rng.getrandbits(264) for _ in range(128)])[:B]
    qs = ([G, G] + [refmath.wei_mul(curve, rng.randrange(1, curve.n), G) for _ in range(2)] * 64)[:B]
    dev = [torch.from_numpy(L.ints_to_batch(v)).to(cuda) for v in (u1s, u2s)]
    qx = M.to_mont(curve.fp, torch.from_numpy(L.ints_to_batch([q[0] for q in qs])).to(cuda))
    qy = M.to_mont(curve.fp, torch.from_numpy(L.ints_to_batch([q[1] for q in qs])).to(cuda))
    if kind == "plain":
        got = cuda_ec.wei_ladder_cuda(curve, *dev, qx, qy)
        want = cuda_ec.wei_ladder_plain(curve, *dev, qx, qy)
    else:
        got = cuda_ec.wei_ladder_windowed_cuda(curve, *dev, qx, qy)
        want = cuda_ec.wei_ladder_windowed_plain(curve, *dev, qx, qy)
    torch.cuda.synchronize()
    g = _affine(curve, got)
    assert g == _affine(curve, want)
    assert g[0] == refmath.wei_mul(curve, 7, G)
    assert B == 1 or g[1] is None
    assert all(0 <= int(c.min()) and int(c.max()) < 4096 for c in got)   # canonical digits


@pytest.mark.parametrize("kind", ["plain", "windowed"])
@pytest.mark.parametrize("B", [130, 1])
def test_ed_kernel_matches_plain(cuda, kind, B):
    """Each Edwards kernel equals its plain version at B=130 and B=1
    (partial groups, warps and blocks): s = 0, k = 0, A = identity,
    s = L, s + L, A of order 2, scalars using all 264 digit bits;
    canonical digits, X*Y == Z*T; exact after normalisation."""
    c = ED25519
    rng = random.Random(2)
    base = (c.gx, c.gy)
    pts = [refmath.ed_mul(c, rng.randrange(1, c.L), base) for _ in range(4)]
    ss = ([0, 5, 9, c.L, c.L + 3, 11] + [rng.getrandbits(264 if i % 5 == 0 else 256) for i in range(124)])[:B]
    ks = ([7, 0, 4, 8, 6, 13] + [rng.randrange(c.L) for _ in range(124)])[:B]
    As = ([pts[0], pts[1], (0, 1), pts[2], pts[3], (0, c.p - 1)] + [pts[i % 4] for i in range(124)])[:B]
    dev = [torch.from_numpy(L.ints_to_batch(v)).to(cuda) for v in (ss, ks)]
    ax = M.to_mont(c.fp, torch.from_numpy(L.ints_to_batch([a[0] for a in As])).to(cuda))
    ay = M.to_mont(c.fp, torch.from_numpy(L.ints_to_batch([a[1] for a in As])).to(cuda))
    if kind == "plain":
        got = cuda_ec.ed_ladder_cuda(c, *dev, ax, ay)
        want = cuda_ec.ed_ladder_plain(c, *dev, ax, ay)
    else:
        got = cuda_ec.ed_ladder_windowed_cuda(c, *dev, ax, ay)
        want = cuda_ec.ed_ladder_windowed_plain(c, *dev, ax, ay)
    torch.cuda.synchronize()
    X, Y, Z, T = (L.batch_to_ints(t.cpu().numpy()) for t in got)
    assert all(0 <= int(t.min()) and int(t.max()) < 4096 for t in got)   # canonical digits
    assert all((x * y - z * t) % c.p == 0 for x, y, z, t in zip(X, Y, Z, T))
    g = _affine(c, got[:3])
    assert g == _affine(c, want[:3])
    assert g[0] == refmath.ed_mul(c, 7, pts[0])          # s = 0
    if B > 3:
        assert g[2] == refmath.ed_mul(c, 9, base)        # A = identity
        assert g[3] == refmath.ed_mul(c, 8, pts[2])      # s = L: s*B = 0


def test_device_sampler_reads_the_card(cuda):
    """The default DeviceSampler lists every card with the reference's
    row shape: platform "gpu", the card's name, its total memory as the
    limit, and the allocator's census counting a resident tensor."""
    from corda_tpu_torch.utils import device_telemetry as dlib

    pin = torch.ones((1 << 20,), dtype=torch.float32, device=cuda)
    rows = dlib.DeviceSampler().sample()
    assert [r["id"] for r in rows] == list(range(torch.cuda.device_count()))
    row = rows[torch.cuda.current_device()]
    assert row["platform"] == "gpu" and row["kind"] == torch.cuda.get_device_name()
    hbm = row["hbm"]
    assert hbm["bytes_limit"] == torch.cuda.get_device_properties(row["id"]).total_memory
    assert hbm["bytes_in_use"] >= pin.numel() * 4 and 0 < hbm["utilization"] < 1
    assert row["live_buffers"]["count"] >= 1 and row["live_buffers"]["bytes"] >= pin.numel() * 4
    del pin


def test_verifier_accounting_on_the_card(cuda):
    """A CudaBatchVerifier on cuda:0 records each chunk into both ledgers:
    the first call of a (scheme, batch) as the compile, the next as an
    execute, the staging copy's bytes and seconds, and the dispatch on
    device 0 with its queue wait; the device plane windows the busy
    seconds."""
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier
    from corda_tpu_torch.testing.selfcheck import build_requests
    from corda_tpu_torch.utils import device_telemetry as dlib
    from corda_tpu_torch.utils import perf as plib

    acct, devacct = plib.KernelAccounting(), dlib.DeviceAccounting()
    dlib.set_device_accounting(devacct)
    try:
        v = CudaBatchVerifier(batch_sizes=(128,), device=torch.device("cuda", 0), perf=acct)
        reqs = build_requests(96, seed=3, scheme_ids=(schemes.EDDSA_ED25519_SHA512,))
        first = v.verify_batch(reqs)
        acct.mark_warm()
        assert v.verify_batch(reqs) == first
    finally:
        dlib.set_device_accounting(None)
    row = acct.snapshot()["keys"][f"scheme{schemes.EDDSA_ED25519_SHA512}/batch128"]
    assert (row["compiles"], row["executes"]) == (1, 1) and acct.retraces == 0
    assert row["transfer_bytes"] == 2 * 128 * (128 + 4 + 4 + 1)
    assert row["transfer_seconds"] > 0 and row["execute_seconds"] > 0
    dev = devacct.snapshot()["devices"][0]
    assert dev["dispatches"] == 2 and dev["requests"] == 192
    assert dev["busy_seconds"] > 0 and dev["queue_wait_seconds"] > 0
    assert dev["transfer_bytes"] == row["transfer_bytes"]


def test_mesh_and_per_shard_verifiers_on_every_card(cuda):
    """A chunk split over a mesh of every visible card, and one
    per-shard verifier per card dispatched before any is read, answer
    every row as CpuBatchVerifier does; each card launched its own
    kernels (cuda_ec.launches_by_device), the mesh's dispatch is keyed -1
    in the device ledger and each pinned verifier's by its card."""
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.batch_verifier import (
        CpuBatchVerifier,
        CudaBatchVerifier,
        per_shard_verifiers,
    )
    from corda_tpu_torch.parallel import mesh as meshlib
    from corda_tpu_torch.testing.selfcheck import build_requests
    from corda_tpu_torch.utils import device_telemetry as dlib

    cards = meshlib.cuda_devices()
    n = len(cards)
    reqs = []
    for sid in (schemes.ECDSA_SECP256R1_SHA256, schemes.ECDSA_SECP256K1_SHA256,
                schemes.EDDSA_ED25519_SHA512):
        reqs += build_requests(16 * n, seed=sid, scheme_ids=(sid,))
    want = CpuBatchVerifier().verify_batch(reqs)
    devacct = dlib.DeviceAccounting()
    dlib.set_device_accounting(devacct)
    before = dict(cuda_ec.launches_by_device)
    try:
        got = CudaBatchVerifier(batch_sizes=(16 * n,), mesh=meshlib.make_mesh()).verify_batch(reqs)
        shard_vs = per_shard_verifiers(n, batch_sizes=(128,), devices=cards)
        handles = [v.verify_batch_async(reqs[k::n]) for k, v in enumerate(shard_vs)]
        per_shard = [h.result() for h in handles]
    finally:
        dlib.set_device_accounting(None)
    assert got == want and True in got and False in got
    assert per_shard == [want[k::n] for k in range(n)]
    launched = {idx for (kernel, idx), c in cuda_ec.launches_by_device.items()
                if c > before.get((kernel, idx), 0)}
    assert launched == set(range(n))
    rows = devacct.snapshot()["devices"]
    assert rows[-1]["dispatches"] == 3 and rows[-1]["requests"] == len(reqs)
    if n > 1:
        assert [rows[k]["dispatches"] for k in range(n)] == [3] * n
    with pytest.raises(ValueError, match="mutually exclusive"):
        CudaBatchVerifier(mesh=meshlib.make_mesh(), device=cards[0])


def _reduced(a, p):
    return [v % p for v in L.batch_to_ints(a.cpu().numpy())]


def _same_outputs(got, want, p, exact: int):
    """The first `exact` outputs and every bool output equal, the other
    digit outputs canonical and equal mod p."""
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if i < exact or g.dtype == torch.bool:
            assert torch.equal(g.cpu(), w.cpu()), i
        else:
            assert int(g.min()) >= 0 and int(g.max()) < 4096, i   # canonical digits
            assert _reduced(g, p) == _reduced(w, p), i


@pytest.mark.parametrize("B", [130, 1, 3, 4097])
def test_ed_ends_kernels_match_plain(cuda, B):
    """ed_prologue_kernel and ed_epilogue_kernel (a row per group of 4
    lanes) equal their plain versions at B=130, B=1, B=3 (a partial
    group) and B=4097 (a ragged group at the chunk's end) on the crafted
    rows of selfcheck.ed25519_prologue_rows / ed25519_epilogue_rows (A.y
    = 0, 1, p - 1, >= p, off the curve; R.y + p, a flipped sign, Z = 0);
    exact."""
    from corda_tpu_torch.crypto import eddsa
    from corda_tpu_torch.testing import selfcheck

    def dev(a):
        return torch.from_numpy(a.copy()).to(cuda)

    packed, a_sign, valid = selfcheck.ed25519_prologue_rows(B, seed=31)
    args = (dev(packed), dev(a_sign), dev(valid))
    _same_outputs(cuda_ec.ed_prologue_cuda(*args), eddsa.ed_prologue_plain(*args), ED25519.p, 2)
    R, packed, r_sign, ok = selfcheck.ed25519_epilogue_rows(B, seed=32)
    args = (tuple(dev(x) for x in R), dev(packed), dev(r_sign), dev(ok))
    _same_outputs([cuda_ec.ed_epilogue_cuda(*args)], [eddsa.ed_epilogue_plain(*args)], ED25519.p, 1)


@pytest.mark.parametrize("curve", [SECP256R1, SECP256K1], ids=["p256", "k1"])
@pytest.mark.parametrize("B", [130, 1, 3, 4097])
def test_ecdsa_ends_kernels_match_plain(cuda, curve, B):
    """ecdsa_prologue_kernel and ecdsa_epilogue_kernel (a row per group
    of 4 lanes) equal their plain versions at B=130, B=1, B=3 (a partial
    group) and B=4097 (a ragged group at the chunk's end) on the crafted
    rows of selfcheck.ecdsa_prologue_rows / ecdsa_epilogue_rows (z >= n,
    r and s out of range, Q off the curve or >= p, the r + n row; r + n
    >= p, r = 2^256 - 1, Z = 0); exact."""
    from corda_tpu_torch.crypto import ecdsa
    from corda_tpu_torch.testing import selfcheck

    def dev(a):
        return torch.from_numpy(a.copy()).to(cuda)

    packed, valid = selfcheck.ecdsa_prologue_rows(curve, B, seed=33)
    args = (dev(packed), dev(valid))
    _same_outputs(cuda_ec.ecdsa_prologue_cuda(curve, *args),
                  ecdsa.ecdsa_prologue_plain(curve, *args), curve.p, 2)
    R, packed, valid = selfcheck.ecdsa_epilogue_rows(curve, B, seed=34)
    args = (tuple(dev(x) for x in R), dev(packed), dev(valid))
    _same_outputs([cuda_ec.ecdsa_epilogue_cuda(curve, *args)],
                  [ecdsa.ecdsa_epilogue_plain(curve, *args)], curve.p, 1)


def test_verify_on_the_card_launches_the_ends(cuda):
    """A CudaBatchVerifier call over every scheme answers as
    CpuBatchVerifier does and launches each scheme's prologue and
    epilogue kernels once per chunk."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier, CudaBatchVerifier
    from corda_tpu_torch.testing.selfcheck import build_requests, ed25519_edge_requests

    reqs = build_requests(96, seed=35) + [r for _, r in ed25519_edge_requests(seed=35)]
    names = ("ed_prologue", "ed_epilogue", "ecdsa_prologue", "ecdsa_epilogue")
    before = {n: getattr(cuda_ec, n + "_launches") for n in names}
    got = CudaBatchVerifier(batch_sizes=(128,), device=cuda).verify_batch(reqs)
    assert got == CpuBatchVerifier().verify_batch(reqs) and True in got and False in got
    moved = {n: getattr(cuda_ec, n + "_launches") - before[n] for n in names}
    assert moved == {"ed_prologue": 1, "ed_epilogue": 1, "ecdsa_prologue": 2, "ecdsa_epilogue": 2}
