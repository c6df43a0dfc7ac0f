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
