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
from corda_tpu_torch.crypto.curves import SECP256K1, SECP256R1  # noqa: E402

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
def test_kernel_matches_plain(cuda, curve, kind):
    """Each kernel equals its plain version at B=130 (a ragged
    second block), edge rows included; exact."""
    rng = random.Random(1)
    G = (curve.gx, curve.gy)
    B = 130
    u1s = [0, 5] + [rng.randrange(curve.n) for _ in range(B - 2)]
    u2s = [7, curve.n - 5] + [rng.getrandbits(264) for _ in range(B - 2)]
    qs = [G, G] + [refmath.wei_mul(curve, rng.randrange(1, curve.n), G) for _ in range(2)] * ((B - 2) // 2)
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
    assert g[1] is None
    assert all(0 <= int(c.min()) and int(c.max()) < 4096 for c in got)   # canonical digits
