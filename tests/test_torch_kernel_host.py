"""The CUDA ladder source's arithmetic, compiled as host C++.

There is no nvcc and no card on the CPU test machines, so this test
compiles `corda_tpu_torch/csrc/wei_ladder.cu` with the host C++
compiler behind a small shim (`__device__`, `__global__`, `__shared__`,
`threadIdx`, ... defined away; the CUDA-runtime launcher section cut
off) and runs each kernel body once per "thread", in order, on a small
batch. The results must equal refmath after normalisation and be
canonical 12-bit digits: exact, as integer arithmetic is. It checks the
field arithmetic, the domain conversions, the table conventions and
the schedules — not the GPU's compiler or memory model, which only
chip_smoke.py and tests/test_torch_gpu.py reach. Skips where no C++
compiler is installed.
"""

import random
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corda_tpu_torch.crypto import cuda_ec, refmath  # noqa: E402
from corda_tpu_torch.crypto import limbs as L  # noqa: E402
from corda_tpu_torch.crypto import modmath as M  # noqa: E402
from corda_tpu_torch.crypto.build import CSRC_DIR  # noqa: E402
from corda_tpu_torch.crypto.curves import SECP256K1, SECP256R1  # noqa: E402

SHIM = r"""
#include <stdint.h>
#include <string.h>
#include <stdio.h>
#include <stdlib.h>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
struct Dim3 { int x; };
static Dim3 threadIdx, blockIdx;
static inline void __syncthreads() {}
"""

MAIN = r"""
int main(int argc, char** argv) {
  int mode = atoi(argv[1]);   // 0 plain, 1 windowed
  FILE* f = fopen(argv[2], "rb");
  int batch;
  CurveParams P;
  if (fread(&batch, 4, 1, f) != 1 || fread(&P, sizeof(P), 1, f) != 1) return 3;
  int32_t* in = (int32_t*)malloc(4 * 22 * batch * 4);
  if (fread(in, 4, 4 * 22 * batch, f) != (size_t)(4 * 22 * batch)) return 3;
  fclose(f);
  int32_t* out = (int32_t*)malloc(3 * 22 * batch * 4);
  for (int col = 0; col < batch; ++col) {
    blockIdx.x = col / 128; threadIdx.x = col % 128;
    int32_t *u1 = in, *u2 = in + 22 * batch, *qx = in + 44 * batch, *qy = in + 66 * batch;
    int32_t *X = out, *Y = out + 22 * batch, *Z = out + 44 * batch;
    if (mode == 0) wei_ladder_kernel(P, u1, u2, qx, qy, X, Y, Z, batch);
    else wei_ladder_windowed_kernel(P, u1, u2, qx, qy, X, Y, Z, batch);
  }
  f = fopen(argv[3], "wb");
  fwrite(out, 4, 3 * 22 * batch, f);
  fclose(f);
  return (int)(sizeof(CurveParams) / 4) == 433 ? 0 : 4;
}
"""


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (CSRC_DIR / "wei_ladder.cu").read_text()
    src = src.split("// C interface")[0]
    src = src.replace("#include <cuda_runtime.h>", "")
    d = tmp_path_factory.mktemp("wei_ladder_host")
    (d / "emu.cpp").write_text(SHIM + src + MAIN)
    exe = d / "emu"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-w", "-o", str(exe), str(d / "emu.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return exe, d


def _run(emulator, mode, curve, args):
    exe, d = emulator
    batch = args[0].shape[1]
    with open(d / "in.bin", "wb") as f:
        f.write(np.int32(batch).tobytes())
        f.write(cuda_ec.kernel_params(curve).tobytes())
        for a in args:
            f.write(np.ascontiguousarray(a, dtype=np.int32).tobytes())
    subprocess.run([str(exe), str(mode), str(d / "in.bin"), str(d / "out.bin")],
                   check=True, timeout=300)
    return np.fromfile(d / "out.bin", dtype=np.int32).reshape(3, 22, batch)


@pytest.mark.parametrize("curve", [SECP256R1, SECP256K1], ids=["p256", "k1"])
def test_kernel_source_on_host_matches_refmath(emulator, curve):
    """Both ladder kernels on 7 rows: random scalars, all-264-bit
    scalars, u1=0, u2=0, Q=G and u2 = n - u1 with Q=G (infinity), Q from
    the torch to_mont (lazily reduced digits); canonical output equal to
    refmath; exact."""
    rng = random.Random(17)
    G = (curve.gx, curve.gy)
    u1s = [rng.randrange(curve.n), rng.getrandbits(264), 0, 5, 3, rng.randrange(curve.n), 1]
    u2s = [rng.randrange(curve.n), rng.getrandbits(264), 6, 0, curve.n - 3, 0, 0]
    qs = [refmath.wei_mul(curve, rng.randrange(1, curve.n), G) for _ in range(4)] + [G, G, G]
    def tm(vals):
        """Montgomery coordinates as the torch to_mont leaves them (lazy,
        < 2p), and on rows 0-2 with k*p added (values up to 2^264, which
        the kernel folds) and one non-canonical digit (+4096 / -1)."""
        a = M.to_mont(curve.fp, torch.from_numpy(L.ints_to_batch(vals))).numpy()
        ints = L.batch_to_ints(a)
        for i in range(3):
            k = ((1 << 264) - 1 - ints[i]) // curve.p
            ints[i] += rng.randrange(k // 2, k + 1) * curve.p
        a = L.ints_to_batch(ints)
        a[0, :3] += 4096 * (a[1, :3] > 0)
        a[1, :3] -= (a[1, :3] > 0)
        return a

    args = (L.ints_to_batch(u1s), L.ints_to_batch(u2s), tm([q[0] for q in qs]), tm([q[1] for q in qs]))
    assert max(L.batch_to_ints(args[2])) >> 263   # the fold path is exercised
    want = [
        refmath.wei_add(curve, refmath.wei_mul(curve, a, G), refmath.wei_mul(curve, b, q))
        for a, b, q in zip(u1s, u2s, qs)
    ]
    assert want[4] is None
    for mode in (0, 1):
        out = _run(emulator, mode, curve, args)
        assert out.min() >= 0 and out.max() < 4096
        X, Y, Z = (L.batch_to_ints(o) for o in out)
        for i, w in enumerate(want):
            assert max(X[i], Y[i], Z[i]) < curve.p
            if w is None:
                assert (X[i], Z[i]) == (0, 0), (mode, i)
            else:
                zi = pow(Z[i], -1, curve.p)
                assert (X[i] * zi % curve.p, Y[i] * zi % curve.p) == w, (mode, i)
