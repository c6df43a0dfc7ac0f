"""CUDA ladder kernels for the ECDSA double-scalar multiply, and their
plain torch versions.

Port of the Weierstrass half of corda_tpu/crypto/pallas_ec.py:

  kernel (csrc/wei_ladder.cu)      replaces                         plain version
  wei_ladder_windowed_kernel       pallas_ec.wei_ladder_windowed_pallas  wei_ladder_windowed_plain
  wei_ladder_kernel                pallas_ec.wei_ladder_pallas           wei_ladder_plain

Interface, as the TPU kernels: R = u1*G + u2*Q with u1, u2 canonical
[22, B] int32 digits and qx_m, qy_m the affine Q in the R = 2^264
Montgomery domain; returns projective (X, Y, Z) in that domain. Both
scan all 264 digit bits (scalars < 2^256 make the top bits add the
identity, which the complete formulas absorb). The kernels return
canonical digits, the plain versions lazily reduced ones: compare
normalised points.

`wei_ladder` and `wei_ladder_windowed` dispatch on the tensors' device:
the plain version for CPU tensors only; on CUDA tensors they launch
the kernel or raise. Each launch adds one to the module's counter
(`wei_ladder_launches`, `wei_ladder_windowed_launches`).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import build
from .curves import WeierstrassCurve
from .ec import (
    _g_table_mont,
    wei_affine_to_proj,
    wei_double_scalar_mul,
    wei_double_scalar_mul_windowed,
)
from .limbs import NLIMB, R_BITS

LADDER_BITS = NLIMB * 12     # 264: every digit bit, as the TPU kernels scan

wei_ladder_launches = 0
wei_ladder_windowed_launches = 0


class DeviceFaultError(RuntimeError):
    """A device/kernel dispatch failed (launch refused, CUDA error,
    device lost). The batching notary's degraded-mode seam catches
    exactly this class of failure."""


# Default ladder per curve family, as the reference's measured table
# (pallas_ec.py:76): windowed for p256, plain for k1 and ed25519.
_WINDOWED_DEFAULT = {"p256": True, "k1": False, "ed25519": False}


def use_windowed_ladder(curve_tag: str = "p256", windowed: bool | None = None) -> bool:
    """w=4 fixed-window ladder vs the plain bit ladder for `curve_tag`
    in {"p256", "k1", "ed25519"}; an explicit `windowed` wins. Unknown
    tags get the plain ladder, as in the reference."""
    if windowed is not None:
        return bool(windowed)
    return _WINDOWED_DEFAULT.get(curve_tag, False)


def curve_tag(curve: WeierstrassCurve) -> str:
    return "p256" if curve.name == "secp256r1" else "k1"


# ---------------------------------------------------------------------------
# plain versions (torch ops over ec.py)


def wei_ladder_plain(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """Plain Shamir bit ladder over all 264 digit bits."""
    Q = wei_affine_to_proj(curve.fp, qx_m, qy_m)
    return wei_double_scalar_mul(curve, u1, u2, Q, nbits=LADDER_BITS)


def wei_ladder_windowed_plain(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """w=4 fixed-window ladder over all 264 digit bits (66 windows)."""
    Q = wei_affine_to_proj(curve.fp, qx_m, qy_m)
    return wei_double_scalar_mul_windowed(curve, u1, u2, Q, nbits=LADDER_BITS)


# ---------------------------------------------------------------------------
# kernels


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


@lru_cache(maxsize=None)
def kernel_params(curve: WeierstrassCurve) -> np.ndarray:
    """The kernel's CurveParams struct as uint32 words (host constants
    in the kernel's R = 2^256 Montgomery domain)."""
    p = curve.p
    R = 1 << 256
    one = R % p
    if one >> 225:
        # load_coord's four folds need 2^256 mod p < 2^225
        raise ValueError(f"{curve.name}: 2^256 mod p too large for the kernel")
    g = [[0] * 8 + _words(one) + [0] * 8]            # entry 0: infinity
    g += [
        _words(x) + _words(y) + _words(one)
        for x, y in _g_table_mont(curve, 16, r_bits=256)
    ]
    words = (
        _words(p)
        + _words(one)
        + _words(1 << 248)
        + _words((1 << R_BITS) % p)
        + _words((curve.a % p) * R % p)
        + _words((3 * curve.b % p) * R % p)
        + [(-pow(p, -1, 1 << 32)) % (1 << 32)]
        + [w for entry in g for w in entry]
    )
    return np.array(words, dtype=np.uint32)


_LIB_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _LIB_SIGNED
    lib = build.load("wei_ladder")
    if not _LIB_SIGNED:
        p = ctypes.c_void_p
        lib.corda_wei_ladder.argtypes = [
            ctypes.c_int, p, p, p, p, p, p, p, p, ctypes.c_int, p,
        ]
        lib.corda_wei_ladder.restype = ctypes.c_int
        lib.corda_wei_params_words.argtypes = []
        lib.corda_wei_params_words.restype = ctypes.c_int
        lib.corda_cuda_error_string.argtypes = [ctypes.c_int]
        lib.corda_cuda_error_string.restype = ctypes.c_char_p
        _LIB_SIGNED = True
    return lib


def _check_operands(u1, u2, qx_m, qy_m) -> None:
    for name, t in (("u1", u1), ("u2", u2), ("qx_m", qx_m), ("qy_m", qy_m)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the CUDA ladder needs a CUDA tensor")
        if t.device != u1.device:
            raise ValueError(f"{name} is on {t.device}, u1 on {u1.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} has dtype {t.dtype}, need int32")
        if t.dim() != 2 or t.shape[0] != NLIMB or t.shape[1] != u1.shape[1]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, need ({NLIMB}, {u1.shape[1]})")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if u1.shape[1] == 0:
        raise ValueError("empty batch")


def _launch(windowed: bool, curve, u1, u2, qx_m, qy_m):
    _check_operands(u1, u2, qx_m, qy_m)
    lib = _lib()
    params = kernel_params(curve)
    if lib.corda_wei_params_words() != params.size:
        raise build.KernelBuildError("CurveParams layout differs between kernel and wrapper")
    X, Y, Z = (torch.empty_like(u1) for _ in range(3))
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream(u1.device).cuda_stream
        rc = lib.corda_wei_ladder(
            int(windowed), params.ctypes.data,
            u1.data_ptr(), u2.data_ptr(), qx_m.data_ptr(), qy_m.data_ptr(),
            X.data_ptr(), Y.data_ptr(), Z.data_ptr(), u1.shape[1], stream,
        )
    if rc != 0:
        msg = lib.corda_cuda_error_string(rc).decode()
        raise DeviceFaultError(f"wei_ladder launch failed: {msg} (cudaError {rc})")
    return X, Y, Z


def wei_ladder_cuda(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """Launch the plain-ladder kernel (CUDA tensors only)."""
    global wei_ladder_launches
    out = _launch(False, curve, u1, u2, qx_m, qy_m)
    wei_ladder_launches += 1
    return out


def wei_ladder_windowed_cuda(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """Launch the windowed-ladder kernel (CUDA tensors only)."""
    global wei_ladder_windowed_launches
    out = _launch(True, curve, u1, u2, qx_m, qy_m)
    wei_ladder_windowed_launches += 1
    return out


def wei_ladder(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """R = u1*G + u2*Q, plain bit ladder: the plain version for CPU
    tensors, the CUDA kernel otherwise (or raise)."""
    if u1.device.type == "cpu":
        return wei_ladder_plain(curve, u1, u2, qx_m, qy_m)
    return wei_ladder_cuda(curve, u1, u2, qx_m, qy_m)


def wei_ladder_windowed(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """R = u1*G + u2*Q, w=4 windowed ladder: the plain version for CPU
    tensors, the CUDA kernel otherwise (or raise)."""
    if u1.device.type == "cpu":
        return wei_ladder_windowed_plain(curve, u1, u2, qx_m, qy_m)
    return wei_ladder_windowed_cuda(curve, u1, u2, qx_m, qy_m)
