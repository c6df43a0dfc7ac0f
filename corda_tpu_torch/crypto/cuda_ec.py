"""CUDA ladder kernels for the double-scalar multiplies of signature
verification, and their plain torch versions.

Port of corda_tpu/crypto/pallas_ec.py:

  kernel                                     replaces                              plain version
  wei_ladder_windowed_kernel (wei_ladder.cu) pallas_ec.wei_ladder_windowed_pallas  wei_ladder_windowed_plain
  wei_ladder_kernel          (wei_ladder.cu) pallas_ec.wei_ladder_pallas           wei_ladder_plain
  ed_ladder_windowed_kernel  (ed_ladder.cu)  pallas_ec.ed_ladder_windowed_pallas   ed_ladder_windowed_plain
  ed_ladder_kernel           (ed_ladder.cu)  pallas_ec.ed_ladder_pallas            ed_ladder_plain

Interface, as the TPU kernels: R = u1*G + u2*Q (ECDSA) or R = s*B + k*A
(ed25519) with canonical [22, B] int32 scalar digits and the affine Q
or A in the R = 2^264 Montgomery domain; returns projective (X, Y, Z)
or extended (X, Y, Z, T) in that domain. All scan every one of the 264
digit bits (zero top bits add the identity, which the complete
formulas absorb). The kernels return canonical digits, the plain
versions lazily reduced ones: compare normalised points.

What bounds them on the H100: the work is 256-bit modular multiplies
(IMAD-rate instructions; 616-704 bytes per signature never bind), but
at one signature per thread a 4,096-row chunk is 128 warps, one per
scheduler on a quarter of the card, and each warp's dependent carry
chain sets the time. All four kernels therefore spread each signature
over a group of 4 lanes (words 2g and 2g + 1 of every coordinate in
lane g; `csrc/field256_group.cuh`): the chunk fills all 132 SMs with
512 warps, and each lane's chain is a quarter as long. Each kernel has
a dedicated doubling: the RCB15 add and doubling for the curve's a
(kernel_params raises for any other a), and for ed25519 dbl-2008-hwcd
with adds of cached table entries (ed_kernel_params holds the B table
as (y - x, y + x, 2dxy)). The Weierstrass kernels multiply in the
2^256 Montgomery domain (CIOS over the group); the Edwards kernels in
the plain domain with a special-form product for 2^255 - 19, which has
no serial round.

`wei_ladder`, `wei_ladder_windowed`, `ed_ladder` and
`ed_ladder_windowed` dispatch on the tensors' device: the plain version
for CPU tensors only; on CUDA tensors they launch the kernel or raise.
Each launch adds one to the module's counter (`wei_ladder_launches`,
`wei_ladder_windowed_launches`, `ed_ladder_launches`,
`ed_ladder_windowed_launches`) and to `launches_by_device[(kernel, card
index)]`, under one lock: shard workers launch from several threads,
on several cards. The launch runs on the current stream of the card its
operands are on, so a library serves every card (the kernels take their
parameters by value). `kernel_resources` reports a kernel's registers,
stack, static shared memory and resident warps per SM.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import numpy as np
import torch

from . import build
from .curves import EdwardsCurve, WeierstrassCurve
from .ec import (
    _b_table_mont,
    _g_table_mont,
    ed_affine_to_ext,
    ed_double_scalar_mul,
    ed_double_scalar_mul_windowed,
    wei_affine_to_proj,
    wei_double_scalar_mul,
    wei_double_scalar_mul_windowed,
)
from .limbs import NLIMB, R_BITS

LADDER_BITS = NLIMB * 12     # 264: every digit bit, as the TPU kernels scan

wei_ladder_launches = 0
wei_ladder_windowed_launches = 0
ed_ladder_launches = 0
ed_ladder_windowed_launches = 0
launches_by_device: dict[tuple[str, int], int] = {}
_COUNT_LOCK = threading.Lock()


def _count_device(kernel: str, dev: torch.device) -> None:
    """One launch of `kernel` on card `dev` (caller holds _COUNT_LOCK)."""
    key = (kernel, dev.index)
    launches_by_device[key] = launches_by_device.get(key, 0) + 1


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


def ed_ladder_plain(curve: EdwardsCurve, s, k, ax_m, ay_m):
    """Plain Edwards bit ladder over all 264 digit bits."""
    A = ed_affine_to_ext(curve.fp, ax_m, ay_m)
    return ed_double_scalar_mul(curve, s, k, A, nbits=LADDER_BITS)


def ed_ladder_windowed_plain(curve: EdwardsCurve, s, k, ax_m, ay_m):
    """w=4 fixed-window Edwards ladder over all 264 digit bits."""
    A = ed_affine_to_ext(curve.fp, ax_m, ay_m)
    return ed_double_scalar_mul_windowed(curve, s, k, A, nbits=LADDER_BITS)


# ---------------------------------------------------------------------------
# kernels


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


@lru_cache(maxsize=None)
def kernel_params(curve: WeierstrassCurve) -> np.ndarray:
    """wei_ladder.cu's CurveParams struct as uint32 words: p, 2^256 mod p,
    2^248, 2^264 mod p, the formulas' b multiple (b for a = -3, 3b for
    a = 0) in the R = 2^256 domain, the a = 0 flag that picks the
    kernel's formulas, -p^-1 mod 2^32, and the G table. The kernels have
    dedicated formulas for a = 0 and a = -3 only: any other a raises."""
    p = curve.p
    R = 1 << 256
    a = curve.a % p
    if a not in (0, p - 3):
        raise ValueError(f"{curve.name}: the ladder kernels need a = 0 or a = -3, not {curve.a}")
    bm = (3 * curve.b if a == 0 else curve.b) % p
    one = _fold_constant(curve)
    g = [[0] * 8 + _words(one) + [0] * 8]            # entry 0: infinity
    g += [
        _words(x) + _words(y) + _words(one)
        for x, y in _g_table_mont(curve, 16, r_bits=256)
    ]
    words = (
        _words(p) + _words(one) + _words(1 << 248) + _words((1 << R_BITS) % p)
        + _words(bm * R % p)
        + [int(a == 0)]
        + [_pinv32(p)]
        + [w for entry in g for w in entry]
    )
    return np.array(words, dtype=np.uint32)


@lru_cache(maxsize=None)
def ed_kernel_params(curve: EdwardsCurve) -> np.ndarray:
    """ed_ladder.cu's EdParams struct as uint32 words: p, 2^256 mod p
    (the entry fold), 2^-8 and 2^520 mod p (the one-thread Montgomery
    multiplies at entry and exit take the 2^264 domain to the kernel's
    plain one and back), 2d, -p^-1 mod 2^32, and the B table cached for
    the kernel's mixed add (entry j = j*B as (y - x, y + x, 2d*x*y);
    entry 0 = the identity, (1, 1, 0)). The kernel's field is plain
    integers mod p (its multiply is special-form), so no constant here
    is in a Montgomery domain."""
    p = curve.p
    d2 = 2 * curve.d % p
    b = [_words(1) + _words(1) + [0] * 8]   # entry 0: identity
    b += [
        _words((y - x) % p) + _words((y + x) % p) + _words(d2 * t % p)
        for x, y, t in _b_table_mont(curve, 16, r_bits=0)
    ]
    words = (
        _words(p) + _words(_fold_constant(curve)) + _words(pow(2, -8, p)) + _words(pow(2, 520, p))
        + _words(d2)
        + [_pinv32(p)]
        + [w for entry in b for w in entry]
    )
    return np.array(words, dtype=np.uint32)


def _fold_constant(curve) -> int:
    one = (1 << 256) % curve.p
    if one >> 225:
        # load_coord's four folds need 2^256 mod p < 2^225
        raise ValueError(f"{curve.name}: 2^256 mod p too large for the kernel")
    return one


def _pinv32(p: int) -> int:
    return (-pow(p, -1, 1 << 32)) % (1 << 32)


# per library: (launch entry, params-size entry, resources entry, number
# of outputs)
_ENTRIES = {
    "wei_ladder": ("corda_wei_ladder", "corda_wei_params_words", "corda_wei_kernel_info", 3),
    "ed_ladder": ("corda_ed_ladder", "corda_ed_params_words", "corda_ed_kernel_info", 4),
}
_SIGNED: set[str] = set()


def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    if name not in _SIGNED:
        launch, words, info, n_out = _ENTRIES[name]
        p = ctypes.c_void_p
        getattr(lib, launch).argtypes = [ctypes.c_int] + [p] * (5 + n_out) + [ctypes.c_int, p]
        getattr(lib, launch).restype = ctypes.c_int
        getattr(lib, words).argtypes = []
        getattr(lib, words).restype = ctypes.c_int
        getattr(lib, info).argtypes = [ctypes.c_int, p, p]
        getattr(lib, info).restype = ctypes.c_int
        lib.corda_cuda_error_string.argtypes = [ctypes.c_int]
        lib.corda_cuda_error_string.restype = ctypes.c_char_p
        _SIGNED.add(name)
    return lib


def _check_operands(names, tensors) -> None:
    first = tensors[0]
    for name, t in zip(names, tensors):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the CUDA ladder needs a CUDA tensor")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {names[0]} on {first.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} has dtype {t.dtype}, need int32")
        if t.dim() != 2 or t.shape[0] != NLIMB or t.shape[1] != first.shape[1]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, need ({NLIMB}, {first.shape[1]})")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if first.shape[1] == 0:
        raise ValueError("empty batch")


def _launch(name: str, windowed: bool, params: np.ndarray, names, ins):
    """Launch csrc/<name>.cu's ladder on `ins` (four [22, B] int32 CUDA
    tensors); returns the output tensors."""
    _check_operands(names, ins)
    lib = _lib(name)
    launch, words, _, n_out = _ENTRIES[name]
    if getattr(lib, words)() != params.size:
        raise build.KernelBuildError(f"{name}: parameter layout differs between kernel and wrapper")
    outs = [torch.empty_like(ins[0]) for _ in range(n_out)]
    dev = ins[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, launch)(
            int(windowed), params.ctypes.data,
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            ins[0].shape[1], stream,
        )
    if rc != 0:
        msg = lib.corda_cuda_error_string(rc).decode()
        raise DeviceFaultError(f"{name} launch failed: {msg} (cudaError {rc})")
    return tuple(outs)


def kernel_resources(name: str, windowed: bool, params: np.ndarray) -> dict:
    """Registers, stack bytes, static shared bytes and resident warps per
    SM of the kernel that csrc/<name>.cu launches for (windowed, params),
    from the CUDA runtime on the current card."""
    lib = _lib(name)
    out = (ctypes.c_int * 4)()
    rc = getattr(lib, _ENTRIES[name][2])(int(windowed), params.ctypes.data, out)
    if rc != 0:
        msg = lib.corda_cuda_error_string(rc).decode()
        raise DeviceFaultError(f"{name} kernel attributes: {msg} (cudaError {rc})")
    return dict(zip(("registers", "stack_bytes", "shared_bytes", "warps_per_sm"), out))


_WEI_NAMES = ("u1", "u2", "qx_m", "qy_m")
_ED_NAMES = ("s", "k", "ax_m", "ay_m")


def wei_ladder_cuda(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """Launch the plain-ladder kernel (CUDA tensors only)."""
    global wei_ladder_launches
    out = _launch("wei_ladder", False, kernel_params(curve), _WEI_NAMES, (u1, u2, qx_m, qy_m))
    with _COUNT_LOCK:
        wei_ladder_launches += 1
        _count_device("wei_ladder", u1.device)
    return out


def wei_ladder_windowed_cuda(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """Launch the windowed-ladder kernel (CUDA tensors only)."""
    global wei_ladder_windowed_launches
    out = _launch("wei_ladder", True, kernel_params(curve), _WEI_NAMES, (u1, u2, qx_m, qy_m))
    with _COUNT_LOCK:
        wei_ladder_windowed_launches += 1
        _count_device("wei_ladder_windowed", u1.device)
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


def ed_ladder_cuda(curve: EdwardsCurve, s, k, ax_m, ay_m):
    """Launch the plain Edwards ladder kernel (CUDA tensors only)."""
    global ed_ladder_launches
    out = _launch("ed_ladder", False, ed_kernel_params(curve), _ED_NAMES, (s, k, ax_m, ay_m))
    with _COUNT_LOCK:
        ed_ladder_launches += 1
        _count_device("ed_ladder", s.device)
    return out


def ed_ladder_windowed_cuda(curve: EdwardsCurve, s, k, ax_m, ay_m):
    """Launch the windowed Edwards ladder kernel (CUDA tensors only)."""
    global ed_ladder_windowed_launches
    out = _launch("ed_ladder", True, ed_kernel_params(curve), _ED_NAMES, (s, k, ax_m, ay_m))
    with _COUNT_LOCK:
        ed_ladder_windowed_launches += 1
        _count_device("ed_ladder_windowed", s.device)
    return out


def ed_ladder(curve: EdwardsCurve, s, k, ax_m, ay_m):
    """R = s*B + k*A, plain bit ladder: the plain version for CPU
    tensors, the CUDA kernel otherwise (or raise)."""
    if s.device.type == "cpu":
        return ed_ladder_plain(curve, s, k, ax_m, ay_m)
    return ed_ladder_cuda(curve, s, k, ax_m, ay_m)


def ed_ladder_windowed(curve: EdwardsCurve, s, k, ax_m, ay_m):
    """R = s*B + k*A, w=4 windowed ladder: the plain version for CPU
    tensors, the CUDA kernel otherwise (or raise)."""
    if s.device.type == "cpu":
        return ed_ladder_windowed_plain(curve, s, k, ax_m, ay_m)
    return ed_ladder_windowed_cuda(curve, s, k, ax_m, ay_m)
