"""CUDA kernels of signature verification, and their plain torch
versions: the ladders (the double-scalar multiplies) and the verify
programs around them.

Port of corda_tpu/crypto/pallas_ec.py:

  kernel                                     replaces                              plain version
  wei_ladder_windowed_kernel (wei_ladder.cu) pallas_ec.wei_ladder_windowed_pallas  wei_ladder_windowed_plain
  wei_ladder_kernel          (wei_ladder.cu) pallas_ec.wei_ladder_pallas           wei_ladder_plain
  ed_ladder_windowed_kernel  (ed_ladder.cu)  pallas_ec.ed_ladder_windowed_pallas   ed_ladder_windowed_plain
  ed_ladder_kernel           (ed_ladder.cu)  pallas_ec.ed_ladder_pallas            ed_ladder_plain

and of the device program around the ladders, which replaces no Pallas
kernel: in the reference the whole verification is one jitted XLA
program per scheme, whose Fermat powers and square root are lax.scan
loops (modmath.mont_pow_const); the port ran them as host-issued torch
ops, tens of thousands per chunk:

  kernel                                 replaces (the lax.scan programs of)      plain version
  ed_prologue_kernel    (ed_ends.cu)     eddsa.ed_decompress_neg_batch + unpack   eddsa.ed_prologue_plain
  ed_epilogue_kernel    (ed_ends.cu)     ec.ed_ext_to_affine + the compare        eddsa.ed_epilogue_plain
  ecdsa_prologue_kernel (wei_ends.cu)    ecdsa_verify_packed's checks, scalars    ecdsa.ecdsa_prologue_plain
  ecdsa_epilogue_kernel (wei_ends.cu)    ecdsa_verify_packed's check after R      ecdsa.ecdsa_epilogue_plain

What bounds those four: IMAD-rate 256-bit multiplies (~270-400 per row
for the prologues and the ed25519 epilogue, 5 for the ECDSA epilogue)
in a serial chain per row. The ECDSA pair runs one row per thread, so a
4,096-row chunk is 128 warps and the chain's latency, not the IMAD rate,
sets the time; the ed25519 pair runs a row per group of 4 lanes on the
ladders' special-form field (512 warps).
Their dispatching wrappers are eddsa.ed_prologue / ed_epilogue and
ecdsa.ecdsa_prologue / ecdsa_epilogue.

Ladder interface, as the TPU kernels: R = u1*G + u2*Q (ECDSA) or
R = s*B + k*A (ed25519) with canonical [22, B] int32 scalar digits and
the affine Q or A in the R = 2^264 Montgomery domain; returns
projective (X, Y, Z) or extended (X, Y, Z, T) in that domain. All scan
every one of the 264 digit bits (zero top bits add the identity, which the complete
formulas absorb). The kernels return canonical digits, the plain
versions lazily reduced ones: compare normalised points.

What bounds the ladders on the H100: the work is 256-bit modular
multiplies (IMAD-rate instructions; 616-704 bytes per signature never
bind), but at one signature per thread a 4,096-row chunk is 128 warps, one per
scheduler on a quarter of the card, and each warp's dependent carry
chain sets the time. All four ladders therefore spread each signature
over a group of 4 lanes (words 2g and 2g + 1 of every coordinate in
lane g; `csrc/field256_group.cuh`): the chunk fills all 132 SMs with
512 warps, and each lane's chain is a quarter as long. Each ladder has
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
Each launch of any of the eight kernels adds one to the module's
counter (`<kernel>_launches`: `wei_ladder_launches`, ...,
`ecdsa_epilogue_launches`) and to `launches_by_device[(kernel, card
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
from .curves import ED25519, EdwardsCurve, WeierstrassCurve
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
from .encodings import ECDSA_RECORD_BYTES as ECDSA_RECORD
from .encodings import ED25519_RECORD_BYTES as ED_RECORD
from .limbs import NLIMB, R_BITS

LADDER_BITS = NLIMB * 12     # 264: every digit bit, as the TPU kernels scan

wei_ladder_launches = 0
wei_ladder_windowed_launches = 0
ed_ladder_launches = 0
ed_ladder_windowed_launches = 0
ed_prologue_launches = 0
ed_epilogue_launches = 0
ecdsa_prologue_launches = 0
ecdsa_epilogue_launches = 0
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


@lru_cache(maxsize=None)
def ed_ends_params() -> np.ndarray:
    """ed_ends.cu's EdEndsParams struct for ed25519 as uint32 words: p,
    2^256 mod p (load_coord's fold), 2^-8 and 2^520 mod p (the one-thread
    Montgomery multiplies at entry and exit take the ladder's 2^264 domain
    to the kernels' plain one and back), -p^-1 mod 2^32, d and sqrt(-1).
    The kernels' field is plain integers mod p (special-form multiply and
    square), so no constant here is in a Montgomery domain; their power
    chains are those of p = 2^255 - 19."""
    p = ED25519.p
    words = (
        _words(p) + _words(_fold_constant(ED25519)) + _words(pow(2, -8, p)) + _words(pow(2, 520, p))
        + [_pinv32(p)]
        + _words(ED25519.d % p) + _words(pow(2, (p - 1) // 4, p))
    )
    return np.array(words, dtype=np.uint32)


@lru_cache(maxsize=None)
def wei_ends_params(curve: WeierstrassCurve) -> np.ndarray:
    """wei_ends.cu's WeiEndsParams struct as uint32 words: p, 2^256 mod p
    (Montgomery 1 and load_coord's fold), 2^248 and 2^264 mod p (the
    ladder's 2^264 domain to the kernels' 2^256 one and back), -p^-1 mod
    2^32, 2^512 mod p (plain values in), a and b in the 2^256 domain, G
    (plain), then the set for the arithmetic mod n: n, -n^-1 mod 2^32,
    2^512 mod n, 2^256 mod n and the inverse's exponent n - 2."""
    p, n, R = curve.p, curve.n, 1 << 256
    if not (1 << 255) < n < R:
        raise ValueError(f"{curve.name}: the ECDSA ends kernels need 2^255 < n < 2^256")
    words = (
        _words(p) + _words(_fold_constant(curve)) + _words(1 << 248) + _words((1 << R_BITS) % p)
        + [_pinv32(p)]
        + _words(R * R % p) + _words(curve.a % p * R % p) + _words(curve.b % p * R % p)
        + _words(curve.gx) + _words(curve.gy)
        + _words(n) + [_pinv32(n)] + _words(R * R % n) + _words(R % n) + _words(n - 2)
    )
    return np.array(words, dtype=np.uint32)


_P, _I = ctypes.c_void_p, ctypes.c_int
# per library: its launch entries {stage: (C entry, argument types)}, its
# params-size entry and its resources entry; every entry returns an int
_ENTRIES = {
    "wei_ladder": ({"ladder": ("corda_wei_ladder", [_I] + [_P] * 8 + [_I, _P])},
                   "corda_wei_params_words", "corda_wei_kernel_info"),
    "ed_ladder": ({"ladder": ("corda_ed_ladder", [_I] + [_P] * 9 + [_I, _P])},
                  "corda_ed_params_words", "corda_ed_kernel_info"),
    "ed_ends": ({"prologue": ("corda_ed_prologue", [_P] * 9 + [_I, _P]),
                 "epilogue": ("corda_ed_epilogue", [_P] * 8 + [_I, _P])},
                "corda_ed_ends_params_words", "corda_ed_ends_kernel_info"),
    "wei_ends": ({"prologue": ("corda_ecdsa_prologue", [_P] * 8 + [_I, _P]),
                  "epilogue": ("corda_ecdsa_epilogue", [_P] * 7 + [_I, _P])},
                 "corda_wei_ends_params_words", "corda_wei_ends_kernel_info"),
}
_SIGNED: set[str] = set()


def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    if name not in _SIGNED:
        launches, words, info = _ENTRIES[name]
        for entry, argtypes in launches.values():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        getattr(lib, words).argtypes = []
        getattr(lib, words).restype = ctypes.c_int
        getattr(lib, info).argtypes = [_I, _P, _P]
        getattr(lib, info).restype = ctypes.c_int
        lib.corda_cuda_error_string.argtypes = [_I]
        lib.corda_cuda_error_string.restype = ctypes.c_char_p
        _SIGNED.add(name)
    return lib


# operand kinds: dtype and shape for a batch of B rows
_DIGITS = (torch.int32, lambda b: (NLIMB, b))
_INTS = (torch.int32, lambda b: (b,))
_BOOLS = (torch.bool, lambda b: (b,))
_ED_RECORDS = (torch.uint8, lambda b: (b, ED_RECORD))
_ECDSA_RECORDS = (torch.uint8, lambda b: (b, ECDSA_RECORD))


def _check_operands(stage: str, operands, batch: int) -> None:
    """operands: (name, tensor, (dtype, shape of a B-row batch)); every
    tensor a contiguous CUDA tensor on the first one's card, of its dtype
    and shape at `batch` rows."""
    first_name, first = operands[0][:2]
    for name, t, (dtype, shape) in operands:
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the CUDA {stage} needs a CUDA tensor")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {first_name} on {first.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, need {dtype}")
        if tuple(t.shape) != shape(batch):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, need {shape(batch)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if batch == 0:
        raise ValueError("empty batch")


def _launch(name: str, stage: str, lead: tuple, params: np.ndarray, batch: int, operands,
            outs):
    """Launch stage `stage` of csrc/<name>.cu on `batch` rows: the C entry
    takes `lead` (ints before the parameters), the parameters, the
    operands' and then the outputs' pointers, the batch and the stream.
    `operands` are checked (_check_operands); `outs` are the kinds of the
    tensors to allocate. Returns the outputs."""
    _check_operands(stage, operands, batch)
    lib = _lib(name)
    launches, words, _ = _ENTRIES[name]
    if getattr(lib, words)() != params.size:
        raise build.KernelBuildError(f"{name}: parameter layout differs between kernel and wrapper")
    dev = operands[0][1].device
    out = [torch.empty(shape(batch), dtype=dtype, device=dev) for dtype, shape in outs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, launches[stage][0])(
            *lead, params.ctypes.data,
            *(t.data_ptr() for _, t, _ in operands), *(t.data_ptr() for t in out),
            batch, stream,
        )
    if rc != 0:
        msg = lib.corda_cuda_error_string(rc).decode()
        raise DeviceFaultError(f"{name} {stage} launch failed: {msg} (cudaError {rc})")
    return tuple(out)


def _counted(kernel: str, dev: torch.device) -> None:
    """One launch of `kernel` on `dev`: its module counter and its card's."""
    counter = kernel + "_launches"
    with _COUNT_LOCK:
        globals()[counter] += 1
        _count_device(kernel, dev)


# kernel -> (library, which): `which` is the windowed flag of a ladder
# library's entry, the stage (0 prologue, 1 epilogue) of an ends library's
_KERNEL_ENTRY = {
    "wei_ladder": ("wei_ladder", 0), "wei_ladder_windowed": ("wei_ladder", 1),
    "ed_ladder": ("ed_ladder", 0), "ed_ladder_windowed": ("ed_ladder", 1),
    "ed_prologue": ("ed_ends", 0), "ed_epilogue": ("ed_ends", 1),
    "ecdsa_prologue": ("wei_ends", 0), "ecdsa_epilogue": ("wei_ends", 1),
}


def kernel_resources(kernel: str, curve: WeierstrassCurve | None = None) -> dict:
    """Registers, stack bytes, static shared bytes and resident warps per
    SM of `kernel` (a `<kernel>_launches` name), from the CUDA runtime on
    the current card. `curve` picks a Weierstrass ladder's instantiation
    (a = 0 or a = -3); the other kernels have one."""
    name, which = _KERNEL_ENTRY[kernel]
    params = None                       # the ends' entries read none
    if name == "wei_ladder":
        params = kernel_params(curve)
    elif name == "ed_ladder":
        params = ed_kernel_params(ED25519)
    lib = _lib(name)
    out = (ctypes.c_int * 4)()
    rc = getattr(lib, _ENTRIES[name][2])(which, None if params is None else params.ctypes.data,
                                         out)
    if rc != 0:
        msg = lib.corda_cuda_error_string(rc).decode()
        raise DeviceFaultError(f"{kernel} kernel attributes: {msg} (cudaError {rc})")
    return dict(zip(("registers", "stack_bytes", "shared_bytes", "warps_per_sm"), out))


_WEI_NAMES = ("u1", "u2", "qx_m", "qy_m")
_ED_NAMES = ("s", "k", "ax_m", "ay_m")


def _ladder(kernel: str, lib: str, params: np.ndarray, names, ins, n_out: int):
    """Launch a ladder of csrc/<lib>.cu on four [22, B] int32 CUDA tensors."""
    batch = ins[0].shape[-1] if ins[0].dim() else 0
    out = _launch(lib, "ladder", (int(kernel.endswith("_windowed")),), params, batch,
                  [(n, t, _DIGITS) for n, t in zip(names, ins)], [_DIGITS] * n_out)
    _counted(kernel, ins[0].device)
    return out


def wei_ladder_cuda(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """Launch the plain-ladder kernel (CUDA tensors only)."""
    return _ladder("wei_ladder", "wei_ladder", kernel_params(curve), _WEI_NAMES,
                   (u1, u2, qx_m, qy_m), 3)


def wei_ladder_windowed_cuda(curve: WeierstrassCurve, u1, u2, qx_m, qy_m):
    """Launch the windowed-ladder kernel (CUDA tensors only)."""
    return _ladder("wei_ladder_windowed", "wei_ladder", kernel_params(curve), _WEI_NAMES,
                   (u1, u2, qx_m, qy_m), 3)


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
    return _ladder("ed_ladder", "ed_ladder", ed_kernel_params(curve), _ED_NAMES,
                   (s, k, ax_m, ay_m), 4)


def ed_ladder_windowed_cuda(curve: EdwardsCurve, s, k, ax_m, ay_m):
    """Launch the windowed Edwards ladder kernel (CUDA tensors only)."""
    return _ladder("ed_ladder_windowed", "ed_ladder", ed_kernel_params(curve), _ED_NAMES,
                   (s, k, ax_m, ay_m), 4)


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


# ---------------------------------------------------------------------------
# the verify programs around the ladders (csrc/ed_ends.cu, csrc/wei_ends.cu);
# their plain versions and dispatching wrappers are in eddsa.py and ecdsa.py


def ed_prologue_cuda(packed, a_sign, valid_in):
    """Launch ed_prologue_kernel on [B, 128] records (CUDA tensors only):
    (s, k, -A.x, A.y, ok), the points in the ladder's 2^264 domain."""
    batch = packed.shape[0] if packed.dim() else 0
    out = _launch("ed_ends", "prologue", (), ed_ends_params(), batch,
                  [("packed", packed, _ED_RECORDS), ("a_sign", a_sign, _INTS),
                   ("valid_in", valid_in, _BOOLS)],
                  [_DIGITS] * 4 + [_BOOLS])
    _counted("ed_prologue", packed.device)
    return out


def ed_epilogue_cuda(R, packed, exp_sign, ok):
    """Launch ed_epilogue_kernel on the ladder's extended R (CUDA tensors
    only): the [B] verdicts."""
    X, Y, Z = R[:3]
    batch = packed.shape[0] if packed.dim() else 0
    (verdict,) = _launch(
        "ed_ends", "epilogue", (), ed_ends_params(), batch,
        [("X", X, _DIGITS), ("Y", Y, _DIGITS), ("Z", Z, _DIGITS),
         ("packed", packed, _ED_RECORDS), ("exp_sign", exp_sign, _INTS),
         ("ok", ok, _BOOLS)],
        [_BOOLS])
    _counted("ed_epilogue", packed.device)
    return verdict


def ecdsa_prologue_cuda(curve: WeierstrassCurve, packed, valid_in):
    """Launch ecdsa_prologue_kernel on [B, 160] records (CUDA tensors
    only): (u1, u2, qx_m, qy_m, valid), Q in the ladder's 2^264 domain."""
    batch = packed.shape[0] if packed.dim() else 0
    out = _launch("wei_ends", "prologue", (), wei_ends_params(curve), batch,
                  [("packed", packed, _ECDSA_RECORDS), ("valid_in", valid_in, _BOOLS)],
                  [_DIGITS] * 4 + [_BOOLS])
    _counted("ecdsa_prologue", packed.device)
    return out


def ecdsa_epilogue_cuda(curve: WeierstrassCurve, R, packed, valid):
    """Launch ecdsa_epilogue_kernel on the ladder's projective R (CUDA
    tensors only): the [B] verdicts."""
    X, Y, Z = R
    batch = packed.shape[0] if packed.dim() else 0
    (verdict,) = _launch(
        "wei_ends", "epilogue", (), wei_ends_params(curve), batch,
        [("X", X, _DIGITS), ("Y", Y, _DIGITS), ("Z", Z, _DIGITS),
         ("packed", packed, _ECDSA_RECORDS), ("valid", valid, _BOOLS)],
        [_BOOLS])
    _counted("ecdsa_epilogue", packed.device)
    return verdict
