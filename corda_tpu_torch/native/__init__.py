"""The port's native host library: the CTS codec, SHA-256, Merkle trees
and proofs, the signature staging sweeps and the asset-contract sweep in
C++ (native/cts_hash.cpp, the port's own copy of the reference's).

`get()` returns the loaded module, building it with g++ at first use
(native/build.py). The notary's main path runs on it: a failed build
raises NativeBuildError, and nothing falls back to Python. The Python
implementations stay importable under their own names (`encode_py`,
`merkle_root_py`, `stage_ecdsa_packed_py`, ...) as the differential
reference the tests hold this library against.
"""

from __future__ import annotations

import importlib.util
import threading

from . import build as _build
from .build import NativeBuildError

__all__ = ["NativeBuildError", "get", "build_info"]

MODULE_NAME = "corda_tpu_torch.native._cts_hash"

_MOD = None
_INFO = None
_LOCK = threading.Lock()


def get():
    """The native module, built and loaded on first call (cached)."""
    global _MOD, _INFO
    if _MOD is not None:
        return _MOD
    with _LOCK:
        if _MOD is None:
            info = _build.build()
            # default dlopen flags (RTLD_LOCAL): the reference package's
            # library of the same init name may be loaded alongside
            spec = importlib.util.spec_from_file_location(MODULE_NAME, info.path)
            if spec is None or spec.loader is None:
                raise NativeBuildError(f"cannot load {info.path} as an extension")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if getattr(mod, "cts_abi", 0) != 2:
                raise NativeBuildError(
                    f"{info.path}: codec ABI {getattr(mod, 'cts_abi', 0)}, expected 2"
                )
            _INFO = info
            _MOD = mod
    return _MOD


def build_info():
    """The BuildInfo of the loaded library (after `get()`)."""
    get()
    return _INFO
