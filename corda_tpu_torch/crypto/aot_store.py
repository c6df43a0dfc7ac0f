"""The kernel store: where the nvcc-built ladder libraries live, and
the prewarm that fills it.

Counterpart of corda_tpu/crypto/aot_store.py, and of
utils/jaxenv.py's enable_compile_cache: there a process reuses the
exported and compiled XLA ladder programs of an earlier one; here it
reuses the shared libraries that crypto/build.py compiled with nvcc.
A library's name is its key (build.library_path): the source, every
`csrc/*.cuh`, the nvcc flags and `nvcc --version`, so an edited kernel
or another toolkit never loads a stale library, and a store may outlive
the checkout that filled it. Computing the key runs nvcc, so reusing a
store needs the CUDA toolkit on the host as building it does: where no
nvcc is found even a filled store raises KernelBuildError.

- `store_dir()`: $CORDA_TPU_TORCH_KERNEL_DIR, by default the
  git-ignored `build/corda_tpu_torch/` beside the package.
- CORDA_TPU_TORCH_KERNEL_STORE=0 turns the store off: each process
  builds into a private temporary directory and reuses nothing. There
  is no plain-version path on the card either way: a failed build
  raises KernelBuildError.
- A library that does not load (truncated, corrupt) is deleted and
  rebuilt once by build.load; if it still does not load, that raises
  KernelBuildError.
- `prewarm` builds every library and verifies one valid and one
  tampered row per scheme on the card:

      python -m corda_tpu_torch.crypto.aot_store --batch 4096 [--schemes p256,k1,ed25519]

  It exits non-zero without a card.
"""

from __future__ import annotations

import atexit
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ENV_DIR = "CORDA_TPU_TORCH_KERNEL_DIR"
ENV_SWITCH = "CORDA_TPU_TORCH_KERNEL_STORE"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "corda_tpu_torch"

_private: Optional[Path] = None


def enabled() -> bool:
    return os.environ.get(ENV_SWITCH, "1") != "0"


def store_dir() -> Path:
    """Where libraries are built and looked up: the store, or with the
    store off this process's private directory (removed at exit)."""
    global _private
    if enabled():
        return Path(os.environ.get(ENV_DIR) or DEFAULT_DIR)
    if _private is None or not _private.is_dir():
        _private = Path(tempfile.mkdtemp(prefix="corda_tpu_torch_kernels-"))
        atexit.register(shutil.rmtree, _private, True)
    return _private


def prewarm(batch: int = 4096, schemes_arg: Optional[str] = None, device="cuda") -> dict:
    """Build (or reuse) every kernel library, load it, and verify one
    valid and one tampered row per scheme at `batch` on `device` (the
    verifier pads to it). Returns {"libraries": {stem: "built" or
    "reused"}, "seconds": {scheme: s}, "store": the directory}; raises
    where there is no card, a build fails or a verdict is wrong."""
    import random

    from . import build, schemes
    from .batch_verifier import CudaBatchVerifier, VerificationRequest

    wanted = {
        "p256": schemes.ECDSA_SECP256R1_SHA256,
        "k1": schemes.ECDSA_SECP256K1_SHA256,
        "ed25519": schemes.EDDSA_ED25519_SHA512,
    }
    names = [s.strip() for s in schemes_arg.split(",")] if schemes_arg else list(wanted)
    unknown = [n for n in names if n not in wanted]
    if unknown:
        raise ValueError(f"unknown schemes {unknown}; choose from {list(wanted)}")
    verifier = CudaBatchVerifier(batch_sizes=(batch,), device=device)
    t0 = time.perf_counter()
    had = {s.stem: build.library_path(s).exists() for s in build.sources()}
    libs = build.build_all()
    for stem in libs:
        build.load(stem)
    libraries = {stem: "reused" if had[stem] else "built" for stem in libs}
    print(f"kernel store {store_dir()}: "
          f"{', '.join(f'{k} {v}' for k, v in libraries.items())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = random.Random(5)
    seconds = {}
    for name in names:
        kp = schemes.generate_keypair(wanted[name], seed=7)
        msg = rng.randbytes(48)
        sig = kp.private.sign(msg)
        reqs = [VerificationRequest(kp.public, sig, msg),
                VerificationRequest(kp.public, sig, msg + b"!")]
        t = time.perf_counter()
        got = verifier.verify_batch(reqs)
        seconds[name] = time.perf_counter() - t
        if got != [True, False]:
            raise RuntimeError(f"prewarm {name}@{batch}: verdicts {got}, want [True, False]")
        print(f"prewarmed {name}@{batch}: {seconds[name]:.1f}s", flush=True)
    return {"libraries": libraries, "seconds": seconds, "store": str(store_dir())}


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(prog="corda_tpu_torch.crypto.aot_store",
                                description="Fill the kernel store and verify on the card.")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--schemes", default=None, help="comma list: p256,k1,ed25519")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("aot_store: torch.cuda.is_available() is false: the kernel store is "
              "prewarmed on the card", file=sys.stderr)
        return 2
    prewarm(args.batch, args.schemes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
