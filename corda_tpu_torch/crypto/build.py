"""Build the port's CUDA sources with nvcc at first use.

Each `csrc/*.cu` compiles on its own (one nvcc process per source, all
started together) into a shared library with a plain C interface under
`build/corda_tpu_torch/` beside the package, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/corda_tpu_torch/lib<name>-<hash>.so

The library name carries a hash of the source, of every shared header
(`csrc/*.cuh`) and of the flags, so an edited source or header rebuilds
and an unchanged one is reused. ptxas's report
(registers, spills, shared memory per kernel) is kept beside each
library as `<lib>.log`. A missing nvcc or a failed compile raises
KernelBuildError: there is no fallback to the torch path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "corda_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 900

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of corda_tpu_torch build only where the CUDA toolkit is"
    )


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(src: Path) -> Path:
    """Content-addressed library path of one source: keyed on the source,
    every header in its directory and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all) that have no library yet,
    in parallel. Returns {stem: library path}."""
    srcs = [s for s in sources() if names is None or s.stem in names]
    missing = set(names or ()) - {s.stem for s in srcs}
    if missing:
        raise KernelBuildError(f"no CUDA source for {sorted(missing)} in {CSRC_DIR}")
    out = {s.stem: library_path(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in todo:
        tmp = out[s.stem].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for s, tmp, proc in procs:
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {BUILD_TIMEOUT_S} s"
        if proc.returncode != 0:
            errors.append(f"{s.name}:\n{log[-4000:]}")
            continue
        lib = out[s.stem]
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _LIBS[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """ptxas -v output of the last build of csrc/<name>.cu ('' if none)."""
    log = library_path(CSRC_DIR / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""
