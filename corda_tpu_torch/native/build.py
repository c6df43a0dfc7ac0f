"""Build the port's native host library (native/cts_hash.cpp) with g++.

    g++ -O3 -shared -fPIC -std=c++17 -I<CPython include> cts_hash.cpp
        -o build/corda_tpu_torch/_cts_hash-<hash><EXT_SUFFIX>

The library is a CPython extension (the C API only, no third-party build
dependency). It builds at first use into the git-ignored
`build/corda_tpu_torch/` beside the package; the file name carries a hash
of the source, the flags, the include directory and the interpreter's
extension suffix, so an edited source rebuilds and an unchanged one is
reused. Concurrent first builds (several test workers, several
processes) serialise on a file lock and each writes to a temporary name
that `os.replace` publishes whole. A missing compiler, missing
`Python.h` or a failed compile raises NativeBuildError: there is no
fall-back to the Python paths.

    python -m corda_tpu_torch.native.build     # build, print path and compiler
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sysconfig
import time
from dataclasses import dataclass
from pathlib import Path

SOURCE = Path(__file__).resolve().with_name("cts_hash.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "corda_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 600


class NativeBuildError(RuntimeError):
    """g++ or the CPython headers are missing, or the compile failed."""


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    compiler: str       # first line of `g++ --version`
    seconds: float      # 0.0 when an earlier build was reused
    built: bool


def _include_dir() -> str:
    inc = sysconfig.get_paths()["include"]
    if not os.path.isfile(os.path.join(inc, "Python.h")):
        raise NativeBuildError(
            f"Python.h not found in {inc}: the CPython development headers "
            "are needed to build corda_tpu_torch's native library"
        )
    return inc


def compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(
            "g++ not found on PATH: corda_tpu_torch's native library builds "
            "with g++ at first use"
        )
    return cxx


def library_path(source: Path = SOURCE) -> Path:
    """Content-addressed path of the library for this interpreter."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(sysconfig.get_paths()["include"].encode() + suffix.encode())
    return BUILD_DIR / f"_cts_hash-{h.hexdigest()[:16]}{suffix}"


def _version(cxx: str) -> str:
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    return (out.stdout.splitlines() or [cxx])[0].strip()


def build(source: Path = SOURCE) -> BuildInfo:
    """The library's path, compiled first if no build of this source
    exists yet. `source` defaults to native/cts_hash.cpp (the tests also
    build the reference package's copy with it, to hold the two equal)."""
    cxx = compiler()
    inc = _include_dir()
    out = library_path(source)
    if out.exists():
        return BuildInfo(out, _version(cxx), 0.0, False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "_cts_hash.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():   # another process built it while we waited
            return BuildInfo(out, _version(cxx), 0.0, False)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [cxx, *CXX_FLAGS, f"-I{inc}", str(source), "-o", str(tmp)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise NativeBuildError(f"g++ timed out after {BUILD_TIMEOUT_S} s") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"g++ failed ({' '.join(cmd)}):\n{(proc.stdout + proc.stderr)[-4000:]}"
            )
        os.replace(tmp, out)
        return BuildInfo(out, _version(cxx), time.perf_counter() - t0, True)


if __name__ == "__main__":
    info = build()
    print(f"{info.path} ({info.compiler}; "
          + (f"built in {info.seconds:.1f} s)" if info.built else "reused)"))
