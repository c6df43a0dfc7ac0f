"""The kernel store (crypto/aot_store.py, crypto/build.py) against a
stand-in compiler.

The port's counterpart of tests/test_aot_store.py's four cases: a
library round-trips through the store and is reused; a corrupt one is
deleted and rebuilt once, and raises if the rebuild does not load
either; the key moves with the source, a header, the flags and nvcc's
version (and the store's directory with its variable); the kill switch
builds into a private directory and reuses nothing. There is no nvcc
here, so `nvcc` is a stand-in in a temporary CUDA_HOME: it answers
`--version` with the release it was installed as, counts its compiles and builds a
real shared library from a stub C source with the host's C compiler.
No plain version runs in its place: without a compiler the kernels
raise KernelBuildError. The prewarm runs on CPU devices here and on the
card in chip_smoke.py phase 19.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from corda_tpu_torch.crypto import aot_store, build, cuda_ec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

STAND_IN = '''#!{python}
"""nvcc stand-in: --version prints its release; -o OUT SRC builds a stub."""
import os, subprocess, sys
here = os.path.dirname(os.path.abspath(__file__))
args = sys.argv[1:]
if args == ["--version"]:
    print("stand-in nvcc, release {release}")
    sys.exit(0)
with open(os.path.join(here, "compiles.log"), "a") as f:
    f.write(args[-1] + "\\n")
out = args[args.index("-o") + 1]
if os.path.exists(os.path.join(here, "garbage")):
    open(out, "wb").write(b"not a shared library")
    sys.exit(0)
stub = out + ".c"
open(stub, "w").write("int corda_stand_in(void) {{ return 18; }}\\n")
rc = subprocess.call(["cc", "-shared", "-fPIC", "-o", out, stub])
os.unlink(stub)
print("ptxas info    : Used 10 registers")
sys.exit(rc)
'''


class StandIn:
    def __init__(self, root: Path):
        self.bin = root / "bin"
        self.bin.mkdir(parents=True)
        self.release("12.8")

    def release(self, text: str) -> None:
        """Install the stand-in of this release (another binary)."""
        nvcc = self.bin / "nvcc"
        nvcc.write_text(STAND_IN.format(python=sys.executable, release=text))
        nvcc.chmod(0o755)

    def compiles(self) -> int:
        log = self.bin / "compiles.log"
        return len(log.read_text().splitlines()) if log.exists() else 0

    def emit_garbage(self, on: bool) -> None:
        flag = self.bin / "garbage"
        if on:
            flag.write_text("1")
        elif flag.exists():
            flag.unlink()


@pytest.fixture
def store(tmp_path, monkeypatch):
    """The store in tmp_path/store, nvcc the stand-in; no library loaded."""
    cc = StandIn(tmp_path / "cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv(aot_store.ENV_DIR, str(tmp_path / "store"))
    monkeypatch.delenv(aot_store.ENV_SWITCH, raising=False)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(aot_store, "_private", None)
    return tmp_path / "store", cc


def _libs(d: Path) -> list:
    return sorted(p.name for p in d.glob("*.so"))


def test_library_roundtrip_and_reuse(store):
    """The first build fills the store with one library per source and
    loads it; a fresh process (an emptied table) reuses the libraries
    without compiling; prewarm reports them reused and verifies one
    valid and one tampered row per scheme (on CPU devices here)."""
    d, cc = store
    libs = build.build_all()
    assert sorted(libs) == ["ed_ladder", "wei_ladder"] and cc.compiles() == 2
    assert all(p.parent == d and p.exists() for p in libs.values())
    assert build.load("wei_ladder").corda_stand_in() == 18
    assert build.ptxas_report("wei_ladder").startswith("ptxas info")
    build._LIBS.clear()
    assert build.build_all() == libs and build.load("ed_ladder").corda_stand_in() == 18
    assert cc.compiles() == 2 and len(_libs(d)) == 2       # reused, not rebuilt
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        warm = aot_store.prewarm(batch=4, device="cpu")
    finally:
        torch.set_num_threads(saved)
    assert warm["libraries"] == {"ed_ladder": "reused", "wei_ladder": "reused"}
    assert sorted(warm["seconds"]) == ["ed25519", "k1", "p256"] and warm["store"] == str(d)
    assert cc.compiles() == 2


def test_corrupt_library_is_deleted_and_rebuilt(store):
    d, cc = store
    path = build.build_all(["wei_ladder"])["wei_ladder"]
    path.write_bytes(b"garbage, not a shared library")
    assert build.load("wei_ladder").corda_stand_in() == 18      # deleted, rebuilt, loaded
    assert cc.compiles() == 2 and path.read_bytes()[:4] == b"\x7fELF"
    build._LIBS.clear()
    cc.release("12.9")          # a new key: a library this process never loaded
    cc.emit_garbage(True)       # the build and the rebuild write no shared library
    with pytest.raises(build.KernelBuildError, match="does not load"):
        build.load("wei_ladder")
    assert cc.compiles() == 4 and "wei_ladder" not in build._LIBS
    with pytest.raises(build.KernelBuildError):      # the kernel's wrapper: no plain path
        cuda_ec._lib("wei_ladder")


def test_key_tracks_source_headers_flags_and_nvcc(store, tmp_path, monkeypatch):
    d, cc = store
    src = tmp_path / "src"
    src.mkdir()
    for name in ("a.cu", "field.cuh"):
        (src / name).write_text(f"// {name}\n")
    first = build.library_path(src / "a.cu")
    assert first.parent == d and first.name.startswith("liba-")
    seen = {first}

    def moved():
        path = build.library_path(src / "a.cu")
        assert path not in seen
        seen.add(path)

    (src / "a.cu").write_text("// edited\n")
    moved()
    (src / "field.cuh").write_text("// edited header\n")
    moved()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    moved()
    cc.release("12.9")                      # another toolkit, the same sources
    moved()
    assert build.library_path(src / "a.cu") in seen            # stable when nothing moves
    monkeypatch.setenv(aot_store.ENV_DIR, str(tmp_path / "elsewhere"))
    assert build.library_path(src / "a.cu").parent == tmp_path / "elsewhere"
    monkeypatch.delenv(aot_store.ENV_DIR)
    assert aot_store.store_dir() == aot_store.DEFAULT_DIR == ROOT / "build" / "corda_tpu_torch"


def test_kill_switch(store, monkeypatch):
    """CORDA_TPU_TORCH_KERNEL_STORE=0: the libraries build into this
    process's private directory, though the store holds them; the store
    is untouched; without a compiler the build raises, as with the
    store on."""
    d, cc = store
    build.build_all()
    before = _libs(d)
    monkeypatch.setenv(aot_store.ENV_SWITCH, "0")
    assert not aot_store.enabled()
    private = aot_store.store_dir()
    assert private != d and private.is_dir() and aot_store.store_dir() == private
    libs = build.build_all()
    assert cc.compiles() == 4 and all(p.parent == private for p in libs.values())
    assert build.load("ed_ladder").corda_stand_in() == 18
    assert _libs(d) == before
    build._LIBS.clear()
    monkeypatch.setattr(aot_store, "_private", None)
    monkeypatch.setenv("CUDA_HOME", str(d / "no-toolkit"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load("wei_ladder")


def test_prewarm_cli_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the prewarm would run")
    r = subprocess.run([sys.executable, "-m", "corda_tpu_torch.crypto.aot_store", "--batch", "8"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "is false" in r.stderr and "prewarmed" not in r.stdout
