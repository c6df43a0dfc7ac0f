"""Rehearsals of chip_smoke.py's phase 19 (a mesh of four slices on the one card,
per-shard verifiers behind a 4-shard notary flush, the mesh-and-device
refusal, the prewarm reusing phase 2's libraries) on the CPU, and its
checks fed wrong answers."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from corda_tpu_torch.crypto import aot_store, build  # noqa: E402
from corda_tpu_torch.crypto import batch_verifier as pbv  # noqa: E402
from corda_tpu_torch.parallel import dryrun  # noqa: E402

from test_torch_aot_store import StandIn  # noqa: E402
from test_torch_notary import one_torch_thread  # noqa: E402,F401  (autouse)

SMALL_FIXTURE = dict(outputs_per_issue=2, bad_every=8, wrong_notary_every=16,
                     owners_per_scheme=4, workers=1)


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Phase 19 at the rehearsal's size, its kernel store filled by a
    stand-in nvcc as phase 2 would fill it."""
    StandIn(tmp_path / "cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv(aot_store.ENV_DIR, str(tmp_path / "store"))
    monkeypatch.delenv(aot_store.ENV_SWITCH, raising=False)
    monkeypatch.setattr(build, "_LIBS", {})
    build.build_all()
    for name, value in (("SHARDS_MESH_ROWS", 6), ("SHARDS_SPENDS", 32), ("DISTINCT", 24),
                        ("SHARDS_SAMPLE", 8), ("CHUNK", 4), ("NOTARY_FIXTURE", SMALL_FIXTURE)):
        monkeypatch.setattr(cs, name, value)


def test_shards_phase_rehearsed_on_the_cpu(small, capsys):
    """chip_smoke.phase_shards on the CPU: 19a's mesh rows equal the CPU
    reference's, 19b's per-shard flush answers every spend as its label
    with each shard's verifier dispatching, 19c refuses, 19d reuses the
    store; and the phase's last check, that the kernels launched,
    refuses a run in which none did."""
    with pytest.raises(RuntimeError, match="ed_ladder was not launched over the mesh"):
        cs.phase_shards(torch.device("cpu"), "cpu rehearsal")
    out = capsys.readouterr().out
    for line in ("mesh (19a): 6 mixed rows over Mesh({'batch': 4}, ['cpu', 'cpu', 'cpu', 'cpu'])",
                 "every row the CPU reference's",
                 "per-shard notary (19b): 32 spends over 4 shards, "
                 "per_shard_verifiers(devices=[cpu]) (cpu/cpu/cpu/cpu)",
                 "every answer its label",
                 "refusal (19c): CudaBatchVerifier(mesh=..., device=...) raised ValueError",
                 'prewarm (19d): {"ed_ends": "reused", "ed_ladder": "reused", '
                 '"wei_ends": "reused", "wei_ladder": "reused"}'):
        assert line in out, line


def _stub_parts(m, dispatching: int) -> None:
    """Phase 19's drives stubbed; `dispatching` of the four shard
    verifiers record a call."""
    def notary_pass(fx, verifiers, shards):
        for v in verifiers[:dispatching]:
            v.calls.append(([], None))
        return {"service": None, "answers": [], "wall_s": 1.0}

    m.setattr(cs, "spi_corpus", lambda: lambda sids, rows: ([], []))
    m.setattr(cs, "_flush", lambda *a: None)
    m.setattr(cs, "_check_notary", lambda *a: {"rows": 0, "device_s": 0.0})
    m.setattr(dryrun, "notary_pass", notary_pass)
    m.setattr("corda_tpu_torch.testing.notary_fixture.build_fixture", lambda n, **kw: None)


class _Lenient(pbv.CudaBatchVerifier):
    """Takes mesh= with device=, dropping the device."""

    def __init__(self, *args, device=None, mesh=None, **kw):
        super().__init__(*args, device=None if mesh is not None else device, mesh=mesh, **kw)


def test_shards_checks_refuse_wrong_answers(monkeypatch):
    """19b refuses a shard whose verifier never dispatched, 19c a
    verifier that takes mesh= with device=, 19d a prewarm that rebuilt."""
    cpu = torch.device("cpu")
    with monkeypatch.context() as m:
        _stub_parts(m, 3)
        with pytest.raises(RuntimeError, match=r"the verifiers of shards \[3\] never dispatched"):
            cs.phase_shards(cpu, "cpu rehearsal")
    with monkeypatch.context() as m:
        _stub_parts(m, 4)
        m.setattr(pbv, "CudaBatchVerifier", _Lenient)
        with pytest.raises(RuntimeError, match=r"refusal \(19c\): CudaBatchVerifier took mesh="):
            cs.phase_shards(cpu, "cpu rehearsal")
    with monkeypatch.context() as m:
        _stub_parts(m, 4)
        m.setattr(aot_store, "prewarm", lambda batch, device=None: {
            "libraries": {"ed_ladder": "built", "wei_ladder": "reused"}, "seconds": {},
            "store": ""})
        with pytest.raises(RuntimeError, match=r"prewarm \(19d\) rebuilt \['ed_ladder'\]"):
            cs.phase_shards(cpu, "cpu rehearsal")
