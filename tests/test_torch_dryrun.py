"""parallel/dryrun.py against __graft_entry__.py: the flagship step and
the several-device dry run.

- `entry`: the packed staging (`encodings.stage_ecdsa_packed`) equals
  the reference's on the same signed rows, malformed ones included, and
  the step (`ecdsa_verify_packed`) accepts the 8 staged rows; the
  reference's own step (its XLA ladder) runs beside it in a slow case.
- `dryrun_multigpu(4, device="cpu")` at a small serving size and a
  small notary fixture: every pass's answers held against
  CpuBatchVerifier and the labels inside, each CPU device's ledger row
  carrying its pinned verifiers' dispatches.
- D12: without the cards it was asked for it raises, function and
  command, where the reference's dryrun_multichip falls back to virtual
  CPU devices.
"""

from __future__ import annotations

import random
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import corda_tpu.crypto.encodings as renc  # noqa: E402
from corda_tpu.crypto.curves import SECP256R1 as R_P256  # noqa: E402
from corda_tpu_torch.crypto import encodings as penc  # noqa: E402
from corda_tpu_torch.crypto import schemes  # noqa: E402
from corda_tpu_torch.crypto.curves import SECP256R1 as P_P256  # noqa: E402
from corda_tpu_torch.parallel import dryrun  # noqa: E402

from test_torch_notary import one_torch_thread  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SMALL_FIXTURE = dict(outputs_per_issue=2, bad_every=8, wrong_notary_every=16,
                     owners_per_scheme=4, workers=1)


def _items():
    """Signed p256 rows, then a tampered message, a bad DER signature, a
    bad point, r = 0 and an empty row."""
    rng = random.Random(7)
    items = []
    for _ in range(4):
        kp = schemes.generate_keypair(schemes.ECDSA_SECP256R1_SHA256, seed=rng.getrandbits(64))
        msg = rng.randbytes(32)
        items.append((kp.public.data, kp.private.sign(msg), msg))
    pub, sig, msg = items[0]
    items += [(pub, sig, msg + b"!"), (pub, sig[:-1], msg), (b"\x04" + b"\x01" * 64, sig, msg),
              (pub, penc.encode_der_ecdsa(0, 5), msg), (b"", b"", b"")]
    return items


def test_entry_staging_equals_the_references():
    items = _items()
    got = penc.stage_ecdsa_packed(P_P256, items, 12)
    want = renc.stage_ecdsa_packed(R_P256, items, 12)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    # the packed staging leaves the point and range checks to the device
    assert got[1].tolist() == [True] * 5 + [False] + [True] * 2 + [False] * 4
    fn, args = dryrun.entry("cpu")
    rows = (torch.from_numpy(got[0].copy()), torch.from_numpy(got[1]))
    assert fn(*rows).tolist() == [True] * 4 + [False] * 8
    assert [tuple(a.shape) for a in args] == [(8, 160), (8,)]
    assert fn(*args).tolist() == [True] * 8


@pytest.mark.slow
def test_entry_equals_the_references_step():
    """The reference's flagship step (its XLA ladder) and the port's on
    their own staged rows: every row accepted by both."""
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as graft

    rfn, rargs = graft.entry()
    fn, args = dryrun.entry("cpu")
    assert np.asarray(rfn(*rargs)).tolist() == fn(*args).tolist() == [True] * 8


def test_dryrun_on_four_cpu_devices(capsys):
    """Every pass on 4 CPU devices: the tiny pass over the 1-D and the
    2 x 2 mesh, an 8-row serving pass with its layout, the per-shard pass
    with every verifier pinned, the 4-shard notary flush; each device's
    ledger row holds its per-shard and notary dispatches."""
    out = dryrun.dryrun_multigpu(4, device="cpu", serving=8, notary_spends=8,
                                 fixture=SMALL_FIXTURE)
    assert set(out["walls"]) == {"tiny", "serving", "per_shard", "notary"}
    rows = out["ledger"]
    assert set(rows) == {-1, 0, 1, 2, 3}
    assert rows[-1]["requests"] == 8 + 8 + 8        # tiny, 2-D, serving: every real row
    # the per-shard pass's 2 rows on each device, then the notary's rows
    assert all(rows[k]["dispatches"] >= 1 and rows[k]["requests"] >= 2 for k in range(4))
    assert sum(rows[k]["requests"] for k in range(4)) > 8
    text = capsys.readouterr().out
    for line in ("dryrun_multigpu ok: 4 devices, batch 8",
                 "serving shard layout: packed chunk (8, 160) -> 4 shards of (2, 160)",
                 "serving pass ok: chunk 8 x 1 over 4 devices",
                 "sharded dispatch ok: 4 per-shard batches on 4 devices (4 device-pinned), "
                 "8 rows bit-exact vs CPU",
                 "notary pass ok: 8 spends over 4 shards on 4 devices",
                 "equal to their labels"):
        assert line in text, line


def test_dryrun_refuses_without_cards(monkeypatch):
    """D12: no fallback to CPU devices, where the reference's
    _provision_devices makes a virtual CPU mesh."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multigpu(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.entry()
    r = subprocess.run([sys.executable, "-m", "corda_tpu_torch.parallel.dryrun", "4"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "is false" in r.stderr and "ok" not in r.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="need 4 cards, 2 visible"):
        dryrun.devices_for(4)
    assert [str(d) for d in dryrun.devices_for(2)] == ["cuda:0", "cuda:1"]
    assert [str(d) for d in dryrun.devices_for(3, "cpu")] == ["cpu:0", "cpu:1", "cpu:2"]
