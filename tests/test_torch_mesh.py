"""The port's mesh path (parallel/mesh.py, CudaBatchVerifier(mesh=)) and
per-shard verifiers, held against the reference's on the same seeded
requests.

- Every case of tests/test_mesh_verifier.py on a mesh of 8 CPU devices
  (`torch.device("cpu", k)`), with the reference's slow marks: answers
  equal to the reference's CpuBatchVerifier row for row; the 2-D mesh;
  the serving layout's contiguous per-device slices equal, byte for
  byte, to the reference's shard_operand on its 8 virtual CPU devices.
  The comparisons with the reference's own TpuBatchVerifier(mesh=)
  compile its XLA ladders and are marked slow.
- The split as the verifier issues it: one contiguous slice per device
  in mesh order, slices of padding only not launched, the ledger key -1,
  a fault naming its device, and the refusals (device= with mesh=, a
  batch that does not split, no card).
- per_shard_verifiers pins as the reference's does.
"""

from __future__ import annotations

import random

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import corda_tpu.crypto.batch_verifier as rbv  # noqa: E402
import corda_tpu.crypto.encodings as renc  # noqa: E402
import corda_tpu.parallel.mesh as rmesh  # noqa: E402
import corda_tpu_torch.crypto.batch_verifier as pbv  # noqa: E402
import corda_tpu_torch.parallel.mesh as pmesh  # noqa: E402
import tests.test_mesh_verifier as ref  # noqa: E402
from corda_tpu.crypto import schemes as rschemes  # noqa: E402
from corda_tpu.crypto.curves import SECP256R1 as R_P256  # noqa: E402
from corda_tpu_torch import convert  # noqa: E402
from corda_tpu_torch.crypto import encodings as penc  # noqa: E402
from corda_tpu_torch.crypto.cuda_ec import DeviceFaultError  # noqa: E402
from corda_tpu_torch.crypto.curves import SECP256R1 as P_P256  # noqa: E402
from corda_tpu_torch.utils import device_telemetry as dlib  # noqa: E402

from test_torch_notary import one_torch_thread  # noqa: E402,F401  (autouse)

DEVICES = [torch.device("cpu", k) for k in range(8)]
P256, K1, ED = ref.MESH_SCHEMES


@pytest.fixture(scope="module")
def mesh():
    return pmesh.make_mesh(DEVICES)


def _port(reqs):
    return convert.requests_from_reference(reqs)


def _mixed(rng):
    """test_mesh_mixed_schemes_and_cpu_fallback's batch: 5 rows of each
    kernel scheme and an RSA row (the host), shuffled."""
    reqs = []
    for sid in ref.MESH_SCHEMES:
        reqs.extend(ref._requests(sid, rng, 5))
    kp = rschemes.generate_keypair(rschemes.RSA_SHA256)
    msg = b"rsa row"
    reqs.insert(4, rbv.VerificationRequest(kp.public, kp.private.sign(msg), msg))
    rng.shuffle(reqs)
    return reqs


def test_make_mesh_shapes():
    jdev = jax.devices()[:8]
    for port, refm in ((pmesh.make_mesh(DEVICES), rmesh.make_mesh(jdev)),
                       (pmesh.make_mesh_2d(2, 4, DEVICES), rmesh.make_mesh_2d(2, 4, jdev))):
        assert port.devices.shape == refm.devices.shape
        assert port.axis_names == tuple(refm.axis_names)
        assert pmesh.batch_spec_axes(port) == rmesh.batch_spec_axes(refm)
        assert [d.index for d in port.devices.flat] == [d.id for d in refm.devices.flat]
    assert pmesh.make_mesh(DEVICES).devices.shape == (8,)
    assert pmesh.make_mesh(DEVICES).axis_names == (pmesh.BATCH_AXIS,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_mesh()


@pytest.mark.parametrize(
    "scheme_id",
    [P256, pytest.param(K1, marks=pytest.mark.slow), pytest.param(ED, marks=pytest.mark.slow)],
)
def test_mesh_matches_cpu_single_scheme(mesh, scheme_id):
    reqs = ref._requests(scheme_id, random.Random(scheme_id), 9)   # pads 9 -> 16
    got = pbv.CudaBatchVerifier(batch_sizes=(16,), mesh=mesh).verify_batch(_port(reqs))
    assert got == rbv.CpuBatchVerifier().verify_batch(reqs)
    assert True in got and False in got


def test_mesh_mixed_schemes_and_cpu_fallback(mesh):
    reqs = _mixed(random.Random(99))
    got = pbv.CudaBatchVerifier(batch_sizes=(16,), mesh=mesh).verify_batch(_port(reqs))
    assert got == rbv.CpuBatchVerifier().verify_batch(reqs)


@pytest.mark.slow
def test_mesh_chunking_over_largest_batch(mesh):
    reqs = ref._requests(P256, random.Random(7), 24)
    got = pbv.CudaBatchVerifier(batch_sizes=(16,), mesh=mesh).verify_batch(_port(reqs))
    assert got == rbv.CpuBatchVerifier().verify_batch(reqs)


@pytest.mark.slow
def test_mesh_2d_dcn_ici_matches_cpu():
    mesh2 = pmesh.make_mesh_2d(2, 4, DEVICES)
    assert mesh2.devices.shape == (2, 4)
    assert mesh2.axis_names == (pmesh.DCN_AXIS, pmesh.ICI_AXIS)
    for scheme_id in ref.MESH_SCHEMES:
        reqs = ref._requests(scheme_id, random.Random(scheme_id + 77), 13)   # pads 13 -> 16
        got = pbv.CudaBatchVerifier(batch_sizes=(16,), mesh=mesh2).verify_batch(_port(reqs))
        assert got == rbv.CpuBatchVerifier().verify_batch(reqs)
        assert True in got and False in got


def test_mesh_2d_p256_matches_cpu():
    """The 2-D mesh at one scheme (the case above is slow, as the
    reference's): 5 rows padded to 16 over 2 x 4 devices."""
    reqs = ref._requests(P256, random.Random(P256 + 77), 5)
    got = pbv.CudaBatchVerifier(batch_sizes=(16,), mesh=pmesh.make_mesh_2d(2, 4, DEVICES)
                                ).verify_batch(_port(reqs))
    assert got == rbv.CpuBatchVerifier().verify_batch(reqs)
    assert True in got and False in got


def test_mesh_2d_wrong_device_count_raises():
    with pytest.raises(ValueError, match="needs 8 devices"):
        pmesh.make_mesh_2d(2, 4, DEVICES[:4])


def test_serving_shard_layout_pinned(mesh):
    """The serving layout: the staged [B, 160] records and [B] mask split
    into B/8 contiguous rows per device in mesh order, and each device's
    slice is byte-equal to the reference's shard on the same mesh
    position; the spec-level shard_shape answers the placed shape."""
    rng = random.Random(5)
    n = 64
    reqs = ref._requests(P256, rng, 8)
    items = ([(r.key.data, r.signature, r.message) for r in reqs] * 8)[:n]
    packed, valid = penc.stage_ecdsa_packed(P_P256, items, n)
    r_packed, r_valid = renc.stage_ecdsa_packed(R_P256, items, n)
    assert np.array_equal(packed, r_packed) and np.array_equal(valid, r_valid)

    rm = rmesh.make_mesh(jax.devices()[:8])
    for x, rx, ax in ((packed, r_packed, 0), (valid, r_valid, -1)):
        parts = pmesh.shard_operand(mesh, x, batch_axis=ax)
        assert [tuple(p.shape) for p in parts] == [(n // 8,) + x.shape[1:]] * 8
        assert all(np.array_equal(p.numpy(), x[k * 8: (k + 1) * 8]) for k, p in enumerate(parts))
        shards = rmesh.shard_operand(rm, rx, batch_axis=ax).addressable_shards
        order = {d: i for i, d in enumerate(rm.devices.flat)}
        by_pos = sorted(shards, key=lambda s: order[s.device])
        assert all(np.array_equal(p.numpy(), np.asarray(s.data)) for p, s in zip(parts, by_pos))
        assert pmesh.batch_sharding(mesh, x.ndim, ax).shard_shape(x.shape) == tuple(parts[0].shape)
        assert rmesh.batch_sharding(rm, x.ndim, ax).shard_shape(x.shape) == tuple(parts[0].shape)


def test_the_verifier_issues_contiguous_slices(mesh, monkeypatch):
    """CudaBatchVerifier(mesh=) hands the verify function each device's
    contiguous slice of the staged chunk, in mesh order, skips the slices
    that hold only padding, gathers the answers back into request order,
    and keys its dispatch -1 in the device ledger."""
    seen = []

    def record(curve, packed, valid, windowed=None):
        seen.append(packed.clone())
        return valid.clone()

    monkeypatch.setattr(pbv, "ecdsa_verify_packed", record)
    reqs = _port(ref._requests(P256, random.Random(3), 19))
    ledger = dlib.DeviceAccounting()
    dlib.set_device_accounting(ledger)
    try:
        pv = pbv.CudaBatchVerifier(batch_sizes=(32,), mesh=mesh).verify_batch_async(reqs)
        got = pv.result()
    finally:
        dlib.set_device_accounting(None)
    packed, valid = penc.stage_ecdsa_packed(P_P256, [(r.key.data, r.signature, r.message)
                                                     for r in reqs], 32)
    assert len(seen) == 5                    # rows 0-18 over slices of 4: 5 slices hold a row
    assert np.array_equal(torch.cat(seen).numpy(), packed[:20])
    assert got == valid[:19].tolist()
    assert list(ledger.snapshot()["devices"]) == [-1]
    row = ledger.snapshot()["devices"][-1]
    assert (row["dispatches"], row["requests"]) == (1, 19)


def test_a_fault_names_its_device(mesh, monkeypatch):
    calls = []

    def fail_third(curve, packed, valid, windowed=None):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return valid.clone()

    monkeypatch.setattr(pbv, "ecdsa_verify_packed", fail_third)
    reqs = _port(ref._requests(P256, random.Random(3), 16))
    with pytest.raises(DeviceFaultError, match="verify dispatch on cpu:2: CUDA error"):
        pbv.CudaBatchVerifier(batch_sizes=(16,), mesh=mesh).verify_batch(reqs)
    assert len(calls) == 3                   # nothing re-run elsewhere


def test_mesh_refusals(mesh):
    with pytest.raises(ValueError, match="mutually exclusive"):
        pbv.CudaBatchVerifier(mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        rbv.TpuBatchVerifier(mesh=rmesh.make_mesh(jax.devices()[:8]), device=jax.devices()[0])
    with pytest.raises(ValueError, match="12 rows do not split evenly over 8 devices"):
        pbv.CudaBatchVerifier(batch_sizes=(16, 12), mesh=mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pbv.CudaBatchVerifier(mesh=pmesh.make_mesh([torch.device("cuda", 0)]))


def test_per_shard_verifiers_pin_as_the_reference():
    """Shard k pins to devices[k % n]; with one device every shard shares
    it unpinned; devices=None means every card, and raises without one."""
    jdev = jax.devices()
    for n_shards, n_dev in ((4, 4), (10, 4), (3, 1)):
        port = pbv.per_shard_verifiers(n_shards, batch_sizes=(16,), devices=DEVICES[:n_dev])
        refs = rbv.per_shard_verifiers(n_shards, batch_sizes=(16,), devices=jdev[:n_dev])
        assert [v.device.index for v in port] == [
            None if v.device is None else v.device.id for v in refs]
        assert all(v.batch_sizes == (16,) and v.device.type == "cpu" for v in port)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pbv.per_shard_verifiers(2)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["p256", "k1", "ed25519", "mixed", "chunking", "2d"])
def test_mesh_equals_the_references_mesh(case):
    """The reference's TpuBatchVerifier(mesh=) on its 8 virtual CPU
    devices and the port's on 8 CPU devices, on the same requests:
    equal row for row (compiles the reference's XLA ladders)."""
    jdev = jax.devices()[:8]
    rm, pm, shape = rmesh.make_mesh(jdev), pmesh.make_mesh(DEVICES), 16
    if case in ("p256", "k1", "ed25519"):
        sid = dict(zip(("p256", "k1", "ed25519"), ref.MESH_SCHEMES))[case]
        reqs = ref._requests(sid, random.Random(sid), 9)
    elif case == "mixed":
        reqs = _mixed(random.Random(99))
    elif case == "chunking":
        reqs = ref._requests(P256, random.Random(7), 24)
    else:
        rm, pm = rmesh.make_mesh_2d(2, 4, jdev), pmesh.make_mesh_2d(2, 4, DEVICES)
        reqs = [r for sid in ref.MESH_SCHEMES
                for r in ref._requests(sid, random.Random(sid + 77), 13)]
    want = rbv.TpuBatchVerifier(batch_sizes=(shape,), mesh=rm).verify_batch(reqs)
    assert pbv.CudaBatchVerifier(batch_sizes=(shape,), mesh=pm).verify_batch(_port(reqs)) == want
    assert want == rbv.CpuBatchVerifier().verify_batch(reqs)
