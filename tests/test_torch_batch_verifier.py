"""The port's batch-verifier SPI against the reference's CPU verifier.

CudaBatchVerifier(device="cpu") runs the whole slice — bucketing by
scheme, padding, chunking, staging, device-side validation, the plain
ladders and streaming — on CPU tensors. Its answers must equal the
reference package's CpuBatchVerifier and the port's, row for row
(exact: accept/reject has no tolerance).
"""

import pytest

torch = pytest.importorskip("torch")

from corda_tpu.crypto import batch_verifier as J_BV  # noqa: E402
from corda_tpu.crypto import schemes as J_S  # noqa: E402
from corda_tpu.testing import tpu_selfcheck  # noqa: E402
from corda_tpu_torch import convert  # noqa: E402
from corda_tpu_torch.crypto import batch_verifier as BV  # noqa: E402
from corda_tpu_torch.crypto import cuda_ec, schemes  # noqa: E402
from corda_tpu_torch.testing.selfcheck import (  # noqa: E402
    TAMPERED_KINDS,
    build_requests,
    ed25519_edge_requests,
)

N = 40


@pytest.fixture(scope="module")
def corpus():
    reqs = build_requests(N, seed=31)
    want = J_BV.CpuBatchVerifier().verify_batch(reqs)   # duck-typed requests
    return reqs, want


def test_cuda_verifier_on_cpu_matches_references(corpus):
    """A mixed p256/k1/ed25519 corpus of 40 rows (one call, bucketed per
    scheme), padded and chunked at batch_sizes=(8, 16): equal to the
    reference's CpuBatchVerifier, to the port's CpuBatchVerifier and to
    the construction labels; chunks stream in dispatch order; exact."""
    reqs, want = corpus
    assert BV.CpuBatchVerifier().verify_batch(reqs) == want
    assert want == [i % 8 not in TAMPERED_KINDS for i in range(N)]
    v = BV.CudaBatchVerifier(batch_sizes=(16, 8), device="cpu")
    assert v.batch_sizes == (8, 16) and v._pick_batch(4) == 8 and v._pick_batch(40) == 16
    pv = v.verify_batch_async(reqs)
    assert pv.streamed and pv.skeleton() == [None] * N
    seen, firsts = {}, []
    for idxs, vals in pv.chunks():
        firsts.append(idxs[0])
        assert len(idxs) == len(vals) <= 16
        seen.update(zip(idxs, vals))
    # buckets dispatch in order of first appearance, p256 (i % 3 == 0:
    # 14 rows), k1 (13), ed25519 (13), one chunk of <= 16 each
    assert firsts == [0, 1, 2]
    assert [seen[i] for i in range(N)] == want
    assert pv.result() == want
    assert (cuda_ec.wei_ladder_launches, cuda_ec.wei_ladder_windowed_launches,
            cuda_ec.ed_ladder_launches, cuda_ec.ed_ladder_windowed_launches) == (0, 0, 0, 0)


def test_mixed_corpus_with_ed25519_edges_matches_references():
    """ed25519 edge rows (s + L, A.y >= p, R.y >= p, A = identity, the
    x = 0 rule, A off the curve, small-order A) mixed with p256 and k1
    rows, through CudaBatchVerifier(device="cpu") with each ladder
    choice: equal to the reference's and the port's CpuBatchVerifier;
    exact."""
    reqs = [r for _, r in ed25519_edge_requests(seed=9)]
    reqs += build_requests(6, seed=8, scheme_ids=(schemes.ECDSA_SECP256R1_SHA256,
                                                 schemes.ECDSA_SECP256K1_SHA256))
    want = J_BV.CpuBatchVerifier().verify_batch(reqs)
    assert BV.CpuBatchVerifier().verify_batch(reqs) == want
    for windowed in (None, True):
        v = BV.CudaBatchVerifier(batch_sizes=(16,), device="cpu", windowed=windowed)
        assert v.verify_batch(reqs) == want


def test_requests_from_reference(corpus):
    """Requests built by the reference package (p256, k1 and ed25519
    rows) convert by duck typing; the port verifies them as the
    reference does; exact."""
    jreqs = tpu_selfcheck.build_requests(12, seed=3)
    assert {r.key.scheme_id for r in jreqs} == set(BV.SCHEME_KERNELS)
    reqs = convert.requests_from_reference(jreqs)
    assert all(isinstance(r, BV.VerificationRequest) for r in reqs)
    assert [r.key.data for r in reqs] == [r.key.data for r in jreqs]
    got = BV.CudaBatchVerifier(batch_sizes=(8,), device="cpu").verify_batch(reqs)
    assert got == J_BV.CpuBatchVerifier().verify_batch(jreqs)


def test_unsupported_schemes_raise(corpus):
    """RSA, SPHINCS and composite keys are not routed anywhere: the
    whole call raises UnsupportedScheme, on the batch path and the CPU
    reference alike."""
    reqs, _ = corpus
    v = BV.CudaBatchVerifier(batch_sizes=(8,), device="cpu")
    for sid in (schemes.RSA_SHA256, schemes.SPHINCS256_SHA256, schemes.COMPOSITE_KEY):
        req = BV.VerificationRequest(schemes.PublicKey(sid, b"\x00" * 32), b"sig", b"m")
        with pytest.raises(schemes.UnsupportedScheme):
            v.verify_batch(reqs[:3] + [req])
        with pytest.raises(schemes.UnsupportedScheme):
            BV.CpuBatchVerifier().verify_batch([req])
        with pytest.raises(schemes.UnsupportedScheme):
            schemes.generate_keypair(sid, seed=1)


def test_fault_injector_then_pass_through(corpus):
    """DispatchFaultInjector raises DeviceFaultError while armed, then
    passes calls through to the wrapped verifier untouched."""
    reqs, want = corpus
    inj = BV.DispatchFaultInjector(BV.CudaBatchVerifier(batch_sizes=(8,), device="cpu"))
    inj.arm(2)
    assert inj.armed
    with pytest.raises(BV.DeviceFaultError):
        inj.verify_batch(reqs[:4])
    with pytest.raises(BV.DeviceFaultError):
        inj.verify_batch_async(reqs[:4])
    assert not inj.armed and inj.faults_raised == 2
    assert inj.verify_batch_async(reqs[:4]).result() == want[:4]
    sync = BV.DispatchFaultInjector(BV.CpuBatchVerifier())
    assert sync.verify_batch_async(reqs[:2]).result() == want[:2]
    inj.arm(1, exc_factory=lambda: RuntimeError("custom"))
    with pytest.raises(RuntimeError, match="custom"):
        inj.verify_batch(reqs[:1])


def test_no_cpu_fallback_without_cuda():
    """Without CUDA, the default-device verifier and default_verifier()
    raise instead of running elsewhere; an explicit verifier can be
    installed."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BV.CudaBatchVerifier()
    with pytest.raises(ValueError):
        BV.CudaBatchVerifier(device="meta")
    prev = BV._default
    try:
        BV.set_default_verifier(None)
        with pytest.raises(RuntimeError):
            BV.default_verifier()
        cpu = BV.CpuBatchVerifier()
        BV.set_default_verifier(cpu)
        assert BV.default_verifier() is cpu
    finally:
        BV.set_default_verifier(prev)


def test_schemes_keys_sign_verify():
    """Keygen from a seed matches the reference's key for the same seed;
    signatures from either package verify in both; exact."""
    for sid in (schemes.ECDSA_SECP256R1_SHA256, schemes.ECDSA_SECP256K1_SHA256):
        kp = schemes.generate_keypair(sid, seed=77)
        jkp = J_S.generate_keypair(sid, seed=77)
        assert kp.public.data == jkp.public.data and kp.private.data == jkp.private.data
        sig = kp.private.sign(b"msg")
        assert schemes.verify_one(kp.public, sig, b"msg")
        assert J_S.verify_one(jkp.public, sig, b"msg")
        assert not schemes.verify_one(kp.public, sig, b"msh")
        jsig = jkp.private.sign(b"msg")
        assert schemes.verify_one(kp.public, jsig, b"msg")
        py = schemes._ecdsa_sign_py(schemes.WCURVE[sid], 12345, b"x")
        pub = schemes.generate_keypair(sid, seed=12344).public   # d = 12344 % (n-1) + 1
        assert schemes.verify_one(pub, py, b"x")


def test_cuda_errors_become_device_faults():
    """A CUDA runtime error at dispatch or while waiting for a chunk
    surfaces as DeviceFaultError (the notary's degraded-mode class);
    other errors pass through unchanged."""
    with pytest.raises(BV.DeviceFaultError, match="illegal memory access"):
        with BV._device_faults("dispatch"):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
    with pytest.raises(RuntimeError, match="shape") as info:
        with BV._device_faults("dispatch"):
            raise RuntimeError("shape mismatch")
    assert not isinstance(info.value, BV.DeviceFaultError)
    with pytest.raises(ValueError):
        with BV._device_faults("dispatch"):
            raise ValueError("bad input")

    class LostEvent:
        def synchronize(self):
            raise RuntimeError("CUDA error: unspecified launch failure")

    chunk = BV._Chunk(torch.zeros(4, dtype=torch.bool), [0, 1], 2, LostEvent(), LostEvent())
    pv = BV.PendingVerification([None, None], [chunk], streamed=True)
    with pytest.raises(BV.DeviceFaultError):
        pv.result()
    with pytest.raises(BV.DeviceFaultError):   # not marked done: raises again
        list(pv.chunks())
