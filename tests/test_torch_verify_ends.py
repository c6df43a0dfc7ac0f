"""The verify program around the ladders on the CPU against corda_tpu.

Each stage's plain torch version (eddsa.ed_prologue_plain,
ed_epilogue_plain; ecdsa.ecdsa_prologue_plain, ecdsa_epilogue_plain:
what csrc/ed_ends.cu and csrc/wei_ends.cu compute on the card) runs on
rows made with a seed (testing/selfcheck.py's `*_prologue_rows` and
`*_epilogue_rows`: the crafted edge rows, then staged ed25519
build_requests and ed25519_edge_requests rows, or seeded ECDSA
signatures), and the same rows go through the
reference's pieces (ed_decompress_neg_batch, ec.ed_ext_to_affine and the
compare; the operands the reference's ecdsa_verify_packed hands its
ecdsa_verify_batch, its scalars and its checks after the ladder), run
eagerly on the CPU, and through refmath. Then the whole
`*_verify_packed` of both packages over staged build_requests rows (and
ed25519_edge_requests) followed by the crafted rows. Limbs, digits and
verdicts compare exactly: no tolerance. The stage wrappers dispatch on
the device: the plain version for CPU tensors only, and on any other
device the kernel, whose wrapper refuses a non-CUDA tensor (no
fallback); a verify call there goes prologue, ladder, epilogue and
issues no power or inverse as torch ops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from corda_tpu.crypto import ec as JEC  # noqa: E402
from corda_tpu.crypto import ecdsa as JE  # noqa: E402
from corda_tpu.crypto import eddsa as JD  # noqa: E402
from corda_tpu.crypto import modmath as JM  # noqa: E402
from corda_tpu.crypto.curves import ED25519 as J_ED  # noqa: E402
from corda_tpu.crypto.curves import SECP256K1 as J_K1  # noqa: E402
from corda_tpu.crypto.curves import SECP256R1 as J_R1  # noqa: E402
from corda_tpu_torch.crypto import cuda_ec, refmath, schemes  # noqa: E402
from corda_tpu_torch.crypto import ecdsa as TE  # noqa: E402
from corda_tpu_torch.crypto import eddsa as TD  # noqa: E402
from corda_tpu_torch.crypto import limbs as L  # noqa: E402
from corda_tpu_torch.crypto import modmath as TM  # noqa: E402
from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier  # noqa: E402
from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1  # noqa: E402
from corda_tpu_torch.crypto.encodings import (  # noqa: E402
    stage_ecdsa_packed_py,
    stage_ed25519_packed_py,
)
from corda_tpu_torch.testing import selfcheck  # noqa: E402

CURVES = {"p256": (J_R1, SECP256R1), "k1": (J_K1, SECP256K1)}
ED_ROWS = 80        # every crafted and staged ed25519 prologue row
ECDSA_ROWS = 40     # every crafted and seeded ECDSA prologue row
ED_R_ROWS = 65      # ed25519_epilogue_rows' distinct rows
ECDSA_R_ROWS = 50   # ecdsa_epilogue_rows' distinct rows


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _same(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _cols(packed):
    return jnp.asarray(packed).T.astype(jnp.int32)


def _ints(a):
    return L.batch_to_ints(np.asarray(a))


def test_ed_prologue_plain_matches_reference():
    """ed_prologue_plain against the reference's unpacking,
    ed_decompress_neg_batch and to_mont on every ed25519_prologue_rows
    row (A.y = 0, 1, p - 1, >= p, off the curve, each sign; s = 2^256 -
    1; valid_in False; staged requests and edge rows; both square-root
    branches): every limb and verdict equal; and -A.x and ok equal to
    refmath.ed_decompress; exact."""
    c = ED25519
    packed, a_sign, valid = selfcheck.ed25519_prologue_rows(ED_ROWS, seed=21)
    pb = _cols(packed)
    s, k, ay = (JM.unpack_be32(pb[32 * i : 32 * i + 32]) for i in range(3))
    nax, nay, ok_a = JD.ed_decompress_neg_batch(ay, jnp.asarray(a_sign))
    want = (s, k, JM.to_mont(J_ED.fp, nax), JM.to_mont(J_ED.fp, nay), jnp.asarray(valid) & ok_a)
    got = TD.ed_prologue_plain(_t(packed), _t(a_sign), _t(valid))
    _same(got, want)
    ok = got[4].tolist()
    naxs = [v * pow(1 << L.R_BITS, -1, c.p) % c.p for v in _ints(got[2])]
    for i, y in enumerate(_ints(ay)):
        A = refmath.ed_decompress(c, (y | int(a_sign[i]) << 255).to_bytes(32, "little"))
        assert ok[i] == (bool(valid[i]) and A is not None), i
        if A is not None:
            assert naxs[i] == (-A[0]) % c.p, i
    assert 0 < sum(ok) < ED_ROWS


def test_ed_epilogue_plain_matches_reference():
    """ed_epilogue_plain against the reference's ec.ed_ext_to_affine,
    from_mont and compare on every ed25519_epilogue_rows row (R.y and
    sign matching, sign flipped, R.y + p, ok False, Z = 0; some digits
    lazily reduced), and against Python ints; exact."""
    c = ED25519
    R, packed, r_sign, ok = selfcheck.ed25519_epilogue_rows(ED_R_ROWS, seed=22)
    fp = J_ED.fp
    xm, ym = JEC.ed_ext_to_affine(fp, tuple(jnp.asarray(x) for x in R))
    x_std, y_std = JM.from_mont(fp, xm), JM.from_mont(fp, ym)
    exp_y = JM.unpack_be32(_cols(packed)[96:128])
    want = jnp.asarray(ok) & JM.eq(y_std, exp_y) & ((x_std[0] & 1) == jnp.asarray(r_sign))
    got = TD.ed_epilogue_plain(tuple(_t(x) for x in R), _t(packed), _t(r_sign), _t(ok))
    assert got.tolist() == np.asarray(want).tolist()
    rinv = pow(1 << L.R_BITS, -1, c.p)
    X, Y, Z = ([v * rinv % c.p for v in _ints(a)] for a in R[:3])
    for i in range(ED_R_ROWS):
        zi = pow(Z[i], -1, c.p) if Z[i] else 0
        x, y = X[i] * zi % c.p, Y[i] * zi % c.p
        ry = int.from_bytes(bytes(packed[i, 96:]), "big")
        assert got[i].item() == (bool(ok[i]) and y == ry and x & 1 == r_sign[i]), i
    assert 0 < int(got.sum()) < ED_R_ROWS


def _reference_operands(monkeypatch, jc, packed, valid):
    """The operands the reference's ecdsa_verify_packed hands its
    ecdsa_verify_batch: (z, r_use, s_use, qx_use, qy_use, c1, c1_ok,
    valid)."""
    seen = []

    def capture(curve, *args, use_pallas=None):
        seen.append(args)
        return args[-1]

    monkeypatch.setattr(JE, "ecdsa_verify_batch", capture)
    JE.ecdsa_verify_packed(jc, jnp.asarray(packed), jnp.asarray(valid))
    return seen[0]


@pytest.mark.parametrize("name", list(CURVES))
def test_ecdsa_prologue_plain_matches_reference(monkeypatch, name):
    """ecdsa_prologue_plain against the reference's checks and benign
    substitution (the operands its ecdsa_verify_packed hands on), its
    scalars (ecdsa_verify_batch's u1 = z/s, u2 = r/s mod n by mont_inv)
    and to_mont of Q, on every ecdsa_prologue_rows row (z >= n, r or s
    0, n, n - 1, 2^256 - 1, coordinates >= p, Q off the curve, Q = G,
    the r + n row, valid_in False, seeded signatures of build_requests'
    kinds); and valid, u1, u2 against Python ints; exact."""
    jc, tc = CURVES[name]
    packed, valid = selfcheck.ecdsa_prologue_rows(tc, ECDSA_ROWS, seed=23)
    z, r_use, s_use, qx_use, qy_use, _c1, _c1_ok, valid_ref = _reference_operands(
        monkeypatch, jc, packed, valid)
    fn, fp = jc.fn, jc.fp
    w = JM.mont_inv(fn, JM.to_mont(fn, s_use))
    u1 = JM.from_mont(fn, JM.mont_mul(fn, JM.to_mont(fn, z), w))
    u2 = JM.from_mont(fn, JM.mont_mul(fn, JM.to_mont(fn, r_use), w))
    want = (u1, u2, JM.to_mont(fp, qx_use), JM.to_mont(fp, qy_use), valid_ref)
    got = TE.ecdsa_prologue_plain(tc, _t(packed), _t(valid))
    _same(got, want)
    for i in range(ECDSA_ROWS):
        zz, r, s, qx, qy = (int.from_bytes(bytes(packed[i, 32 * j : 32 * j + 32]), "big")
                            for j in range(5))
        ok = (bool(valid[i]) and 0 < r < tc.n and 0 < s < tc.n and qx < tc.p and qy < tc.p
              and refmath.wei_on_curve(tc, (qx, qy)))
        assert got[4][i].item() == ok, i
        if ok:
            si = pow(s, -1, tc.n)
            assert (_ints(got[0][:, i:i + 1])[0], _ints(got[1][:, i:i + 1])[0]) == (
                zz * si % tc.n, r * si % tc.n), i
    assert 0 < int(got[4].sum()) < ECDSA_ROWS


@pytest.mark.parametrize("name", list(CURVES))
def test_ecdsa_epilogue_plain_matches_reference(name):
    """ecdsa_epilogue_plain against the reference's checks after the
    ladder (c1 = r + n and its c1 < p gate, wei_is_infinity, c*Z == X
    for c in {r, c1}) on every ecdsa_epilogue_rows row (x_R = r, x_R = r
    + n < p, r + n >= p gated, r = 2^256 - 1, a wrong r, Z = 0, valid
    False; some digits lazily reduced), and against Python ints; exact."""
    jc, tc = CURVES[name]
    R, packed, valid = selfcheck.ecdsa_epilogue_rows(tc, ECDSA_R_ROWS, seed=24)
    fp = jc.fp
    r = JM.unpack_be32(_cols(packed)[32:64])
    n_col = jnp.asarray(L.int_to_limbs(jc.n))[:, None]
    c1 = JM.canon(fp, r + n_col, bound_mul=1)
    c1_ok = JM.lex_lt(c1, tuple(int(v) for v in L.int_to_limbs(jc.p)))
    X, _Y, Z = (jnp.asarray(x) for x in R)
    not_inf = ~JEC.wei_is_infinity(fp, (X, _Y, Z))
    rhs = JM.mont_canon(fp, JM.mont_mul(fp, X, JM.mont_one(fp, ECDSA_R_ROWS)))
    chk0 = JM.eq(JM.mont_canon(fp, JM.mont_mul(fp, JM.to_mont(fp, r), Z)), rhs)
    chk1 = JM.eq(JM.mont_canon(fp, JM.mont_mul(fp, JM.to_mont(fp, c1), Z)), rhs)
    want = jnp.asarray(valid) & not_inf & (chk0 | (chk1 & c1_ok))
    got = TE.ecdsa_epilogue_plain(tc, tuple(_t(x) for x in R), _t(packed), _t(valid))
    assert got.tolist() == np.asarray(want).tolist()
    p, rinv = tc.p, pow(1 << L.R_BITS, -1, tc.p)
    xs, zs = ([v * rinv % p for v in _ints(a)] for a in (R[0], R[2]))
    for i in range(ECDSA_R_ROWS):
        rr = int.from_bytes(bytes(packed[i, 32:64]), "big")
        hit = (rr * zs[i] - xs[i]) % p == 0 or (
            rr + tc.n < p and ((rr + tc.n) * zs[i] - xs[i]) % p == 0)
        assert got[i].item() == (bool(valid[i]) and zs[i] != 0 and hit), i
    assert 0 < int(got.sum()) < ECDSA_R_ROWS


def test_ed25519_verify_packed_matches_reference():
    """ed25519_verify_packed on CPU tensors (prologue, plain ladder,
    epilogue) against the reference's (use_pallas=False), run eagerly,
    on staged build_requests and ed25519_edge_requests rows followed by
    the crafted prologue rows; the request rows equal CpuBatchVerifier;
    exact."""
    reqs = selfcheck.build_requests(16, seed=25, scheme_ids=(schemes.EDDSA_ED25519_SHA512,))
    reqs += [r for _, r in selfcheck.ed25519_edge_requests(seed=25)]
    items = [(r.key.data, r.signature, r.message) for r in reqs]
    packed, a_sign, r_sign, valid = stage_ed25519_packed_py(items, len(items))
    crafted = selfcheck.ed25519_prologue_rows(16, seed=25)
    packed = np.concatenate([packed, crafted[0]])
    a_sign = np.concatenate([a_sign, crafted[1]])
    r_sign = np.concatenate([r_sign, np.zeros(16, np.int32)])
    valid = np.concatenate([valid, crafted[2]])
    want = JD.ed25519_verify_packed(*(jnp.asarray(a) for a in (packed, a_sign, r_sign, valid)),
                                    use_pallas=False)
    got = TD.ed25519_verify_packed(_t(packed), _t(a_sign), _t(r_sign), _t(valid))
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist()[:len(reqs)] == CpuBatchVerifier().verify_batch(reqs)
    assert 0 < int(got.sum()) < len(got)


@pytest.mark.parametrize("name", list(CURVES))
def test_ecdsa_verify_packed_matches_reference(name):
    """ecdsa_verify_packed on CPU tensors (prologue, the curve's default
    ladder, epilogue) against the reference's (use_pallas=False), run
    eagerly, on staged build_requests rows followed by every
    ecdsa_prologue_rows row (crafted rows, the r + n row, seeded
    signatures); the request rows equal CpuBatchVerifier, every row
    refmath.ecdsa_verify with the range checks; exact."""
    jc, tc = CURVES[name]
    sid = schemes.ECDSA_SECP256R1_SHA256 if name == "p256" else schemes.ECDSA_SECP256K1_SHA256
    reqs = selfcheck.build_requests(16, seed=26, scheme_ids=(sid,))
    staged, ok = stage_ecdsa_packed_py(tc, [(r.key.data, r.signature, r.message) for r in reqs],
                                       len(reqs))
    crafted, valid = selfcheck.ecdsa_prologue_rows(tc, ECDSA_ROWS, seed=26)
    packed, valid = np.concatenate([staged, crafted]), np.concatenate([ok, valid])
    want = JE.ecdsa_verify_packed(jc, jnp.asarray(packed), jnp.asarray(valid), use_pallas=False)
    got = TE.ecdsa_verify_packed(tc, _t(packed), _t(valid))
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist()[:len(reqs)] == CpuBatchVerifier().verify_batch(reqs)
    for i in range(len(packed)):
        z, r, s, qx, qy = (int.from_bytes(bytes(packed[i, 32 * j : 32 * j + 32]), "big")
                           for j in range(5))
        want_i = (bool(valid[i]) and qx < tc.p and qy < tc.p
                  and refmath.ecdsa_verify(tc, (qx, qy), z, r, s))
        assert got[i].item() == want_i, i
    assert 0 < int(got.sum()) < len(got)


def test_stage_wrappers_dispatch_on_the_device(monkeypatch):
    """The stage wrappers run the plain version for CPU tensors and
    launch nothing; a tensor on any other device goes to the kernel's
    wrapper, which refuses a non-CUDA tensor with ValueError: no
    fallback."""
    packed, a_sign, valid = selfcheck.ed25519_prologue_rows(2, seed=27)
    before = {k: getattr(cuda_ec, k + "_launches")
              for k in ("ed_prologue", "ed_epilogue", "ecdsa_prologue", "ecdsa_epilogue")}
    out = TD.ed_prologue(_t(packed), _t(a_sign), _t(valid))
    assert [o.device.type for o in out] == ["cpu"] * 5
    meta = (_t(packed).to("meta"), _t(a_sign).to("meta"), _t(valid).to("meta"))
    with pytest.raises(ValueError, match="packed is on meta; the CUDA prologue needs a CUDA tensor"):
        TD.ed_prologue(*meta)
    R = tuple(torch.zeros(22, 2, dtype=torch.int32, device="meta") for _ in range(4))
    with pytest.raises(ValueError, match="the CUDA epilogue needs a CUDA tensor"):
        TD.ed_epilogue(R, meta[0], meta[1], meta[2])
    epacked, evalid = selfcheck.ecdsa_prologue_rows(SECP256R1, 2, seed=27)
    em = (_t(epacked).to("meta"), _t(evalid).to("meta"))
    with pytest.raises(ValueError, match="the CUDA prologue needs a CUDA tensor"):
        TE.ecdsa_prologue(SECP256R1, *em)
    with pytest.raises(ValueError, match="the CUDA epilogue needs a CUDA tensor"):
        TE.ecdsa_epilogue(SECP256R1, R[:3], *em)
    for kern in (cuda_ec.ed_prologue_cuda,):
        with pytest.raises(ValueError, match="packed is on cpu; the CUDA prologue"):
            kern(_t(packed), _t(a_sign), _t(valid))
    assert before == {k: getattr(cuda_ec, k + "_launches") for k in before}


@pytest.mark.parametrize("scheme", ["ed25519", "p256", "k1"])
def test_verify_on_a_card_runs_three_kernels(monkeypatch, scheme):
    """On a non-CPU tensor a verify call is prologue kernel, ladder
    kernel, epilogue kernel, each given the last one's outputs, and no
    power, inverse or other modmath torch op: the kernels' wrappers
    are stood in for by recorders on meta tensors."""
    calls = []

    def rec(name, outs):
        def fn(*args):
            calls.append((name, args))
            return outs
        return fn

    def forbid(*args, **kw):
        raise AssertionError("a modmath torch op on the card's path")

    for fname in ("mont_pow_const", "mont_inv", "mont_mul", "to_mont", "from_mont"):
        monkeypatch.setattr(TM, fname, forbid)
        for mod in (TD, TE):
            if hasattr(mod, fname):
                monkeypatch.setattr(mod, fname, forbid)
    digits = tuple(torch.zeros(22, 4, dtype=torch.int32, device="meta") for _ in range(4))
    ok = torch.zeros(4, dtype=torch.bool, device="meta")
    verdict = torch.ones(4, dtype=torch.bool, device="meta")
    if scheme == "ed25519":
        monkeypatch.setattr(cuda_ec, "ed_prologue_cuda", rec("prologue", digits + (ok,)))
        monkeypatch.setattr(cuda_ec, "ed_ladder_cuda", rec("ladder", digits))
        monkeypatch.setattr(cuda_ec, "ed_epilogue_cuda", rec("epilogue", verdict))
        packed = torch.zeros(4, 128, dtype=torch.uint8, device="meta")
        ints = torch.zeros(4, dtype=torch.int32, device="meta")
        out = TD.ed25519_verify_packed(packed, ints, ints, ok)
    else:
        curve = SECP256R1 if scheme == "p256" else SECP256K1
        ladder = "wei_ladder_windowed_cuda" if scheme == "p256" else "wei_ladder_cuda"
        monkeypatch.setattr(cuda_ec, "ecdsa_prologue_cuda", rec("prologue", digits + (ok,)))
        monkeypatch.setattr(cuda_ec, ladder, rec("ladder", digits[:3]))
        monkeypatch.setattr(cuda_ec, "ecdsa_epilogue_cuda", rec("epilogue", verdict))
        packed = torch.zeros(4, 160, dtype=torch.uint8, device="meta")
        out = TE.ecdsa_verify_packed(curve, packed, ok)
    assert out is verdict
    assert [name for name, _ in calls] == ["prologue", "ladder", "epilogue"]
    ladder_args = calls[1][1]
    assert all(a is b for a, b in zip(ladder_args[1:], digits))
    epi = calls[2][1]
    assert epi[-1] is ok and any(a is packed for a in epi)
