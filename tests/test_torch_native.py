"""The port's native host library against its Python paths and the
reference's, held to the cases of tests/test_native.py.

Four implementations of each function meet here: the port's native
library (corda_tpu_torch/native/cts_hash.cpp, the main path), the
port's Python path (`encode_py`, `merkle_root_py`, ...), the reference
package's Python path, and the reference package's C library, built
from its own source by the port's build function and wired to the
reference's registry as the reference wires it. Equality is exact:
bytes, ids, roots, proofs, staging records, valid flags, hand-back rows,
accept/reject decisions, exception classes and contract messages.
"""

from __future__ import annotations

import importlib.util
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import corda_tpu.core.serialization as rser  # noqa: E402
import corda_tpu.crypto.curves as rcurves  # noqa: E402
import corda_tpu.crypto.encodings as renc  # noqa: E402
import corda_tpu.crypto.hashes as rhashes  # noqa: E402
import corda_tpu.crypto.merkle as rmerkle  # noqa: E402
import corda_tpu.finance.asset as rasset  # noqa: E402
import corda_tpu.finance.cash  # noqa: E402,F401  (wire classes)
import corda_tpu_torch.core.contracts as pcontracts  # noqa: E402
import corda_tpu_torch.core.serialization as pser  # noqa: E402
import corda_tpu_torch.crypto.encodings as penc  # noqa: E402
import corda_tpu_torch.crypto.hashes as phashes  # noqa: E402
import corda_tpu_torch.crypto.merkle as pmerkle  # noqa: E402
import corda_tpu_torch.finance.cash  # noqa: E402,F401  (wire classes)
from corda_tpu_torch import native  # noqa: E402
from corda_tpu_torch.native import build as nbuild  # noqa: E402
from test_torch_serialization import PORT, REF, _values  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_SOURCE = ROOT / "corda_tpu" / "native" / "cts_hash.cpp"


@pytest.fixture(scope="module")
def port_lib():
    return native.get()


@pytest.fixture(scope="module")
def ref_lib():
    """The reference's C library, built from corda_tpu/native/cts_hash.cpp
    and configured with the reference's registry, as its serialization
    module's _native_codec does."""
    info = nbuild.build(REF_SOURCE)
    spec = importlib.util.spec_from_file_location("corda_tpu.native._cts_hash", info.path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.cts_abi == 2
    mod.cts_configure(
        rser.SerializationError, rser._CLASS_ENC_CACHE, rser._class_enc_info,
        rser._REGISTRY_BY_TAG, rser._CUSTOM_DEC, rser._construct_pretuplified,
        rser._unknown_tag_handler, rser._varint_abs,
    )
    return mod


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - outcome comparison
        return ("err", type(e).__name__)


def _rng_bytes(rng, n):
    return rng.getrandbits(8 * n).to_bytes(n, "big") if n else b""


# -- hashing and Merkle trees -------------------------------------------------


def test_sha256_many_four_ways(port_lib, ref_lib):
    """Random lengths and the padding-edge lengths: the port's native
    and hashlib paths, the reference's sha256_many and its C library."""
    import hashlib

    rng = random.Random(1)
    items = [_rng_bytes(rng, rng.randrange(0, 300)) for _ in range(200)]
    items += [b"\xab" * n for n in (55, 56, 57, 63, 64, 65, 119, 120, 128, 1000)]
    want = [hashlib.sha256(i).digest() for i in items]
    assert phashes.sha256_many(items) == want
    assert phashes.sha256_many_py(items) == want
    assert rhashes.sha256_many(items) == want
    assert list(ref_lib.sha256_many(items)) == want
    assert port_lib.sha256(items[-1]) == want[-1]


def _leaves(ns, rng, n):
    return [ns.SecureHash.sha256(_rng_bytes(rng, 8)) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 33, 64])
def test_merkle_roots_and_paths_four_ways(n, ref_lib):
    """merkle_root, merkle_roots_from_digests and single_leaf_proofs:
    native and Python in the port, the reference's main path and its C
    library's merkle_paths — equal roots and byte-equal proofs, each
    proof verifying through verify_proofs."""
    rng = random.Random(n)
    pl = _leaves(PORT, rng, n)
    rl = [REF.SecureHash(h.bytes_) for h in pl]
    root = pmerkle.merkle_root(pl)
    assert root == pmerkle.merkle_root_py(pl)
    assert root.bytes_ == rmerkle.merkle_root(rl).bytes_
    digests = [[h.bytes_ for h in pl], [h.bytes_ for h in pl[: max(1, n // 2)]]]
    assert (pmerkle.merkle_roots_from_digests(digests)
            == pmerkle.merkle_roots_from_digests_py(digests)
            == rmerkle.merkle_roots_from_digests(digests))
    (r1, p1), (r2, p2) = pmerkle.single_leaf_proofs(pl), pmerkle.single_leaf_proofs_py(pl)
    r3, p3 = rmerkle.single_leaf_proofs(rl)
    root_b, paths = ref_lib.merkle_paths([h.bytes_ for h in pl])
    assert r1 == r2 == root and r3.bytes_ == root.bytes_ == bytes(root_b)
    assert [pser.encode(p) for p in p1] == [pser.encode_py(p) for p in p2] == [
        rser.encode_py(p) for p in p3]
    assert [p.path for p in p1] == [bytes(p) for p in paths]
    items = [(p, root, [pl[i]]) for i, p in enumerate(p1)]
    assert pmerkle.verify_proofs(items) == pmerkle.verify_proofs_py(items) == [True] * n


def test_merkle_native_rejects_bad_input(port_lib):
    for fn in (port_lib.merkle_root, port_lib.merkle_paths):
        with pytest.raises(ValueError):
            fn([])
        with pytest.raises(ValueError):
            fn([b"short"])


def _pmt_case(ns, rng, n_leaves=None, n_included=None):
    n_leaves = n_leaves or rng.choice([1, 2, 3, 7, 8, 16, 33, 64])
    leaves = _leaves(ns, rng, n_leaves)
    k = n_included or rng.randint(1, n_leaves)
    included = [leaves[i] for i in sorted(rng.sample(range(n_leaves), k))]
    return ns.PartialMerkleTree.build(leaves, included), ns.merkle_root(leaves), included


def _pmt_items():
    """200 random partial proofs, corrupted five ways, plus the edge
    encodings of test_native.py (duplicate and out-of-range indices,
    unused proof hashes, a single-leaf tree, an empty proof)."""
    P = pmerkle.PartialMerkleTree
    rng = random.Random(77)
    items = []
    for _ in range(200):
        pmt, root, included = _pmt_case(PORT, rng)
        kind = rng.randrange(6)
        if kind == 1:
            root = PORT.SecureHash.sha256(b"wrong")
        elif kind == 2:
            included = [PORT.SecureHash.sha256(b"evil")] + list(included[1:])
        elif kind == 3:
            included = list(included) + [PORT.SecureHash.sha256(b"extra")]
        elif kind == 4:
            pmt = P(pmt.tree_size, pmt.included_indices, pmt.hashes[:-1])
        elif kind == 5:
            pmt = P(pmt.tree_size + 1, pmt.included_indices, pmt.hashes)
        items.append((pmt, root, included))
    pmt, root, included = _pmt_case(PORT, random.Random(5), n_leaves=8, n_included=2)
    items.append((P(pmt.tree_size, (pmt.included_indices[0],) * 2, pmt.hashes), root, included))
    items.append((P(pmt.tree_size, (0, 99), pmt.hashes), root, included))
    items.append((P(pmt.tree_size, pmt.included_indices,
                    pmt.hashes + (PORT.SecureHash.sha256(b"pad"),)), root, included))
    leaf = PORT.SecureHash.sha256(b"solo")
    items.append((P(1, (0,), ()), leaf, [leaf]))
    items.append((P(1, (0,), ()), PORT.SecureHash.sha256(b"not"), [leaf]))
    items.append((P(2, (), ()), root, []))
    return items


def test_pmt_verify_many_four_ways(ref_lib):
    items = _pmt_items()
    want = pmerkle.verify_proofs_py(items)
    assert True in want and False in want
    assert pmerkle.verify_proofs(items) == want
    ritems = [(rser.decode_py(pser.encode(p)), REF.SecureHash(r.bytes_),
               [REF.SecureHash(h.bytes_) for h in ls]) for p, r, ls in items]
    assert rmerkle.verify_proofs(ritems) == want
    assert [p.verify(r, ls) for p, r, ls in ritems] == want
    assert [bool(b) for b in ref_lib.pmt_verify_many(
        [p.as_native_item(r, ls) for p, r, ls in ritems])] == want


# -- signature staging ----------------------------------------------------------


def _ecdsa_items(scheme_id: int, seed: int) -> list:
    """300 rows of the adversarial kinds of test_native.py: truncated,
    trailing byte, bit flip, empty, non-minimal length, a > 256-bit
    integer, a bad key length, a compressed key (handed back to Python),
    a bad SEC1 tag."""
    rng = random.Random(seed)
    kp = PORT.generate_keypair(scheme_id, seed=9)
    items = []
    for i in range(300):
        msg = _rng_bytes(rng, rng.randrange(0, 80))
        sig = kp.private.sign(msg)
        kind = i % 12
        if kind == 3:
            sig = sig[: len(sig) // 2]
        elif kind == 4:
            sig = sig + b"\x00"
        elif kind == 5:
            pos = rng.randrange(len(sig))
            sig = sig[:pos] + bytes([sig[pos] ^ 0x41]) + sig[pos + 1:]
        elif kind == 6:
            sig = b""
        elif kind == 7:
            sig = bytes([0x30, 0x81, len(sig) - 2]) + sig[2:]
        elif kind == 11:
            sig = penc.encode_der_ecdsa((1 << 260) + 5, 7)
        pub = kp.public.data
        if kind == 8:
            pub = pub[:33]
        elif kind == 9:
            pub = (b"\x02" if kp.public.data[-1] % 2 == 0 else b"\x03") + pub[1:33]
        elif kind == 10:
            pub = b"\x05" + pub[1:]
        items.append((pub, sig, msg))
    return items


@pytest.mark.parametrize("scheme_id", [2, 3], ids=["secp256k1", "p256"])
def test_stage_ecdsa_four_ways(scheme_id, port_lib, ref_lib):
    """The 160-byte records and valid flags: the port's native sweep
    (with its hand-back of compressed-key rows), its Python loop, the
    reference's main path and its C library's sweep; the hand-back rows
    of both libraries are the compressed-key rows."""
    curve = PORT.WCURVE[scheme_id]
    items = _ecdsa_items(scheme_id, seed=70 + scheme_id)
    p_nat, v_nat = penc.stage_ecdsa_packed(curve, items, 512)
    p_py, v_py = penc.stage_ecdsa_packed_py(curve, items, 512)
    rcurve = {2: rcurves.SECP256K1, 3: rcurves.SECP256R1}[scheme_id]
    p_ref, v_ref = renc.stage_ecdsa_packed(rcurve, items, 512)
    assert p_nat.shape == (512, penc.ECDSA_RECORD_BYTES) == (512, 160)
    assert (p_nat == p_py).all() and (v_nat == v_py).all()
    assert (p_nat == p_ref).all() and (v_nat == v_ref).all()
    g_rec = curve.gx.to_bytes(32, "big") + curve.gy.to_bytes(32, "big")
    pb, pv, ptodo = port_lib.stage_ecdsa_many(items, 512, g_rec)
    rb, rv, rtodo = ref_lib.stage_ecdsa_many(items, 512, g_rec)
    assert pb == rb and list(pv) == list(rv) and list(ptodo) == list(rtodo)
    assert list(ptodo) == [i for i in range(len(items)) if i % 12 == 9]
    assert v_nat[list(ptodo)].all() and 0 < v_nat.sum() < len(items)


def test_stage_ed25519_four_ways(port_lib, ref_lib):
    """The 128-byte records, both sign-bit arrays and the valid flags
    over truncated, extended, bit-flipped (sign bits too), s = 2^256 - 1
    and short-key rows: the port's native sweep, its Python loop, the
    reference's main path and its C library's sweep."""
    rng = random.Random(31)
    kp = PORT.generate_keypair(PORT.EDDSA_ED25519_SHA512, seed=6)
    items = []
    for i in range(400):
        msg = _rng_bytes(rng, rng.randrange(0, 150))
        sig = kp.private.sign(msg)
        kind = i % 8
        if kind == 3:
            sig = sig[:40]
        elif kind == 4:
            sig = sig + b"\x00"
        elif kind == 5:
            pos = rng.randrange(64)
            sig = sig[:pos] + bytes([sig[pos] ^ 0x80]) + sig[pos + 1:]
        elif kind == 6:
            sig = sig[:32] + b"\xff" * 32
        pub = kp.public.data[:31] if kind == 7 else kp.public.data
        items.append((pub, sig, msg))
    nat = penc.stage_ed25519_packed(items, 512)
    py = penc.stage_ed25519_packed_py(items, 512)
    ref = renc.stage_ed25519_packed(items, 512)
    assert nat[0].shape == (512, penc.ED25519_RECORD_BYTES) == (512, 128)
    for a, b, c in zip(nat, py, ref):
        assert a.dtype == b.dtype == c.dtype
        assert (a == b).all() and (a == c).all()
    pb, pa, pr, pv = port_lib.stage_ed25519_many(items, 512)
    rb, ra, rr, rv = ref_lib.stage_ed25519_many(items, 512)
    assert (pb, list(pa), list(pr), list(pv)) == (rb, list(ra), list(rr), list(rv))
    assert 0 < nat[3].sum() < len(items)


# -- the CTS codec ------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n, _ in _values(PORT)])
def test_codec_table_four_ways(name, ref_lib):
    """test_torch_serialization.py's table: the port's native and Python
    encoders, the reference's main path and its C library give equal
    bytes; both of the port's decoders return the port's classes, which
    encode again to the same bytes."""
    pv = dict(_values(PORT))[name]
    rv = dict(_values(REF))[name]
    blob = pser.encode_py(pv)
    assert pser.encode(pv) == blob
    assert rser.encode(rv) == rser.encode_py(rv) == ref_lib.cts_encode(rv) == blob
    registered = not isinstance(pv, (type(None), bool, int, bytes, str, list, tuple,
                                     dict, frozenset))
    for dec in (pser.decode, pser.decode_py):
        got = dec(blob)
        assert pser.encode_py(got) == blob
        if registered:
            assert type(got) is type(pv)
    if registered:
        assert type(ref_lib.cts_decode(blob)) is type(rv)


def _random_value(rng: random.Random, depth: int = 0):
    """test_native.py's generator over the port's classes: big ints,
    bytearrays, non-ASCII strings, a custom-encoded type, lists, tuples,
    maps, frozensets and registered dataclasses."""
    kinds = [
        lambda: None,
        lambda: rng.random() < 0.5,
        lambda: rng.randint(-(10**3), 10**3),
        lambda: rng.randint(-(2**200), 2**200),
        lambda: rng.choice([0, 1, -1, 2**63 - 1, 2**63, -(2**63), 2**64 - 1, 2**64]),
        lambda: _rng_bytes(rng, rng.randint(0, 40)),
        lambda: bytearray(_rng_bytes(rng, 5)),
        lambda: "".join(rng.choice("aβç∆e \x00") for _ in range(rng.randint(0, 12))),
        lambda: PORT.SecureHash.sha256(_rng_bytes(rng, 8)),
    ]
    if depth < 3:
        kinds += [
            lambda: [_random_value(rng, depth + 1) for _ in range(rng.randint(0, 4))],
            lambda: tuple(_random_value(rng, depth + 1) for _ in range(rng.randint(0, 3))),
            lambda: {_rng_bytes(rng, 4): _random_value(rng, depth + 1)
                     for _ in range(rng.randint(0, 4))},
            lambda: frozenset(rng.randint(0, 99) for _ in range(rng.randint(0, 5))),
            lambda: PORT.StateRef(PORT.SecureHash.sha256(_rng_bytes(rng, 4)), rng.randint(0, 9)),
            lambda: PORT.Amount(rng.randint(0, 10**6), PORT.Issued(
                PORT.PartyAndReference(
                    PORT.Party("P%d" % rng.randint(0, 3),
                               PORT.generate_keypair(seed=rng.randint(1, 8)).public),
                    _rng_bytes(rng, 1)),
                rng.choice(["USD", "EUR"]))),
        ]
    return rng.choice(kinds)()


def test_codec_value_fuzz_four_ways(ref_lib):
    """800 seeded nested values: equal bytes from the port's two
    encoders; the reference's two decoders read them into the
    reference's classes, whose two encoders give the same bytes again;
    every decoder's value re-encodes to the same bytes."""
    rng = random.Random(20260802)
    for i in range(800):
        v = _random_value(rng)
        blob = pser.encode_py(v)
        assert pser.encode(v) == blob, f"iter {i}: {v!r}"
        for got in (pser.decode(blob), pser.decode_py(blob)):
            assert pser.encode_py(got) == blob, f"iter {i}"
        rv = rser.decode_py(blob)
        assert rser.encode_py(rv) == ref_lib.cts_encode(rv) == blob, f"iter {i}"
        assert rser.encode_py(ref_lib.cts_decode(blob)) == blob, f"iter {i}"


def test_codec_mutation_fuzz_four_ways(ref_lib):
    """Mutated, truncated and extended blobs: the four decoders accept
    and reject alike, with the same exception class on a reject and
    equal re-encodings on an accept."""
    rng = random.Random(77)
    seeds = [pser.encode_py(_random_value(rng)) for _ in range(60)]
    rejects = 0
    for i in range(2000):
        blob = bytearray(rng.choice(seeds))
        op = rng.random()
        if op < 0.4 and blob:
            blob[rng.randrange(len(blob))] ^= 1 << rng.randrange(8)
        elif op < 0.7:
            blob = blob[: rng.randint(0, len(blob))]
        else:
            blob += _rng_bytes(rng, rng.randint(1, 4))
        blob = bytes(blob)
        outs = [_outcome(lambda d=d: d(blob)) for d in (
            pser.decode, pser.decode_py, rser.decode_py, ref_lib.cts_decode)]
        kinds = {k for k, _ in outs}
        assert len(kinds) == 1, f"iter {i}: {outs}"
        if outs[0][0] == "err":
            assert len({v for _, v in outs}) == 1, f"iter {i}: {outs}"
            rejects += 1
        else:
            encs = {pser.encode_py(outs[0][1]), pser.encode_py(outs[1][1]),
                    rser.encode_py(outs[2][1]), rser.encode_py(outs[3][1])}
            assert len(encs) == 1, f"iter {i}"
    assert rejects > 500


EDGE_VECTORS = [
    b"", b"\x03", b"\x03\x80", b"\x03\x80\x00", b"\x05\x05ab", b"\x06\x02\xff\xfe",
    b"\x09\x02\xff\xfe\x00", b"\x09\x03Nope\x00", b"\x09\x04Nope\x00", b"\x0a",
    b"\x00\x00", b"\x07\x02\x00", b"\x08\x01\x00", b"\x07" + b"\xff" * 10 + b"\x01",
    b"\x03" + b"\xff" * 95 + b"\x7f", b"\x07\x01" * 4000 + b"\x00",
    b"\x09\x0cMysteryThing\x01" + b"\x06\x01x" + b"\x03\x07",
]


def test_codec_edge_vectors_four_ways(ref_lib):
    """Every decode error branch of test_native.py, and an unknown object
    tag (outside a class-carpenter context decoding is whitelist-only),
    raise SerializationError in all four decoders."""
    for v in EDGE_VECTORS:
        outs = [_outcome(lambda d=d: d(v)) for d in (
            pser.decode, pser.decode_py, rser.decode_py, ref_lib.cts_decode)]
        assert outs == [("err", "SerializationError")] * 4, f"vector {v[:20]!r}: {outs}"


def _object(tag: str, fields: list) -> bytes:
    """The CTS bytes of an object of `tag` with (name, encoded value)
    fields, whether or not a class of that tag is registered."""
    tb = tag.encode()
    out = bytearray(b"\x09") + pser._varint(len(tb)) + tb + pser._varint(len(fields))
    for name, value in fields:
        out += pser.encode_py(name) + value
    return bytes(out)


def _carpented(obj, carpenter, ser):
    """(tag, ((field, value), ...)) of a synthesized object, recursively;
    any other value as its package's encoding."""
    if carpenter.is_synthesized(obj):
        return (type(obj).__cts_tag__, tuple(
            (f, _carpented(getattr(obj, f), carpenter, ser)) for f in obj.__dataclass_fields__))
    if isinstance(obj, tuple):
        return tuple(_carpented(v, carpenter, ser) for v in obj)
    return ser.encode_py(obj)


def test_carpenter_context_decodes_alike_four_ways(ref_lib):
    """Inside each package's carpenter context, unknown tags (nested, in
    lists and maps, beside a known class) decode to the same synthesized
    fields in all four decoders, and a known class with a field it does
    not know decodes field-tolerantly; every result re-encodes to the
    input bytes in its package, except the trimmed known class."""
    import corda_tpu.core.carpenter as rcarp
    import corda_tpu_torch.core.carpenter as pcarp

    txhash = phashes.SecureHash.sha256(b"x")
    ref = pser.encode_py(pcontracts.StateRef(txhash, 3))
    inner = _object("InnerThing", [("v", pser.encode_py(7)), ("blob", pser.encode_py(b"\x01"))])
    vectors = [
        inner,
        _object("OuterThing", [("inner", inner), ("ref", ref), ("n", pser.encode_py(-5)),
                               ("items", pser.encode_py([1, "two", None]))]),
        pser.encode_py([1, {"k": 2}]).replace(b"\x03\x01", inner, 1),
        _object("StateRef", [("txhash", pser.encode_py(txhash)), ("index", pser.encode_py(3)),
                             ("added_later", pser.encode_py("x"))]),
    ]
    for k, v in enumerate(vectors):
        with pcarp.carpenter_context():
            port = [pser.decode(v), pser.decode_py(v)]
        with rcarp.carpenter_context():
            refs = [rser.decode_py(v), ref_lib.cts_decode(v)]
        got = [_carpented(o, pcarp, pser) for o in port] + [
            _carpented(o, rcarp, rser) for o in refs]
        assert got[1:] == got[:1] * 3, f"vector {k}: {got}"
        want = ref if k == 3 else v
        assert [pser.encode(o) for o in port] == [rser.encode_py(o) for o in refs] == [want] * 2
        assert _outcome(lambda: pser.decode(v))[0] == "err"


def test_codec_int_boundaries_and_floats(ref_lib):
    for v in (0, 1, -1, 127, 128, 2**31, -(2**31), 2**63 - 1, 2**63, -(2**63),
              -(2**63) - 1, 2**64 - 1, 2**64, 2**64 + 1, -(2**64), 2**200, -(2**200), 2**639):
        b = pser.encode_py(v)
        assert pser.encode(v) == b == rser.encode_py(v) == ref_lib.cts_encode(v), v
        assert pser.decode(b) == v == pser.decode_py(b) == ref_lib.cts_decode(b), v
    for enc in (pser.encode, pser.encode_py):
        for bad in (1.5, {"a": [1, 2.5]}):
            with pytest.raises(pser.SerializationError):
                enc(bad)


def test_notary_fixture_spends_ids_and_roots_four_ways(ref_lib):
    """The notary fixture's spends and issues: equal wire bytes from
    every encoder, equal transaction ids from the native decode, the
    Python decode with the Python tree, and the reference's decode; equal
    roots over the flush's ids."""
    from test_torch_notary import fixture

    fx = fixture()
    txs = list(fx.spends) + list(fx.issues)
    ids = []
    for stx in txs:
        blob = pser.encode(stx)
        assert blob == pser.encode_py(stx)
        nat, py = pser.decode(blob), pser.decode_py(blob)
        ref = rser.decode_py(blob)
        assert rser.encode_py(ref) == ref_lib.cts_encode(ref) == blob
        py_id = pmerkle.merkle_root_py([
            PORT.SecureHash(phashes.sha256_many_py([pser.encode_py([g, i, c])])[0])
            for g, i, c in py.wtx.component_leaves()])
        assert nat.id == py_id == stx.id
        assert ref.id.bytes_ == stx.id.bytes_
        ids.append(stx.id)
    assert pmerkle.merkle_root(ids) == pmerkle.merkle_root_py(ids)
    assert pmerkle.merkle_root(ids).bytes_ == rmerkle.merkle_root(
        [REF.SecureHash(h.bytes_) for h in ids]).bytes_


# -- the asset sweep --------------------------------------------------------------


def _cash_world(ns):
    kps = [ns.generate_keypair(seed=200 + i) for i in range(6)]
    issuers = [ns.Party("IssuerA", kps[0].public), ns.Party("IssuerB", kps[1].public)]
    tokens = [ns.Issued(ns.PartyAndReference(issuers[0], b"\x01"), "USD"),
              ns.Issued(ns.PartyAndReference(issuers[0], b"\x02"), "EUR"),
              ns.Issued(ns.PartyAndReference(issuers[1], b"\x01"), "USD")]
    return kps, tokens


def _random_cash_fields(ns, rng):
    """test_batch_verify.py's randomly shaped and corrupted Cash
    transaction, as (commands, input datas, output datas) of ns's
    classes: wrong signers, broken conservation, zero outputs, missing
    issuer signatures on exits and unprocessed extra commands."""
    kps, tokens = _cash_world(ns)
    owners = [kp.public for kp in kps[2:5]]
    inputs, outputs, commands = [], [], []
    for t in rng.sample(range(3), rng.randint(1, 3)):
        token = tokens[t]
        kind = rng.choice(("issue", "move", "exit"))
        issuer = kps[0 if t < 2 else 1].public
        oi = rng.randrange(3)
        owner = owners[oi]
        if kind == "issue":
            outputs += [ns.CashState(ns.Amount(rng.randint(0, 500), token), owner)
                        for _ in range(rng.randint(1, 3))]
            commands.append((ns.CashIssue(rng.randint(0, 9)), [rng.choice((issuer, owner))]))
        elif kind == "move":
            total = rng.randint(2, 1000)
            inputs.append(ns.CashState(ns.Amount(total, token), owner))
            out_total = rng.choice((total, total + 1, total - 1))
            split = rng.randint(0, out_total - 1)
            outs = [split, out_total - split] if split else [out_total]
            outputs += [ns.CashState(ns.Amount(a, token), owners[rng.randrange(3)])
                        for a in outs if a != 0 or rng.random() < 0.3]
            commands.append((ns.CashMove(), [rng.choice((owner, owners[rng.randrange(3)]))]))
        else:
            held = rng.randint(2, 1000)
            inputs.append(ns.CashState(ns.Amount(held, token), owner))
            exited = rng.choice((held, held // 2, held + 1))
            if exited < held:
                outputs.append(ns.CashState(ns.Amount(held - exited, token), owner))
            signers = [owner] + ([issuer] if rng.random() < 0.8 else [])
            commands.append((ns.CashExit(ns.Amount(exited, token)), signers))
    if rng.random() < 0.15:
        commands.append((ns.CashMove(), [owners[rng.randrange(3)]]))
    rng.shuffle(commands)
    cmds = [ns.CommandWithParties(tuple(s), (), v) for v, s in commands]
    return cmds, inputs, outputs


def test_asset_verify_fields_four_ways(ref_lib):
    """600 corrupted Cash transactions built alike in both packages: the
    port's native sweep, its Python sweep and its clause stack, the
    reference's main path and Python sweep, and the reference's C
    library's sweep give the same outcome — the same ContractViolation
    message, or a pass."""
    pc = PORT.contract_by_name(PORT.CASH_CONTRACT)
    rc = REF.contract_by_name(REF.CASH_CONTRACT)

    def outcome(fn):
        try:
            fn()
            return None
        except Exception as e:  # noqa: BLE001 - comparing outcomes
            return (type(e).__name__, str(e))

    seen = set()
    for i in range(600):
        pf = _random_cash_fields(PORT, random.Random(i))
        rf = _random_cash_fields(REF, random.Random(i))
        want = outcome(lambda: pc.verify_fields_py(*pf))
        assert outcome(lambda: pc.verify_fields(*pf)) == want, i
        assert outcome(lambda: rc.verify_fields_py(*rf)) == want, i
        assert outcome(lambda: rc.verify_fields(*rf)) == want, i
        assert outcome(lambda: ref_lib.asset_verify_fields(
            *rf, rc.state_class, rc.issue_cmd, rc.move_cmd, rc.exit_cmd, None,
            rasset.signed_by, REF.ContractViolation)) == want, i
        seen.add(None if want is None else want[1])
    assert None in seen and len(seen) > 4


# -- the library itself --------------------------------------------------------------


_TWO_LIBRARIES = r"""
import importlib.util, sys
sys.path.insert(0, sys.argv[1])
order, ref_path = sys.argv[2], sys.argv[3]

def load_ref():
    import corda_tpu.core.serialization as rser
    spec = importlib.util.spec_from_file_location("corda_tpu.native._cts_hash", ref_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cts_configure(rser.SerializationError, rser._CLASS_ENC_CACHE, rser._class_enc_info,
                      rser._REGISTRY_BY_TAG, rser._CUSTOM_DEC, rser._construct_pretuplified,
                      rser._unknown_tag_handler, rser._varint_abs)
    return mod

def load_port():
    import corda_tpu_torch.core.serialization as pser
    pser.encode(None)   # builds, loads and configures the port's library
    return pser._NATIVE_CODEC

libs = {}
for which in order.split(","):
    libs[which] = load_ref() if which == "ref" else load_port()
assert libs["ref"] is not libs["port"]
import corda_tpu.finance.cash as rc, corda_tpu.core.contracts as rk
import corda_tpu_torch.finance.cash as pc, corda_tpu_torch.core.contracts as pk
from corda_tpu.crypto.hashes import SecureHash as RH
from corda_tpu_torch.crypto.hashes import SecureHash as PH
pv = pk.StateRef(PH.sha256(b"x"), 3)
rv = rk.StateRef(RH.sha256(b"x"), 3)
pb, rb = libs["port"].cts_encode(pv), libs["ref"].cts_encode(rv)
assert pb == rb
assert type(libs["port"].cts_decode(pb)) is pk.StateRef
assert type(libs["ref"].cts_decode(pb)) is rk.StateRef
assert type(libs["port"].cts_decode(pb).txhash) is PH
print("ok", order)
"""


@pytest.mark.parametrize("order", ["port,ref", "ref,port"])
def test_two_libraries_in_one_process(order, ref_lib):
    """The port's library and the reference's, loaded into one fresh
    interpreter in either order with the default dlopen flags: each
    keeps its own codec configuration, so each decodes into its own
    package's classes, and equal values encode to equal bytes."""
    ref_path = str(nbuild.library_path(REF_SOURCE))
    out = subprocess.run([sys.executable, "-c", _TWO_LIBRARIES, str(ROOT), order, ref_path],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["ok", order]


def test_library_reports_abi_and_sha_ni(port_lib):
    assert port_lib.cts_abi == 2 and port_lib.sha_ni in (0, 1)
    info = native.build_info()
    assert info.path == nbuild.library_path() and info.path.exists()
    assert info.path.parent == ROOT / "build" / "corda_tpu_torch"


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile, or no g++ at all, raises
    NativeBuildError; nothing falls back to the Python codec."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        nbuild.build(bad)
    assert not nbuild.library_path(bad).exists()
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ not found"):
        nbuild.build()


def test_codec_does_not_fall_back(monkeypatch):
    """With the library not yet loaded and its build failing, encode and
    decode raise NativeBuildError instead of running the Python codec."""
    def refuse(source=nbuild.SOURCE):
        raise native.NativeBuildError("refused")

    monkeypatch.setattr(native, "_MOD", None)
    monkeypatch.setattr(pser, "_NATIVE_CODEC", None)
    monkeypatch.setattr(nbuild, "build", refuse)
    for fn in (lambda: pser.encode(1), lambda: pser.decode(b"\x00"),
               lambda: phashes.sha256_many([b""]),
               lambda: pmerkle.merkle_root([PORT.SecureHash.sha256(b"")])):
        with pytest.raises(native.NativeBuildError):
            fn()
