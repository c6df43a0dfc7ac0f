"""The port's canonical codec against the reference's: a table of values
built independently in both packages from the same seeded keys encodes
to identical bytes; the port decodes the reference's bytes and encodes
them again identically; Merkle roots and single-leaf proofs are equal.
Equality of bytes is the tolerance (the encoding is consensus-critical:
transaction ids and signed payloads are hashes of it)."""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import corda_tpu.core.serialization as rser  # noqa: E402
import corda_tpu_torch.core.serialization as pser  # noqa: E402

# the wire classes register on import, in both packages
import corda_tpu.finance.cash  # noqa: E402,F401
import corda_tpu_torch.finance.cash  # noqa: E402,F401


def _ns(pkg: str) -> SimpleNamespace:
    """The ledger classes of one package, by the reference's names."""
    mods = {
        name: importlib.import_module(f"{pkg}.{name}")
        for name in ("core.contracts", "core.identity", "core.transactions",
                     "crypto.schemes", "crypto.hashes", "crypto.merkle",
                     "finance.cash", "core.serialization")
    }
    ns = SimpleNamespace(ser=mods["core.serialization"])
    for mod in mods.values():
        for k, v in vars(mod).items():
            if not k.startswith("_"):
                setattr(ns, k, v)
    return ns


REF, PORT = _ns("corda_tpu"), _ns("corda_tpu_torch")


def _values(ns) -> list:
    """(name, value) rows, built from ns's own classes and seeded keys."""
    ed = ns.generate_keypair(ns.EDDSA_ED25519_SHA512, seed=11)
    p256 = ns.generate_keypair(ns.ECDSA_SECP256R1_SHA256, seed=12)
    bank = ns.Party("Bank", ed.public)
    notary = ns.Party("Notary", ns.generate_keypair(ns.EDDSA_ED25519_SHA512, seed=13).public)
    token = ns.Issued(ns.PartyAndReference(bank, b"\x01\x02"), "GBP")
    h = ns.SecureHash.sha256(b"corda")
    ref = ns.StateRef(h, 3)
    cash = ns.CashState(ns.Amount(12_345, token), p256.public)
    b = ns.TransactionBuilder(notary)
    b.add_input_state(ns.StateAndRef(ns.TransactionState(cash, ns.CASH_CONTRACT, notary), ref))
    b.add_output_state(ns.CashState(ns.Amount(12_000, token), ed.public), ns.CASH_CONTRACT)
    b.add_output_state(ns.CashState(ns.Amount(345, token), p256.public), ns.CASH_CONTRACT)
    b.add_command(ns.CashMove(), p256.public)
    b.set_time_window(ns.TimeWindow.between(1_700_000_000_000_000, 1_700_000_060_000_000))
    wtx = b.to_wire_transaction()
    rng = random.Random(7)
    nested = [rng.getrandbits(70) - 2**69 for _ in range(8)]
    return [
        ("none-bools", [None, True, False]),
        ("ints", [0, 1, 127, 128, 300, 2**64, -1, -(2**70), 2**255 - 19]),
        ("bytes", [b"", b"\x00", bytes(range(256))]),
        ("str", ["", "notary", "Zürich ✓"]),
        ("nested", [nested, [[1, [2, [3, b"x"]]], ()], {"k": [1, 2]}]),
        ("map", {"b": 1, "a": [2], 3: "c", b"\x01": None, -4: {"z": 0, "y": 1}}),
        ("frozenset", frozenset({3, 1, 2, "x", b"y"})),
        ("StateRef", ref),
        ("Amount", ns.Amount(10**20, token)),
        ("Party", bank),
        ("PublicKey-p256", p256.public),
        ("CashState", cash),
        ("CashIssue", ns.CashIssue(5)),
        ("WireTransaction", wtx),
        ("SignedTransaction", ns.SignedTransaction(wtx, (ns.sign_tx_id(ed.private, wtx.id),))),
    ]


ROWS = [name for name, _ in _values(PORT)]


@pytest.mark.parametrize("i", range(len(ROWS)), ids=ROWS)
def test_value_encodes_to_identical_bytes(i):
    (_, want), (_, got) = _values(REF)[i], _values(PORT)[i]
    assert pser.encode(got) == rser.encode(want)


@pytest.mark.parametrize("i", range(len(ROWS)), ids=ROWS)
def test_port_decodes_reference_bytes_and_reencodes_them(i):
    data = rser.encode(_values(REF)[i][1])
    value = pser.decode(data)
    assert pser.encode(value) == data
    if hasattr(value, "id"):   # a transaction: the same id on both sides
        assert value.id.bytes_ == rser.decode(data).id.bytes_


def test_reference_decodes_port_bytes():
    for name, value in _values(PORT):
        data = pser.encode(value)
        assert rser.encode(rser.decode(data)) == data, name


def test_codec_rejects_what_the_reference_rejects():
    for bad in (b"", b"\x07\x02\x00", b"\x03\x80\x00", b"\x09\x03Foo\x00", b"\x00\x00", b"\xff"):
        with pytest.raises(rser.SerializationError):
            rser.decode_py(bad)
        with pytest.raises(pser.SerializationError):
            pser.decode(bad)
    with pytest.raises(pser.SerializationError):
        pser.encode({1, 2})   # a set has no canonical order
    with pytest.raises(pser.SerializationError):
        pser.serializable(type("StateRef", (), {}))   # a second class, one tag


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 33])
def test_merkle_root_and_single_leaf_proofs_equal(n):
    rng = random.Random(n)
    digests = [rng.randbytes(32) for _ in range(n)]
    r_leaves = [REF.SecureHash(d) for d in digests]
    p_leaves = [PORT.SecureHash(d) for d in digests]
    assert PORT.merkle_root(p_leaves).bytes_ == REF.merkle_root(r_leaves).bytes_
    r_root, r_proofs = REF.single_leaf_proofs(r_leaves)
    p_root, p_proofs = PORT.single_leaf_proofs(p_leaves)
    assert p_root.bytes_ == r_root.bytes_
    assert [pser.encode(p) for p in p_proofs] == [rser.encode(p) for p in r_proofs]
    for leaf, proof in zip(p_leaves, p_proofs):
        assert proof.verify(p_root, [leaf])
        assert not proof.verify(p_root, [PORT.SecureHash.zero()])
    some = p_leaves[: max(1, n // 2)]
    pmt = PORT.PartialMerkleTree.build(p_leaves, some)
    ref_pmt = REF.PartialMerkleTree.build(r_leaves, r_leaves[: max(1, n // 2)])
    assert pser.encode(pmt) == rser.encode(ref_pmt)
    assert pmt.verify(p_root, some)
