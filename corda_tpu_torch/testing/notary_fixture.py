"""A seeded batching-notary workload: single-input Cash spends, each with
the answer the notary must give it.

`build_fixture(n, seed)` issues one Cash state per spend (issue
transactions carry `outputs_per_issue` outputs each, so spends dominate
the signing) and builds the spends in flush order:

  * 3 of every 4 spend signers hold ed25519 keys (Corda's default
    scheme), 1 in 4 hold p256 keys;
  * 1 in `bad_every` spends carries a flipped signature byte
    (label "invalid-signature");
  * 1 in `bad_every` spends double-spends the input of the spend just
    before it, which wins (label "conflict": the first spend wins);
  * 1 in `wrong_notary_every` spends names another notary
    (label "wrong-notary"); every other spend is "ok".

Signing uses OpenSSL where the `cryptography` package imports, else a
pool of `workers` spawned processes over the port's pure-Python
signers; both are deterministic (ed25519 by definition, ECDSA by RFC
6979 in the port), so a seed gives the same spends everywhere but for
OpenSSL's random ECDSA nonces.

`notary_hub(fixture, verifier)` is the notary's ServiceHub: its key,
the parties, and every issue transaction recorded. `answer_kind` maps a
notary answer to the label it must equal.

`build_scheme_fixture(fixture, rsa, sphincs)` adds, to the first
`base` spends of a fixture, spends that need every path of the
notary's verification: an added RSA or SPHINCS signature (verified on
the host, as in the reference), one of each flipped, and spends whose
output contract travels only as an attachment (MAGIC_SOURCE, run in
the sandbox), one that satisfies it and one that breaks it.
"""

from __future__ import annotations

import multiprocessing
import os
import random
import time
from dataclasses import dataclass

from ..core.contracts import Amount, Issued, StateAndRef, StateRef
from ..core.identity import Party, PartyAndReference
from ..core.transactions import SignedTransaction, TransactionBuilder
from ..crypto import schemes
from ..crypto.tx_signature import (
    PLATFORM_VERSION,
    SignatureMetadata,
    TransactionSignature,
    signable_bytes,
)
from ..finance.cash import CASH_CONTRACT, CashIssue, CashMove, CashState

@dataclass
class NotaryFixture:
    notary_key: schemes.KeyPair
    notary: Party
    other_notary: Party
    bank: Party
    requester: Party
    issues: list            # [SignedTransaction], to record on the notary
    spends: list            # [SignedTransaction], in flush order
    labels: list            # the answer each spend must get (module docstring)
    build_seconds: float
    openssl: bool
    owners: list            # [KeyPair] signing each spend


def _label(i: int, bad_every: int, wrong_notary_every: int) -> str:
    """The label of spend i. Spend i's signer is p256 where i % 4 == 3:
    the flipped signatures alternate between an ed25519 signer (even
    blocks) and a p256 one (odd blocks); a conflict's earlier spend,
    i - 1, is always "ok"."""
    if i % wrong_notary_every == wrong_notary_every - 1:
        return "wrong-notary"
    q = bad_every // 4
    if i % bad_every == (q + (3 - q) % 4 if i // bad_every % 2 else q):
        return "invalid-signature"
    if i % bad_every == 3 * bad_every // 4 + 1:
        return "conflict"
    return "ok"


def _sign_rows(rows) -> list:
    """[(scheme_id, private bytes, public bytes, payload)] -> signatures
    (a pool worker's unit of work)."""
    out = []
    for sid, priv, pub, payload in rows:
        key = schemes.PrivateKey(sid, priv, schemes.PublicKey(sid, pub))
        out.append(schemes.sign(key, payload))
    return out


def _sign_all(rows, workers: int) -> list:
    if schemes._HAVE_OPENSSL or workers <= 1 or len(rows) < 64:
        return _sign_rows(rows)
    step = -(-len(rows) // (4 * workers))
    parts = [rows[k : k + step] for k in range(0, len(rows), step)]
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        signed = pool.map(_sign_rows, parts)
    return [s for part in signed for s in part]


def build_fixture(
    n: int,
    seed: int = 5,
    outputs_per_issue: int = 64,
    bad_every: int = 64,
    wrong_notary_every: int = 256,
    owners_per_scheme: int = 16,
    workers: int = 0,
) -> NotaryFixture:
    """`n` spends in flush order with their labels (module docstring);
    `workers` = 0 takes os.cpu_count() for the pure-Python signers."""
    if bad_every < 8 or bad_every % 4:
        raise ValueError("bad_every must be a multiple of 4, at least 8")
    t0 = time.perf_counter()
    rng = random.Random(seed)

    def keypair(scheme_id):
        return schemes.generate_keypair(scheme_id, seed=rng.getrandbits(255))

    notary_key, other_key, bank_key, req_key = (
        keypair(schemes.EDDSA_ED25519_SHA512) for _ in range(4)
    )
    notary = Party("Notary", notary_key.public)
    other_notary = Party("OtherNotary", other_key.public)
    bank = Party("Bank", bank_key.public)
    requester = Party("Alice", req_key.public)
    owners = {
        sid: [keypair(sid) for _ in range(owners_per_scheme)]
        for sid in (schemes.EDDSA_ED25519_SHA512, schemes.ECDSA_SECP256R1_SHA256)
    }
    token = Issued(PartyAndReference(bank, b"\x01"), "USD")
    labels = [_label(i, bad_every, wrong_notary_every) for i in range(n)]

    def owner_of(i):
        sid = (schemes.ECDSA_SECP256R1_SHA256 if i % 4 == 3
               else schemes.EDDSA_ED25519_SHA512)
        return owners[sid][(i // 4) % owners_per_scheme]

    # one issued state per spend but the conflicts, which reuse the
    # state of the spend before them
    fresh = [i for i in range(n) if labels[i] != "conflict"]
    issues, state_of = [], {}
    for g in range(0, len(fresh), outputs_per_issue):
        group = fresh[g : g + outputs_per_issue]
        ib = TransactionBuilder(notary)
        for i in group:
            ib.add_output_state(
                CashState(Amount(100, token), owner_of(i).public),
                CASH_CONTRACT,
                other_notary if labels[i] == "wrong-notary" else notary,
            )
        ib.add_command(CashIssue(g // outputs_per_issue), bank.owning_key)
        issue = ib.sign_initial_transaction(bank_key.private)
        issues.append(issue)
        for j, i in enumerate(group):
            state_of[i] = StateAndRef(issue.wtx.outputs[j], StateRef(issue.id, j))

    wtxs, rows, signers = [], [], []
    for i in range(n):
        spent = i - 1 if labels[i] == "conflict" else i
        owner = owner_of(spent)
        sar = state_of[spent]
        sb = TransactionBuilder()
        sb.add_input_state(sar)
        # the conflict pays someone else: a different transaction
        payee = requester if labels[i] == "conflict" else bank
        sb.add_output_state(CashState(Amount(100, token), payee.owning_key), CASH_CONTRACT)
        sb.add_command(CashMove(), owner.public)
        wtx = sb.to_wire_transaction()
        meta = SignatureMetadata(PLATFORM_VERSION, owner.public.scheme_id)
        wtxs.append((wtx, meta))
        signers.append(owner)
        rows.append((owner.public.scheme_id, owner.private.data, owner.public.data,
                     signable_bytes(wtx.id, meta)))
    sigs = _sign_all(rows, workers or os.cpu_count() or 1)
    spends = []
    for i, ((wtx, meta), owner, sig) in enumerate(zip(wtxs, signers, sigs)):
        if labels[i] == "invalid-signature":
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        spends.append(SignedTransaction(wtx, (TransactionSignature(sig, owner.public, meta),)))
    return NotaryFixture(
        notary_key, notary, other_notary, bank, requester, issues, spends,
        labels, time.perf_counter() - t0, schemes._HAVE_OPENSSL, signers,
    )


# A contract that exists only as attachment source: no process registers
# it, so the notary loads it from the spend's attachment into the sandbox.
# It names the platform API by the reference's module names, so the same
# attachment bytes (and transaction ids) serve both packages.
MAGIC_CONTRACT = "demo.magic"
MAGIC_SOURCE = """
from corda_tpu.finance.cash import CashState

class MagicContract:
    \"\"\"Cash under a cap: no output of this contract holds more than 50.\"\"\"

    def verify(self, ltx):
        for ts in ltx.outputs:
            if ts.contract == "demo.magic" and ts.data.amount.quantity > 50:
                raise ContractViolation("magic output exceeds its cap of 50")
"""


@dataclass
class SchemeFixture:
    spends: list            # [SignedTransaction], in flush order
    labels: list
    attachments: list       # [bytes] the notary must hold
    kinds: list             # what each spend exercises ("base", "rsa", ...)


def _signature(key: schemes.KeyPair, tx_id) -> TransactionSignature:
    meta = SignatureMetadata(PLATFORM_VERSION, key.public.scheme_id)
    return TransactionSignature(
        schemes.sign(key.private, signable_bytes(tx_id, meta)), key.public, meta
    )


def _flipped(sig: TransactionSignature) -> TransactionSignature:
    b = sig.signature
    return TransactionSignature(b[:-1] + bytes([b[-1] ^ 1]), sig.by, sig.metadata)


def build_scheme_fixture(
    fixture: NotaryFixture,
    rsa: schemes.KeyPair,
    sphincs: schemes.KeyPair,
    base: int = 64,
) -> SchemeFixture:
    """The first `base` spends of `fixture` with their labels, then, from
    its later "ok" spends: two with an added RSA signature and one with
    it flipped, the same for SPHINCS, and two spends that pay their Cash
    to outputs under MAGIC_CONTRACT (50 + 50: ok; 60 + 40: the contract
    breaks, "invalid-transaction"), the contract travelling as the
    spend's attachment."""
    from ..core.sandbox import make_contract_attachment

    spends = list(fixture.spends[:base])
    labels = list(fixture.labels[:base])
    kinds = ["base"] * base
    # an "ok" spend owns its input: no spend of the first `base` reuses it
    spare = [i for i in range(base, len(fixture.spends)) if fixture.labels[i] == "ok"]
    if len(spare) < 8:
        raise ValueError("the fixture has too few spare ok spends")
    picks = iter(spare)
    for kind, key in (("rsa", rsa), ("sphincs", sphincs)):
        for label in ("ok", "ok", "invalid-signature"):
            stx = fixture.spends[next(picks)]
            sig = _signature(key, stx.id)
            if label != "ok":
                sig = _flipped(sig)
            spends.append(stx.with_additional_signature(sig))
            labels.append(label)
            kinds.append(kind)
    att = make_contract_attachment(MAGIC_CONTRACT, "MagicContract", MAGIC_SOURCE)
    issued = {issue.id: issue for issue in fixture.issues}
    for label, split in (("ok", (50, 50)), ("invalid-transaction", (60, 40))):
        i = next(picks)
        ref = fixture.spends[i].wtx.inputs[0]
        sar = StateAndRef(issued[ref.txhash].wtx.outputs[ref.index], ref)
        token = sar.state.data.amount.token
        owner = fixture.owners[i]
        sb = TransactionBuilder()
        sb.add_input_state(sar)
        for q in split:
            sb.add_output_state(CashState(Amount(q, token), fixture.bank.owning_key),
                                MAGIC_CONTRACT)
        sb.add_command(CashMove(), owner.public)
        sb.add_attachment(att.id)
        wtx = sb.to_wire_transaction()
        spends.append(SignedTransaction(wtx, (_signature(owner, wtx.id),)))
        labels.append(label)
        kinds.append("attachment")
    return SchemeFixture(spends, labels, [att.data], kinds)


def notary_hub(fixture: NotaryFixture, verifier):
    """The notary's ServiceHub over `verifier`, with every issue
    transaction of the fixture recorded."""
    from ..node.services import IdentityService, KeyManagementService, NodeInfo, ServiceHub

    hub = ServiceHub(
        NodeInfo("Notary", fixture.notary),
        KeyManagementService(fixture.notary_key),
        IdentityService(fixture.notary, fixture.other_notary, fixture.bank,
                        fixture.requester),
        batch_verifier=verifier,
    )
    hub.record_transactions(fixture.issues)
    return hub


def answer_kind(answer) -> str:
    """The label a notary answer stands for: "ok" for a notary
    signature, else the NotaryError's kind ("invalid-signature" for an
    invalid transaction whose signature check failed)."""
    kind = getattr(answer, "kind", None)
    if kind is None and hasattr(answer, "partial_merkle"):
        return "ok"   # a TransactionSignature (of either package)
    if kind == "invalid-transaction" and "invalid signature" in answer.message:
        return "invalid-signature"
    return kind if kind is not None else repr(answer)
