"""Generator combinators + the random transaction-graph fuzzer.

Port of corda_tpu/testing/generators.py: the same draws for the same
`random.Random` seed, so a seed gives the same parties, transaction ids
and signature bytes in both packages.

Reference: the `Generator` combinator library (client/mock/ — random
tx/event generation for loadtest and the explorer simulation) and
`GeneratedLedger` (verifier/src/integration-test/.../GeneratedLedger.kt
— a property-based random transaction-graph generator: issuance / move
/ exit over random states signed with random-scheme keys, used to fuzz
the out-of-process verifier with 100-tx ledgers, VerifierTests.kt:24-34).

Here the fuzzer doubles as the CPU-vs-card bit-exactness instrument:
generated ledgers, mutated (corrupted) transactions included, must
verify identically through CpuBatchVerifier and CudaBatchVerifier.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Iterable, Optional

from ..core.contracts import Amount, Issued, StateAndRef, StateRef
from ..core.identity import Party, PartyAndReference
from ..core.transactions import SignedTransaction, TransactionBuilder
from ..crypto import schemes
from ..finance.cash import (
    CASH_CONTRACT,
    CashExit,
    CashIssue,
    CashMove,
    CashState,
)


# ---------------------------------------------------------------------------
# combinators (client/mock/Generator.kt)


class Generator:
    """A deterministic random-value recipe: `generate(rng)` draws one
    value. Composes with map/flat_map/choice/frequency like the
    reference's monadic Generator."""

    def __init__(self, fn: Callable[[random.Random], Any]):
        self._fn = fn

    def generate(self, rng: random.Random) -> Any:
        return self._fn(rng)

    # -- composition ---------------------------------------------------------

    @staticmethod
    def pure(value: Any) -> "Generator":
        return Generator(lambda rng: value)

    def map(self, f: Callable[[Any], Any]) -> "Generator":
        return Generator(lambda rng: f(self.generate(rng)))

    def flat_map(self, f: Callable[[Any], "Generator"]) -> "Generator":
        return Generator(lambda rng: f(self.generate(rng)).generate(rng))

    @staticmethod
    def combine(*gens: "Generator", f: Callable = lambda *xs: xs) -> "Generator":
        return Generator(lambda rng: f(*(g.generate(rng) for g in gens)))

    # -- primitives ----------------------------------------------------------

    @staticmethod
    def int_range(lo: int, hi: int) -> "Generator":
        """Uniform integer in [lo, hi] inclusive."""
        return Generator(lambda rng: rng.randint(lo, hi))

    @staticmethod
    def bytes_of(n: int) -> "Generator":
        return Generator(lambda rng: rng.getrandbits(8 * n).to_bytes(n, "big"))

    @staticmethod
    def sampled_from(items: Iterable[Any]) -> "Generator":
        items = list(items)
        return Generator(lambda rng: items[rng.randrange(len(items))])

    @staticmethod
    def choice(gens: Iterable["Generator"]) -> "Generator":
        gens = list(gens)
        return Generator(
            lambda rng: gens[rng.randrange(len(gens))].generate(rng)
        )

    @staticmethod
    def frequency(weighted: Iterable[tuple[int, "Generator"]]) -> "Generator":
        weighted = list(weighted)
        total = sum(w for w, _ in weighted)

        def draw(rng: random.Random):
            roll = rng.randrange(total)
            acc = 0
            for w, g in weighted:
                acc += w
                if roll < acc:
                    return g.generate(rng)
            raise AssertionError("unreachable")

        return Generator(draw)

    def list_of(self, count) -> "Generator":
        count_gen = (
            count if isinstance(count, Generator) else Generator.pure(count)
        )

        def draw(rng: random.Random):
            return [
                self.generate(rng) for _ in range(count_gen.generate(rng))
            ]

        return Generator(draw)


# ---------------------------------------------------------------------------
# the ledger fuzzer (GeneratedLedger.kt)

BATCHABLE_SCHEMES = (
    schemes.EDDSA_ED25519_SHA512,
    schemes.ECDSA_SECP256K1_SHA256,
    schemes.ECDSA_SECP256R1_SHA256,
)


class GeneratedLedger:
    """A random but VALID transaction graph over the Cash contract:
    issuances create value, moves shuffle ownership (conserving),
    exits destroy value — every transaction properly signed by keys
    drawn from all three batchable schemes. `transactions` is in
    topological (generation) order; `store` resolves by id."""

    def __init__(self, seed: int = 0, n_parties: int = 6, notary_scheme=None):
        self.rng = random.Random(seed)
        self.parties: list[tuple[Party, schemes.KeyPair]] = []
        for i in range(n_parties):
            scheme = BATCHABLE_SCHEMES[i % len(BATCHABLE_SCHEMES)]
            kp = schemes.generate_keypair(
                scheme, seed=self.rng.getrandbits(128)
            )
            self.parties.append((Party(f"P{i}", kp.public), kp))
        nkp = schemes.generate_keypair(
            notary_scheme or schemes.EDDSA_ED25519_SHA512,
            seed=self.rng.getrandbits(128),
        )
        self.notary = Party("GenNotary", nkp.public)
        self.notary_kp = nkp
        self.transactions: list[SignedTransaction] = []
        self.store: dict = {}
        # unspent: StateAndRef list (all CashState)
        self.unspent: list[StateAndRef] = []

    # -- steps ---------------------------------------------------------------

    def _keypair_of(self, key) -> schemes.KeyPair:
        for p, kp in self.parties:
            if p.owning_key == key:
                return kp
        raise KeyError("unknown owner key")

    def _record(self, stx: SignedTransaction) -> SignedTransaction:
        self.transactions.append(stx)
        self.store[stx.id] = stx
        for ref in stx.wtx.inputs:
            self.unspent = [s for s in self.unspent if s.ref != ref]
        for i, ts in enumerate(stx.wtx.outputs):
            if isinstance(ts.data, CashState):
                self.unspent.append(StateAndRef(ts, StateRef(stx.id, i)))
        return stx

    def issue(self) -> SignedTransaction:
        issuer, issuer_kp = self.parties[
            self.rng.randrange(len(self.parties))
        ]
        owner, _ = self.parties[self.rng.randrange(len(self.parties))]
        token = Issued(
            PartyAndReference(issuer, bytes([self.rng.randrange(1, 4)])),
            self.rng.choice(["USD", "EUR", "GBP"]),
        )
        qty = self.rng.randint(1, 10_000)
        b = TransactionBuilder(self.notary)
        b.add_output_state(
            CashState(Amount(qty, token), owner.owning_key), CASH_CONTRACT
        )
        b.add_command(CashIssue(self.rng.getrandbits(32)), issuer.owning_key)
        wtx = b.to_wire_transaction()
        sig = _sign(issuer_kp, wtx.id)
        return self._record(SignedTransaction(wtx, (sig,)))

    def move(self) -> Optional[SignedTransaction]:
        if not self.unspent:
            return None
        k = self.rng.randint(1, min(3, len(self.unspent)))
        picked = self.rng.sample(self.unspent, k)
        b = TransactionBuilder(self.notary)
        signers = []
        by_token: dict = {}
        for sar in picked:
            b.add_input_state(sar)
            data = sar.state.data
            by_token[data.amount.token] = (
                by_token.get(data.amount.token, 0) + data.amount.quantity
            )
            signers.append(data.owner)
        for token, total in sorted(
            by_token.items(), key=lambda kv: str(kv[0])
        ):
            # split into 1-2 outputs to random owners, conserving
            split = (
                [total]
                if total < 2 or self.rng.random() < 0.5
                else [total // 2, total - total // 2]
            )
            for part in split:
                owner, _ = self.parties[self.rng.randrange(len(self.parties))]
                b.add_output_state(
                    CashState(Amount(part, token), owner.owning_key),
                    CASH_CONTRACT,
                )
        b.add_command(CashMove(), *dict.fromkeys(signers))
        wtx = b.to_wire_transaction()
        sigs = tuple(
            _sign(self._keypair_of(key), wtx.id)
            for key in dict.fromkeys(signers)
        )
        return self._record(SignedTransaction(wtx, sigs))

    def exit(self) -> Optional[SignedTransaction]:
        # exits need issuer signature AND owner signature; pick a state
        # and have both sign (issuer may differ from owner)
        if not self.unspent:
            return None
        sar = self.rng.choice(self.unspent)
        data = sar.state.data
        b = TransactionBuilder(self.notary)
        b.add_input_state(sar)
        exit_qty = self.rng.randint(1, data.amount.quantity)
        change = data.amount.quantity - exit_qty
        if change:
            b.add_output_state(
                CashState(Amount(change, data.amount.token), data.owner),
                CASH_CONTRACT,
            )
        issuer_key = data.issuer.owning_key
        b.add_command(
            CashExit(Amount(exit_qty, data.amount.token)),
            issuer_key,
            data.owner,
        )
        wtx = b.to_wire_transaction()
        keys = list(dict.fromkeys([issuer_key, data.owner]))
        sigs = tuple(_sign(self._keypair_of(k), wtx.id) for k in keys)
        return self._record(SignedTransaction(wtx, sigs))

    def grow(self, n: int) -> "GeneratedLedger":
        """Generate n transactions (issuance-weighted early, like the
        reference's 100-tx ledgers)."""
        while len(self.transactions) < n:
            if not self.unspent or self.rng.random() < 0.35:
                self.issue()
            elif self.rng.random() < 0.85:
                self.move()
            else:
                self.exit()
        return self

    # -- resolution (what the verifier needs) --------------------------------

    def resolve(self, wtx) -> "Any":
        """WireTransaction -> LedgerTransaction against this ledger."""
        from ..core.contracts import CommandWithParties, StateAndRef
        from ..core.transactions import LedgerTransaction

        inputs = []
        for ref in wtx.inputs:
            stx = self.store[ref.txhash]
            inputs.append(
                StateAndRef(stx.wtx.outputs[ref.index], ref)
            )
        commands = tuple(
            CommandWithParties(c.signers, (), c.value) for c in wtx.commands
        )
        return LedgerTransaction(
            tuple(inputs), wtx.outputs, commands, (), wtx.notary,
            wtx.time_window, wtx.id,
        )

    def all_signatures(self):
        """[(pubkey, signature, signed-payload-bytes)] for every sig in
        the ledger — the batch-verifier fuzz corpus."""
        out = []
        for stx in self.transactions:
            for sig in stx.sigs:
                out.append(
                    (sig.by, sig.signature, sig.signable_payload(stx.id))
                )
        return out


def _sign(kp: schemes.KeyPair, tx_id):
    from ..crypto.tx_signature import sign_tx_id

    return sign_tx_id(kp.private, tx_id)
