"""The Generator combinators and GeneratedLedger (testing/generators.py) in
the port, held against the reference.

The reference's non-slow cases of tests/test_generators.py run on the
port with their imports read as corda_tpu_torch
(test_torch_persistence.port_module). For seeds 3, 7 and 11 the
Generator draws equal the reference's, and the port's ledger equals the
reference's: the same parties, transaction ids, signer keys and signed
payloads, and the same ed25519 signature bytes. ECDSA signing draws its
nonce from the OS in both packages (OpenSSL through `cryptography`), so
two runs of one package already differ there: each package's
CpuBatchVerifier accepts the other's ECDSA signatures instead. The
reference's mutated corpus (seed 13, 30 transactions, the one its slow
card test uses) is built by chip_smoke.mutated_corpus with its labels:
the same keys, payloads and mutations as the reference test's
`_mutated_corpus` (the reference's CpuBatchVerifier gives its rows the
labels), and the verdicts on the port's rows from the port's
CpuBatchVerifier, the reference's CpuBatchVerifier and the port's
CudaBatchVerifier(device="cpu") (the kernels' plain torch versions) all
equal the labels.
"""

from __future__ import annotations

import random
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_torch_chip_smoke import one_thread  # noqa: E402,F401 - a fixture
from test_torch_persistence import port_module, reference_module  # noqa: E402

SEEDS = (3, 7, 11)
CASES = ("test_combinator_determinism", "test_combinator_flat_map_and_combine",
         "test_generated_ledger_is_valid", "test_generated_ledger_deterministic",
         "test_mutated_corpus_cpu_reference")


def test_cases_are_the_reference_non_slow_ones():
    mod = reference_module("test_generators")
    names = {n for n, fn in vars(mod).items() if n.startswith("test_") and callable(fn)
             and not any(m.name == "slow" for m in getattr(fn, "pytestmark", []))}
    assert names == set(CASES)


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case):
    mod = port_module("test_generators")
    assert mod.GeneratedLedger.__module__ == "corda_tpu_torch.testing.generators"
    getattr(mod, case)()


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_draws_equal_the_reference(seed):
    from corda_tpu.testing.generators import Generator as Ref
    from corda_tpu_torch.testing.generators import Generator as Port

    def recipe(G):
        return G.frequency([
            (3, G.int_range(0, 99)),
            (2, G.bytes_of(5)),
            (1, G.sampled_from("xyz").flat_map(lambda c: G.pure(c * 2))),
        ]).list_of(G.int_range(10, 20))

    assert recipe(Port).generate(random.Random(seed)) == recipe(Ref).generate(random.Random(seed))


def _rows(reqs) -> list:
    return [(r.key.scheme_id, bytes(r.key.data), bytes(r.signature), bytes(r.message))
            for r in reqs]


def _ref_requests(rows) -> list:
    from corda_tpu.crypto.batch_verifier import VerificationRequest
    from corda_tpu.crypto.schemes import PublicKey

    return [VerificationRequest(PublicKey(k, d), s, m) for k, d, s, m in rows]


def _port_requests(rows) -> list:
    from corda_tpu_torch.crypto.batch_verifier import VerificationRequest
    from corda_tpu_torch.crypto.schemes import PublicKey

    return [VerificationRequest(PublicKey(k, d), s, m) for k, d, s, m in rows]


def _same_but_ecdsa_signatures(mine: list, theirs: list) -> None:
    from corda_tpu_torch.crypto.schemes import EDDSA_ED25519_SHA512 as ED

    assert [(k, d, m) for k, d, _, m in mine] == [(k, d, m) for k, d, _, m in theirs]
    assert [s for k, _, s, _ in mine if k == ED] == [s for k, _, s, _ in theirs if k == ED]


@pytest.mark.parametrize("seed", SEEDS)
def test_ledger_equals_the_reference(seed):
    from corda_tpu.crypto.batch_verifier import CpuBatchVerifier as RefCpu
    from corda_tpu.testing.generators import GeneratedLedger as Ref
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing.generators import GeneratedLedger as Port

    ref, port = Ref(seed=seed).grow(40), Port(seed=seed).grow(40)
    assert [str(t.id) for t in port.transactions] == [str(t.id) for t in ref.transactions]
    assert [(p.name, bytes(p.owning_key.data)) for p, _ in port.parties] == [
        (p.name, bytes(p.owning_key.data)) for p, _ in ref.parties]

    def rows(ledger):
        return [(pub.scheme_id, bytes(pub.data), bytes(sig), bytes(payload))
                for pub, sig, payload in ledger.all_signatures()]

    mine, theirs = rows(port), rows(ref)
    _same_but_ecdsa_signatures(mine, theirs)
    assert len({k for k, *_ in mine}) == 3
    assert all(RefCpu().verify_batch(_ref_requests(mine)))
    assert all(CpuBatchVerifier().verify_batch(_port_requests(theirs)))


def test_mutated_corpus_verdicts_equal_the_labels(one_thread):
    import chip_smoke as cs
    from corda_tpu.crypto.batch_verifier import CpuBatchVerifier as RefCpu
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier, CudaBatchVerifier

    seed, n_txs = cs.FUZZ_CORPUS
    reqs, labels = cs.mutated_corpus(seed, n_txs)
    ref_reqs = reference_module("test_generators")._mutated_corpus(seed=seed, n_txs=n_txs)
    _same_but_ecdsa_signatures(_rows(reqs), _rows(ref_reqs))
    assert any(labels) and not all(labels)
    assert {r.key.scheme_id for r in reqs} == {
        schemes.EDDSA_ED25519_SHA512, schemes.ECDSA_SECP256K1_SHA256,
        schemes.ECDSA_SECP256R1_SHA256}
    assert RefCpu().verify_batch(ref_reqs) == labels
    assert RefCpu().verify_batch(_ref_requests(_rows(reqs))) == labels
    assert CpuBatchVerifier().verify_batch(reqs) == labels
    plain = CudaBatchVerifier(device="cpu", batch_sizes=(64,))
    assert plain.verify_batch(reqs) == labels
