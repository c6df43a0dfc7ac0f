"""Batched contract execution across many resolved transactions.

Port of corda_tpu/core/batch_verify.py. Reference: the reference has no analogue — its contract execution is
per-transaction on a thread pool (InMemoryTransactionVerifierService.kt
:10-14) or farmed to horizontally-scaled verifier processes
(OutOfProcessTransactionVerifierService.kt:19-73). This framework's
premise is batching: the notary flush already drains every pending
transaction's SIGNATURES into one device dispatch, and this module gives
CONTRACT execution the same shape — group the flush's transactions by
contract and let contracts that implement `verify_batch(ltxs)` check
the whole group in one specialized pass instead of paying the generic
clause-framework machinery per transaction.

Contract protocol extension (opt-in):

    class MyContract:
        def verify(self, ltx) -> None: ...             # required
        def verify_batch(self, ltxs) -> list[Exception | None]: ...
            # optional; MUST decide accept/reject identically to
            # running `verify` on each ltx independently

`verify_ledger_batch` preserves per-transaction semantics exactly:

  - replacement transactions (notary change / contract upgrade),
    attachment-carried (sandboxed) contracts and contracts without a
    `verify_batch` fall back to `ltx.verify()` per transaction;
  - a transaction touching several contracts reports the error of the
    first FAILING contract in sorted-name order — the same order
    `LedgerTransaction.verify` runs them in;
  - a FAULTY `verify_batch` (raises, or wrong result arity) is
    confined: its transactions fall back to per-tx `ltx.verify()`
    instead of failing the whole batch.
"""

from __future__ import annotations

from typing import Optional

from .contracts import ContractViolation, contract_by_name
from .transactions import LedgerTransaction


def uses_attachment_code(ltx: LedgerTransaction) -> bool:
    """True when verifying this transaction would execute code loaded
    from its own attachments (a contract name with no local
    registration — the AttachmentsClassLoader path). Callers that
    OVERLAP contract execution with signature verification (the notary
    flush) use this to defer sandboxed code until the signatures are
    known-good: registered contracts are operator-installed and safe
    to run speculatively, attachment-carried code is peer-supplied."""
    from . import replacement as _repl

    try:
        if _repl.replacement_verifier(ltx) is not None:
            # replacement rules can load attachment-shipped code too —
            # a contract UPGRADE's conversion function may arrive only
            # as an attachment (replacement.py upgrade_from_attachments)
            # — so every replacement transaction defers
            return True
        names = ltx.contract_names()
    except Exception:  # noqa: BLE001 - malformed: resolved per-tx later
        # classification raises again inside ltx.verify() BEFORE any
        # attachment code would load, so speculative fallback is safe
        return False
    for name in names:
        try:
            contract_by_name(name)
        except ContractViolation:
            return True
    return False


def verify_ledger_batch(
    ltxs: list[LedgerTransaction],
) -> list[Optional[Exception]]:
    """Run contract verification over many transactions, batching per
    contract where the contract opts in. Returns one entry per input:
    None on acceptance, else the exception `ltx.verify()` would raise."""
    from . import replacement as _repl

    errs: list[Optional[Exception]] = [None] * len(ltxs)
    per_tx_names: list[Optional[list[str]]] = [None] * len(ltxs)
    by_contract: dict[str, list[int]] = {}
    contracts: dict[str, object] = {}
    for i, ltx in enumerate(ltxs):
        # classification itself can raise on a malformed transaction
        # (e.g. a replacement command mixed with others raises in
        # replacement_verifier) — route it to the per-tx fallback,
        # whose ltx.verify() reproduces the same error into errs[i]
        # instead of letting it escape and strand the whole batch
        try:
            if _repl.replacement_verifier(ltx) is not None:
                continue  # per-tx fallback (special replacement rules)
            names = ltx.contract_names()
        except Exception:  # noqa: BLE001 - fault isolation
            continue
        batchable = True
        for name in names:
            contract = contracts.get(name)
            if contract is None:
                try:
                    contract = contract_by_name(name)
                except ContractViolation:
                    # attachment-carried code: resolved + sandboxed by
                    # LedgerTransaction.verify, never batched
                    batchable = False
                    break
                contracts[name] = contract
            if not hasattr(contract, "verify_batch"):
                batchable = False
                break
        if not batchable:
            continue
        per_tx_names[i] = names
        for name in names:
            by_contract.setdefault(name, []).append(i)

    group_errs: dict[tuple[int, str], Exception] = {}
    for name, idxs in by_contract.items():
        # a faulty verify_batch implementation (raises, or returns the
        # wrong arity) must not take down the whole batch — a notary
        # flush answers thousands of unrelated requesters from this
        # call. Confine the fault: every transaction the broken
        # contract touches falls back to full per-tx `ltx.verify()`,
        # which re-runs ALL of that transaction's contracts with the
        # exact single-tx semantics.
        try:
            results = contracts[name].verify_batch(
                [ltxs[i] for i in idxs]
            )
            if len(results) != len(idxs):
                raise RuntimeError(
                    f"{name}.verify_batch returned {len(results)} "
                    f"results for {len(idxs)} transactions"
                )
        except Exception:  # noqa: BLE001 - fault isolation
            for i in idxs:
                per_tx_names[i] = None
            continue
        for i, e in zip(idxs, results):
            if e is not None:
                group_errs[(i, name)] = e

    for i, names in enumerate(per_tx_names):
        if names is None:
            try:
                ltxs[i].verify()
            except Exception as e:  # noqa: BLE001 - reported per tx
                errs[i] = e
            continue
        for name in names:
            e = group_errs.get((i, name))
            if e is not None:
                errs[i] = e
                break
    return errs
