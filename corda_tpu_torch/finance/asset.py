"""OnLedgerAsset: the generic fungible-asset contract base.

Port of corda_tpu/finance/asset.py; the object-less sweep
(`verify_fields`) runs in the native library (native/cts_hash.cpp
asset_verify_fields), as the reference's main path does, and
`verify_fields_py` is its Python body, the differential reference.
Reference:
finance/.../contracts/asset/OnLedgerAsset.kt — the shared issue/move/exit
machinery behind Cash, CommodityContract and Obligation
— together with the clause stack those contracts instantiate
(finance/.../clause/{Issue,Move,Exit}... over
core/.../contracts/clauses/, SURVEY.md §2.1/§2.10).

An asset contract here is an `OnLedgerAsset` instance parameterised by
its state class and its three command types. Verification is the
canonical clause tree:

    GroupClauseVerifier(by issued token,
        FirstOf(IssueClause, ExitClause, MoveClause))

with per-group conservation arithmetic on integer `Amount`s and
composite-aware signature checks.
"""

from __future__ import annotations

from typing import Any, Callable

from ..core.clauses import Clause, GroupClauseVerifier, mark, verify_clauses
from ..core.contracts import Amount, ContractViolation, require_that
from ..crypto.composite import is_fulfilled_by, leaves_of


def signed_by(key, signers) -> bool:
    """Composite-aware signer check: `key` is satisfied when it (or,
    for composite keys, a fulfilling set of its leaves) appears among
    the command signers' leaves (CompositeKey.isFulfilledBy,
    core/.../crypto/composite/CompositeKey.kt:168)."""
    leaf_pool = set()
    for s in signers:
        leaf_pool.update(leaves_of(s))
        leaf_pool.add(s)
    return key in leaf_pool or is_fulfilled_by(key, leaf_pool)


class IssueClause(Clause):
    """New value appears: no inputs in the group, positive outputs,
    signed by the issuer (AbstractIssue.kt)."""

    def __init__(self, issue_cmd: type):
        self.required_commands = (issue_cmd,)

    def verify(self, ltx, inputs, outputs, commands, group_key=None) -> set:
        cmds = self.matched_commands(commands)
        if inputs:
            raise ContractViolation(
                "issue group must not consume inputs"
            )
        out_sum = sum(s.amount.quantity for s in outputs)
        require_that("issued amount is positive", out_sum > 0)
        require_that(
            "output amounts are positive",
            all(s.amount.quantity > 0 for s in outputs),
        )
        issuer_key = group_key.issuer.party.owning_key
        all_signers = {k for c in cmds for k in c.signers}
        require_that(
            "issue is signed by the issuer",
            signed_by(issuer_key, all_signers),
        )
        return mark(cmds)


class MoveClause(Clause):
    """Value changes hands: conservation per group, every input owner
    signs (ConserveAmount + move checks, Cash.kt Clauses.Move)."""

    def __init__(self, move_cmd: type):
        self.required_commands = (move_cmd,)

    def verify(self, ltx, inputs, outputs, commands, group_key=None) -> set:
        cmds = self.matched_commands(commands)
        in_sum = sum(s.amount.quantity for s in inputs)
        out_sum = sum(s.amount.quantity for s in outputs)
        require_that(
            "output amounts are positive",
            all(s.amount.quantity > 0 for s in outputs),
        )
        require_that(
            "value is conserved (inputs == outputs)",
            in_sum == out_sum and in_sum > 0,
        )
        all_signers = {k for c in commands for k in c.signers}
        for owner in {s.owner for s in inputs}:
            require_that(
                "move is signed by every input owner",
                signed_by(owner, all_signers),
            )
        return mark(cmds)


class ExitClause(Clause):
    """Value is destroyed: inputs − outputs == exited amount for this
    group's token; issuer and input owners sign (AbstractConserveAmount
    exit handling). The exit command must carry `amount: Amount`."""

    def __init__(self, exit_cmd: type):
        self.required_commands = (exit_cmd,)

    def verify(self, ltx, inputs, outputs, commands, group_key=None) -> set:
        group_exits = [
            c
            for c in self.matched_commands(commands)
            if c.value.amount.token == group_key
        ]
        if not group_exits:
            # an exit of another token group; this group is a plain move
            raise ContractViolation(
                "exit command does not apply to this token group"
            )
        require_that(
            "output amounts are positive",
            all(s.amount.quantity > 0 for s in outputs),
        )
        in_sum = sum(s.amount.quantity for s in inputs)
        out_sum = sum(s.amount.quantity for s in outputs)
        exited = sum(c.value.amount.quantity for c in group_exits)
        require_that("exit conserves value", in_sum - out_sum == exited)
        exit_signers = {k for c in group_exits for k in c.signers}
        issuer_key = group_key.issuer.party.owning_key
        require_that(
            "exit is signed by the issuer",
            signed_by(issuer_key, exit_signers),
        )
        all_signers = {k for c in commands for k in c.signers}
        for owner in {s.owner for s in inputs}:
            require_that(
                "exit is signed by every input owner",
                signed_by(owner, all_signers),
            )
        return mark(group_exits)


class AssetGroupClause(Clause):
    """Group-aware if/elif over Issue/Exit/Move. `FirstOf` alone cannot
    choose here because exit-vs-move is decided by the *group's* token
    (an exit of token A must not constrain a simultaneous move of token
    B), and clause matching only sees commands — so this clause does
    the dispatch with group context, mirroring how the reference's Cash
    group clause scopes exits to its issued-token group."""

    def __init__(self, issue: IssueClause, exit_: ExitClause, move: MoveClause):
        self.issue = issue
        self.exit_ = exit_
        self.move = move

    def matches(self, commands) -> bool:
        return True

    def verify(self, ltx, inputs, outputs, commands, group_key=None) -> set:
        if self.issue.matches(commands) and not inputs:
            return self.issue.verify(
                ltx, inputs, outputs, commands, group_key
            )
        group_exits = [
            c
            for c in self.exit_.matched_commands(commands)
            if c.value.amount.token == group_key
        ]
        if group_exits:
            return self.exit_.verify(
                ltx, inputs, outputs, commands, group_key
            )
        return self.move.verify(ltx, inputs, outputs, commands, group_key)


def _default_token_of(s):
    """The standard fungible token key. Named (not a lambda default) so
    the native sweep can recognise it and read .amount.token itself."""
    return s.amount.token


class OnLedgerAsset:
    """Generic fungible-asset contract. Concrete assets instantiate it
    with their state class + command types and register the instance
    (OnLedgerAsset.kt; Cash/Commodity are thin instantiations)."""

    def __init__(
        self,
        state_class: type,
        issue_cmd: type,
        move_cmd: type,
        exit_cmd: type,
        token_of: Callable[[Any], Any] = _default_token_of,
    ):
        self.state_class = state_class
        self.issue_cmd = issue_cmd
        self.move_cmd = move_cmd
        self.exit_cmd = exit_cmd
        self.token_of = token_of
        group_clause = AssetGroupClause(
            IssueClause(issue_cmd),
            ExitClause(exit_cmd),
            MoveClause(move_cmd),
        )
        self._tree = GroupClauseVerifier(
            group_clause, state_class, token_of
        )

    def verify(self, ltx) -> None:
        cmds = [
            c
            for c in ltx.commands
            if type(c.value)
            in (self.issue_cmd, self.move_cmd, self.exit_cmd)
        ]
        require_that("an asset command is present", len(cmds) >= 1)
        verify_clauses(ltx, self._tree, cmds)

    # -- batched form (core/batch_verify.py protocol) -----------------------

    def verify_batch(self, ltxs) -> list:
        """Batched `verify`: identical accept/reject decisions and
        messages, via one specialized pass per transaction that skips
        the generic clause machinery (clause matching, group_states,
        processed-set threading). The notary flush's contract phase is
        dominated by exactly that machinery, so asset-heavy batches
        (the notary serving shape) verify several times faster.
        Equivalence with the clause stack is fuzz-checked in
        tests/test_batch_verify.py."""
        out = []
        for ltx in ltxs:
            try:
                self._verify_fast(ltx)
                out.append(None)
            except Exception as e:  # noqa: BLE001 - reported per tx
                out.append(e)
        return out

    def _verify_fast(self, ltx) -> None:
        """Single-pass mirror of the clause tree over a resolved
        LedgerTransaction."""
        self.verify_fields(
            ltx.commands,
            [sar.state.data for sar in ltx.inputs],
            [ts.data for ts in ltx.outputs],
        )

    def verify_fields(self, commands, input_datas, output_datas) -> None:
        """The object-less entry point (core/batch_verify.py fused
        notary path): verify straight from wire-level pieces — command
        objects exposing .value/.signers (wire Command and resolved
        CommandWithParties both do) and raw state-data lists — without
        a LedgerTransaction ever existing. Check ORDER and messages
        must stay aligned with the clause implementations above — the
        first violation reported has to match; equivalence is
        fuzz-checked in tests/test_batch_verify.py (and the port's
        against the clause stack in tests/test_torch_transactions.py).

        Runs in C (native/cts_hash.cpp asset_verify_fields);
        verify_fields_py is the same sweep in Python, held equal to it,
        messages included, by tests/test_torch_native.py."""
        from .. import native

        native.get().asset_verify_fields(
            commands, input_datas, output_datas,
            self.state_class, self.issue_cmd, self.move_cmd, self.exit_cmd,
            # None = the default token key: C reads .amount.token itself
            None if self.token_of is _default_token_of else self.token_of,
            signed_by,
            ContractViolation,
        )

    def verify_fields_py(self, commands, input_datas, output_datas) -> None:
        """The pure-Python sweep (the differential reference; exact
        clause-stack semantics)."""
        asset_types = (self.issue_cmd, self.move_cmd, self.exit_cmd)
        cmds = [c for c in commands if type(c.value) in asset_types]
        require_that("an asset command is present", len(cmds) >= 1)
        # group by issued token, inputs first then outputs — the
        # insertion order LedgerTransaction.group_states produces
        groups: dict = {}
        token_of = self.token_of
        state_class = self.state_class
        for s in input_datas:
            if isinstance(s, state_class):
                g = groups.get(k := token_of(s))
                if g is None:
                    g = groups[k] = ([], [])
                g[0].append(s)
        for s in output_datas:
            if isinstance(s, state_class):
                g = groups.get(k := token_of(s))
                if g is None:
                    g = groups[k] = ([], [])
                g[1].append(s)
        # commands are tracked by their INDEX in cmds (not object
        # identity — id() is banned by the determinism audit), which
        # preserves the clause stack's duplicate-command semantics.
        # One pass, not three comprehensions: this runs per tx per flush
        issue_cmds, move_cmds, exit_cmds = [], [], []
        all_signers = set()
        issue_t, move_t = self.issue_cmd, self.move_cmd
        for i, c in enumerate(cmds):
            t = type(c.value)
            if t is issue_t:
                issue_cmds.append((i, c))
            elif t is move_t:
                move_cmds.append((i, c))
            else:
                exit_cmds.append((i, c))
            all_signers.update(c.signers)
        processed: set[int] = set()
        for token, (inputs, outputs) in groups.items():
            processed |= self._verify_group_fast(
                token, inputs, outputs,
                issue_cmds, move_cmds, exit_cmds, all_signers,
            )
        unprocessed = [
            c.value for i, c in enumerate(cmds) if i not in processed
        ]
        if unprocessed:
            raise ContractViolation(
                "commands not processed by any clause: "
                + ", ".join(type(v).__name__ for v in unprocessed)
            )

    def _verify_group_fast(
        self, token, inputs, outputs,
        issue_cmds, move_cmds, exit_cmds, all_signers,
    ) -> set:
        """AssetGroupClause dispatch + the chosen clause's checks, in
        the clause implementations' exact order."""
        if issue_cmds and not inputs:                    # IssueClause
            out_sum = sum(s.amount.quantity for s in outputs)
            require_that("issued amount is positive", out_sum > 0)
            require_that(
                "output amounts are positive",
                all(s.amount.quantity > 0 for s in outputs),
            )
            issuer_key = token.issuer.party.owning_key
            issue_signers = {k for _, c in issue_cmds for k in c.signers}
            require_that(
                "issue is signed by the issuer",
                signed_by(issuer_key, issue_signers),
            )
            return {i for i, _ in issue_cmds}
        group_exits = [
            (i, c) for i, c in exit_cmds if c.value.amount.token == token
        ]
        if group_exits:                                  # ExitClause
            require_that(
                "output amounts are positive",
                all(s.amount.quantity > 0 for s in outputs),
            )
            in_sum = sum(s.amount.quantity for s in inputs)
            out_sum = sum(s.amount.quantity for s in outputs)
            exited = sum(c.value.amount.quantity for _, c in group_exits)
            require_that("exit conserves value", in_sum - out_sum == exited)
            exit_signers = {k for _, c in group_exits for k in c.signers}
            issuer_key = token.issuer.party.owning_key
            require_that(
                "exit is signed by the issuer",
                signed_by(issuer_key, exit_signers),
            )
            for owner in {s.owner for s in inputs}:
                require_that(
                    "exit is signed by every input owner",
                    signed_by(owner, all_signers),
                )
            return {i for i, _ in group_exits}
        # MoveClause (unconditional fallthrough, as in the group clause)
        in_sum = sum(s.amount.quantity for s in inputs)
        out_sum = sum(s.amount.quantity for s in outputs)
        require_that(
            "output amounts are positive",
            all(s.amount.quantity > 0 for s in outputs),
        )
        require_that(
            "value is conserved (inputs == outputs)",
            in_sum == out_sum and in_sum > 0,
        )
        for owner in {s.owner for s in inputs}:
            require_that(
                "move is signed by every input owner",
                signed_by(owner, all_signers),
            )
        return {i for i, _ in move_cmds}
