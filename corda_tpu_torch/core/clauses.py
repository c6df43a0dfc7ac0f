"""Composable contract-verification clauses.

Port of corda_tpu/core/clauses.py. Reference: core/.../contracts/clauses/ (Clause.kt, CompositeClause.kt,
AllOf.kt, AnyOf.kt, FirstOf.kt, GroupClauseVerifier.kt, ClauseVerifier.kt
— SURVEY.md §2.1 "Clause framework"). A clause is a reusable fragment of
contract logic: it declares which commands it *requires* and which it
*matches*, and `verify` returns the set of command values it processed.
The top-level `verify_clauses` entry point then asserts every command in
the transaction was matched by some clause — unprocessed commands are a
verification failure, exactly the reference's `ClauseVerifier.verifyClause`
semantics.

Composites:
  - AllOf: every sub-clause must match and verify.
  - AnyOf: one or more sub-clauses match; all that match must verify.
  - FirstOf: the first matching sub-clause verifies (if/elif chain).
  - GroupClauseVerifier: regroup the transaction's states with
    `LedgerTransaction.group_states` and run a clause per group — the
    idiom behind every fungible-asset contract (issue/move/exit per
    issued-token group).

Clauses receive (ltx, inputs, outputs, commands, group_key) so the same
clause class works both at top level (inputs/outputs = whole tx) and
inside a group (inputs/outputs = the group's slice).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from .contracts import ContractViolation


class Clause:
    """A fragment of contract verification logic.

    Subclasses set `required_commands` (a tuple of command value types)
    and override `verify`. A clause *matches* a transaction when every
    required command type is present among the commands it is offered
    (an empty tuple matches everything — reference Clause.kt
    `matches`).
    """

    required_commands: tuple[type, ...] = ()

    def matches(self, commands: Iterable[Any]) -> bool:
        present = {type(c.value) for c in commands}
        return all(rc in present for rc in self.required_commands)

    def matched_commands(self, commands: Iterable[Any]) -> list[Any]:
        """The commands this clause consumes (those of required types)."""
        return [
            c for c in commands if type(c.value) in self.required_commands
        ]

    def verify(
        self,
        ltx,
        inputs: list,
        outputs: list,
        commands: list,
        group_key: Any = None,
    ) -> set:
        """Run the clause; return the set of command *values* processed
        (identity-keyed via index below). Raise ContractViolation on any
        rule breach."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return type(self).__name__


class CompositeClause(Clause):
    """A clause delegating to sub-clauses (CompositeClause.kt)."""

    def __init__(self, *clauses: Clause):
        self.clauses = clauses

    @property
    def required_commands(self) -> tuple[type, ...]:  # type: ignore[override]
        return ()

    def __repr__(self) -> str:
        inner = ", ".join(repr(c) for c in self.clauses)
        return f"{type(self).__name__}({inner})"


class AllOf(CompositeClause):
    """All sub-clauses must match and verify (AllOf.kt)."""

    def matches(self, commands) -> bool:
        cmds = list(commands)
        return all(c.matches(cmds) for c in self.clauses)

    def verify(self, ltx, inputs, outputs, commands, group_key=None) -> set:
        processed: set = set()
        for clause in self.clauses:
            if not clause.matches(commands):
                raise ContractViolation(
                    f"required clause did not match: {clause!r}"
                )
            processed |= clause.verify(
                ltx, inputs, outputs, commands, group_key
            )
        return processed


class AnyOf(CompositeClause):
    """At least one sub-clause matches; all matching verify (AnyOf.kt)."""

    def matches(self, commands) -> bool:
        cmds = list(commands)
        return any(c.matches(cmds) for c in self.clauses)

    def verify(self, ltx, inputs, outputs, commands, group_key=None) -> set:
        matched = [c for c in self.clauses if c.matches(commands)]
        if not matched:
            raise ContractViolation(
                f"no clause of {self!r} matched the commands"
            )
        processed: set = set()
        for clause in matched:
            processed |= clause.verify(
                ltx, inputs, outputs, commands, group_key
            )
        return processed


class FirstOf(CompositeClause):
    """The first matching sub-clause runs — an if/elif chain
    (FirstOf.kt). No match is a violation."""

    def verify(self, ltx, inputs, outputs, commands, group_key=None) -> set:
        for clause in self.clauses:
            if clause.matches(commands):
                return clause.verify(
                    ltx, inputs, outputs, commands, group_key
                )
        raise ContractViolation(f"no clause of {self!r} matched")


class GroupClauseVerifier(Clause):
    """Regroup states and run `clause` once per group
    (GroupClauseVerifier.kt). Subclasses (or callers) supply how to
    group via (state_class, key_fn)."""

    def __init__(
        self,
        clause: Clause,
        state_class: type,
        key_fn: Callable[[Any], Any],
    ):
        self.clause = clause
        self.state_class = state_class
        self.key_fn = key_fn

    def matches(self, commands) -> bool:
        return True

    def verify(self, ltx, inputs, outputs, commands, group_key=None) -> set:
        processed: set = set()
        for group in ltx.group_states(self.state_class, self.key_fn):
            processed |= self.clause.verify(
                ltx, group.inputs, group.outputs, commands, group.key
            )
        return processed


def verify_clauses(
    ltx,
    clause: Clause,
    commands: Optional[list] = None,
) -> None:
    """Top-level entry point (ClauseVerifier.kt `verifyClause`): run the
    clause tree over the transaction and require that every command was
    matched by some clause. Call from `Contract.verify`."""
    cmds = list(ltx.commands) if commands is None else list(commands)
    processed = clause.verify(
        ltx, list(ltx.inputs), list(ltx.outputs), cmds
    )
    unprocessed = [c.value for c in cmds if id(c.value) not in processed]
    if unprocessed:
        raise ContractViolation(
            "commands not processed by any clause: "
            + ", ".join(type(v).__name__ for v in unprocessed)
        )


def mark(commands: Iterable[Any]) -> set:
    """Helper for `Clause.verify` implementations: the processed-set
    entry for each consumed command (identity of the command value, so
    duplicate equal commands are tracked independently)."""
    return {id(c.value) for c in commands}
