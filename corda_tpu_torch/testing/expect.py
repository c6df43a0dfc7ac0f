"""Expect DSL: structured assertions over event streams.

Reference: test-utils/.../testing/Expect.kt:10-34 (SURVEY.md §4 Ring 3)
— tests declare the *shape* of an expected event sequence with
`expect` / `sequence` / `parallel` / `replicate` combinators and run it
against an Rx stream (vault updates, state-machine feed, …). Here the
fabric is deterministically pumped, so events are recorded first and
the combinator tree is matched as a nondeterministic automaton:
`sequence` requires in-order matches, `parallel` any interleaving,
`replicate(n)` = n parallel copies. In strict mode (the reference's
default) every observed event must be consumed by some expectation.

    events = record(vault.updates, lambda: run_network())
    expect_events(
        events,
        sequence(
            expect(VaultUpdate, lambda u: len(u.produced) == 1),
            parallel(
                expect(VaultUpdate, lambda u: u.consumed),
                expect(VaultUpdate),
            ),
        ),
    )

Matched (expectation, event) pairs fire each `expect`'s action callback
once a full match is found (actions run post-hoc so backtracking never
fires an action on a dead branch).

Port of corda_tpu/testing/expect.py over the port's
`node.services.Observable`; the same matches and the same failure
messages for the same events.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ExpectCompose:
    """Base marker for expectation-tree nodes."""


@dataclass(frozen=True)
class _Single(ExpectCompose):
    cls: type
    predicate: Optional[Callable[[Any], bool]]
    action: Optional[Callable[[Any], None]]

    def matches(self, event: Any) -> bool:
        if not isinstance(event, self.cls):
            return False
        return self.predicate is None or bool(self.predicate(event))


@dataclass(frozen=True)
class _Sequence(ExpectCompose):
    children: Tuple[ExpectCompose, ...]


@dataclass(frozen=True)
class _Parallel(ExpectCompose):
    children: Tuple[ExpectCompose, ...]


def expect(
    cls: type = object,
    predicate: Optional[Callable[[Any], bool]] = None,
    action: Optional[Callable[[Any], None]] = None,
) -> ExpectCompose:
    """Expect a single event of `cls` satisfying `predicate`; on a full
    match, `action(event)` runs (assertions live there)."""
    return _Single(cls, predicate, action)


def sequence(*expectations: ExpectCompose) -> ExpectCompose:
    return _Sequence(tuple(expectations))


def parallel(*expectations: ExpectCompose) -> ExpectCompose:
    return _Parallel(tuple(expectations))


def replicate(n: int, template: Callable[[int], ExpectCompose]) -> ExpectCompose:
    """n structurally-identical expectations in parallel
    (Expect.kt `replicate`)."""
    return _Parallel(tuple(template(i) for i in range(n)))


# -- the matcher -------------------------------------------------------------
#
# A state is (node-or-None, matches) where node is the *residual*
# expectation tree and matches the (single, event-index) pairs consumed
# on this branch. consume() expands one event into successor states.


def _consume(node, event, idx):
    """Yield (residual_node_or_None, matched_pairs) successors after
    `node` consumes `event`."""
    if isinstance(node, _Single):
        if node.matches(event):
            yield None, ((node, idx),)
        return
    if isinstance(node, _Sequence):
        if not node.children:
            return
        head, rest = node.children[0], node.children[1:]
        for residual, pairs in _consume(head, event, idx):
            tail: Tuple[ExpectCompose, ...]
            tail = ((residual,) if residual is not None else ()) + rest
            if not tail:
                yield None, pairs
            elif len(tail) == 1:
                yield tail[0], pairs
            else:
                yield _Sequence(tail), pairs
        return
    if isinstance(node, _Parallel):
        for i, child in enumerate(node.children):
            for residual, pairs in _consume(child, event, idx):
                rest = (
                    node.children[:i]
                    + ((residual,) if residual is not None else ())
                    + node.children[i + 1:]
                )
                if not rest:
                    yield None, pairs
                elif len(rest) == 1:
                    yield rest[0], pairs
                else:
                    yield _Parallel(rest), pairs
        return
    raise TypeError(f"not an expectation node: {node!r}")


def expect_events(
    events: Sequence[Any],
    expectation: ExpectCompose,
    strict: bool = True,
) -> None:
    """Match the recorded `events` against the expectation tree; raise
    AssertionError if no interleaving satisfies it. strict=True (the
    reference default) additionally requires every event to be consumed
    by some expect()."""
    # frontier of (residual, matches); None residual == complete
    frontier = [(expectation, ())]
    for idx, event in enumerate(events):
        nxt = []
        seen = set()
        for residual, pairs in frontier:
            if residual is not None:
                for r2, new_pairs in _consume(residual, event, idx):
                    key = (r2, pairs + new_pairs)
                    if key not in seen:
                        seen.add(key)
                        nxt.append((r2, pairs + new_pairs))
            if not strict:
                key = (residual, pairs)
                if key not in seen:
                    seen.add(key)
                    nxt.append((residual, pairs))
        if strict and not nxt:
            raise AssertionError(
                f"unexpected event at index {idx}: {event!r} "
                f"(no live expectation branch consumes it)"
            )
        if nxt:
            frontier = nxt
    for residual, pairs in frontier:
        if residual is None:
            for single, idx in pairs:
                if single.action is not None:
                    single.action(events[idx])
            return
    remaining = [r for r, _ in frontier if r is not None]
    raise AssertionError(
        f"expectation not satisfied after {len(events)} events; "
        f"unmatched residue (one branch shown): {remaining[0]!r}"
    )


def record(observable, pump: Callable[[], Any]) -> list:
    """Subscribe to `observable`, run `pump()` (e.g. mock-network
    run_network), return the events emitted during it."""
    events: list = []
    unsubscribe = observable.subscribe(events.append)
    try:
        pump()
    finally:
        unsubscribe()
    return events
