"""Universal contracts: a combinator DSL for generalised derivatives.

Reference: experimental/src/main/kotlin/net/corda/contracts/universal/
(SURVEY.md §2.10 "experimental/universal", ~1,200 LoC) — an
implementation of the composing-contracts idea: a financial agreement
is an *arrangement* tree built from a handful of combinators, and the
on-ledger contract verifies that each transaction is a legal evolution
of that tree.

Combinators (the reference's `Zero`, `Obligation`, `And`, `Actions`,
`RollOut`, and perceivable expressions):

  zero                      — the empty arrangement (fully discharged)
  obligation(amt, ccy, a→b) — `a` must transfer amt (a perceivable) to `b`
  all_of(x, y, …)           — both/all sub-arrangements hold
  actions(name=(actors, condition, next), …)
                            — named transitions parties may exercise
  roll_out(start, end, freq, template)
                            — schedule expansion: template stamped per
                              period with `next` chaining to the rest

Perceivables are deterministic expression trees (constants, named
observables fixed by an oracle, arithmetic, comparisons, time checks)
evaluated against a fixing environment {name: value} + tx time — the
reference's `Perceivable<T>` hierarchy, with oracle fixings entering
via a Fix command exactly like the IRS demo's rate fixes.

The `UniversalContract` verifies four commands:
  UniversalIssue  — no inputs; all liable parties sign
  UniversalAction — a named action whose condition holds fires; its
                    actors sign; output arrangement == the action's
                    continuation (reduced)
  UniversalFix    — observables in the arrangement are replaced with
                    oracle-signed values, nothing else changes
  UniversalMove   — a party novates its side to another key

Port of corda_tpu/experimental/universal.py; the contract name and the
wire tags are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Tuple

from ..core import serialization as ser
from ..core.contracts import ContractViolation, register_contract, require_that
from ..core.identity import Party

UNIVERSAL_CONTRACT = "corda_tpu.experimental.Universal"


# ---------------------------------------------------------------------------
# perceivables


@ser.serializable
@dataclass(frozen=True)
class Perceivable:
    """Expression node; evaluate with `perceive`."""

    op: str                      # const|obs|add|sub|mul|div|and|or|not
                                 # |lt|le|gt|ge|eq|time_after|time_before
    args: Tuple[Any, ...] = ()

    def _bin(self, op, other):
        return Perceivable(op, (self, _lift(other)))

    def __add__(self, o): return self._bin("add", o)
    def __sub__(self, o): return self._bin("sub", o)
    def __mul__(self, o): return self._bin("mul", o)
    def __floordiv__(self, o): return self._bin("div", o)
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def eq(self, o): return self._bin("eq", o)
    def and_(self, o): return self._bin("and", o)
    def or_(self, o): return self._bin("or", o)


def _lift(v) -> Perceivable:
    return v if isinstance(v, Perceivable) else const(v)


def const(v) -> Perceivable:
    """A constant (integer arithmetic only — determinism)."""
    return Perceivable("const", (v,))


def observable(source: str, name: str) -> Perceivable:
    """A value fixed later by an oracle, e.g. ("LIBOR", "3M-2026-09-01")."""
    return Perceivable("obs", (source, name))


def time_after(t: int) -> Perceivable:
    """True when tx time >= t (micros) — `after` in the reference DSL."""
    return Perceivable("time_after", (t,))


def time_before(t: int) -> Perceivable:
    return Perceivable("time_before", (t,))


class UnresolvedObservable(ContractViolation):
    pass


def perceive(p: Perceivable, fixings: Mapping, window):
    """Evaluate a perceivable against oracle fixings + the tx's
    time-window. `window` is (from_time, until_time) (either end may be
    None) or a single int treated as a point window. Time conditions
    are *sound over the whole window* — the notary may timestamp the tx
    anywhere inside it, so `time_after(t)` needs the window to START at
    or after t, and `time_before(t)` needs it to END by t."""
    op, a = p.op, p.args
    if op == "const":
        return a[0]
    if op == "obs":
        key = (a[0], a[1])
        if key not in fixings:
            raise UnresolvedObservable(f"unfixed observable {key}")
        return fixings[key]
    if op in ("time_after", "time_before"):
        if window is None:
            raise ContractViolation(
                "time-dependent condition needs a tx time-window"
            )
        from_t, until_t = (
            (window, window) if isinstance(window, int) else window
        )
        if op == "time_after":
            return from_t is not None and from_t >= a[0]
        return until_t is not None and until_t <= a[0]
    vals = [perceive(x, fixings, window) for x in a]
    if op == "add": return vals[0] + vals[1]
    if op == "sub": return vals[0] - vals[1]
    if op == "mul": return vals[0] * vals[1]
    if op == "div": return vals[0] // vals[1]
    if op == "and": return bool(vals[0]) and bool(vals[1])
    if op == "or": return bool(vals[0]) or bool(vals[1])
    if op == "not": return not vals[0]
    if op == "lt": return vals[0] < vals[1]
    if op == "le": return vals[0] <= vals[1]
    if op == "gt": return vals[0] > vals[1]
    if op == "ge": return vals[0] >= vals[1]
    if op == "eq": return vals[0] == vals[1]
    raise ContractViolation(f"unknown perceivable op {op!r}")


def substitute(p: Perceivable, fixings: Mapping) -> Perceivable:
    """Replace fixed observables with constants (UniversalFix)."""
    if p.op == "const":
        return p
    if p.op == "obs":
        key = (p.args[0], p.args[1])
        return const(fixings[key]) if key in fixings else p
    if p.op in ("time_after", "time_before"):
        return p
    return Perceivable(
        p.op, tuple(substitute(x, fixings) for x in p.args)
    )


# ---------------------------------------------------------------------------
# arrangements


@ser.serializable
@dataclass(frozen=True)
class Zero:
    pass


@ser.serializable
@dataclass(frozen=True)
class Obligation:
    """`from_party` must transfer `amount` of `currency` to `to_party`."""

    amount: Perceivable
    currency: str
    from_party: Party
    to_party: Party


@ser.serializable
@dataclass(frozen=True)
class All:
    arrangements: Tuple[Any, ...]


@ser.serializable
@dataclass(frozen=True)
class Action:
    """A named transition: `actors` may fire it when `condition` holds,
    evolving the agreement into `arrangement`."""

    name: str
    condition: Perceivable
    actors: Tuple[Party, ...]
    arrangement: Any


@ser.serializable
@dataclass(frozen=True)
class Actions:
    actions: Tuple[Action, ...]

    def by_name(self, name: str) -> Action:
        for a in self.actions:
            if a.name == name:
                return a
        raise ContractViolation(f"no action named {name!r}")


zero = Zero()


def obligation(amount, currency: str, from_party: Party, to_party: Party):
    return Obligation(_lift(amount), currency, from_party, to_party)


def all_of(*arrangements) -> Any:
    flat = [a for a in arrangements if not isinstance(a, Zero)]
    out = []
    for a in flat:
        out.extend(a.arrangements if isinstance(a, All) else (a,))
    if not out:
        return zero
    if len(out) == 1:
        return out[0]
    return All(tuple(out))


def actions(*acts: Action) -> Actions:
    return Actions(tuple(acts))


def action(name, condition, actors, arrangement) -> Action:
    acts = (actors,) if isinstance(actors, Party) else tuple(actors)
    return Action(name, _lift(condition), acts, arrangement)


def roll_out(
    start: int,
    end: int,
    period: int,
    template: Callable[[int, int, Any], Any],
) -> Any:
    """Expand a schedule eagerly (the reference's RollOut with `next`):
    `template(period_start, period_end, next_arrangement)` is stamped
    from the last period backwards, so each period's arrangement can
    embed the continuation of the remaining schedule."""
    bounds = []
    t = start
    while t < end:
        bounds.append((t, min(t + period, end)))
        t += period
    nxt: Any = zero
    for s, e in reversed(bounds):
        nxt = template(s, e, nxt)
    return nxt


def liable_parties(arr) -> set:
    """Everyone with a payment obligation anywhere in the tree."""
    if isinstance(arr, Zero):
        return set()
    if isinstance(arr, Obligation):
        return {arr.from_party}
    if isinstance(arr, All):
        return set().union(*(liable_parties(a) for a in arr.arrangements))
    if isinstance(arr, Actions):
        return set().union(
            *(liable_parties(a.arrangement) for a in arr.actions)
        )
    raise ContractViolation(f"unknown arrangement {type(arr).__name__}")


def involved_parties(arr) -> set:
    if isinstance(arr, Zero):
        return set()
    if isinstance(arr, Obligation):
        return {arr.from_party, arr.to_party}
    if isinstance(arr, All):
        return set().union(*(involved_parties(a) for a in arr.arrangements))
    if isinstance(arr, Actions):
        out = set()
        for a in arr.actions:
            out |= set(a.actors) | involved_parties(a.arrangement)
        return out
    raise ContractViolation(f"unknown arrangement {type(arr).__name__}")


def substitute_arrangement(arr, fixings: Mapping):
    if isinstance(arr, Zero):
        return arr
    if isinstance(arr, Obligation):
        return Obligation(
            substitute(arr.amount, fixings),
            arr.currency, arr.from_party, arr.to_party,
        )
    if isinstance(arr, All):
        return All(tuple(
            substitute_arrangement(a, fixings) for a in arr.arrangements
        ))
    if isinstance(arr, Actions):
        return Actions(tuple(
            Action(
                a.name,
                substitute(a.condition, fixings),
                a.actors,
                substitute_arrangement(a.arrangement, fixings),
            )
            for a in arr.actions
        ))
    raise ContractViolation(f"unknown arrangement {type(arr).__name__}")


# ---------------------------------------------------------------------------
# state, commands, contract


@ser.serializable
@dataclass(frozen=True)
class UniversalState:
    """The on-ledger agreement (reference: universal/ContractState —
    parties + arrangement tree). `oracles` maps each observable source
    named in the arrangement to the Party whose signature authenticates
    its fixings (the reference feeds fixes through oracle-signed
    tear-offs the same way — irs-demo RatesFixFlow)."""

    parties: Tuple[Party, ...]
    arrangement: Any
    oracles: Tuple[Tuple[str, Party], ...] = ()

    @property
    def participants(self):
        return tuple(p.owning_key for p in self.parties)

    def oracle_for(self, source: str) -> Optional[Party]:
        for s, party in self.oracles:
            if s == source:
                return party
        return None


@ser.serializable
@dataclass(frozen=True)
class UniversalIssue:
    pass


@ser.serializable
@dataclass(frozen=True)
class UniversalAction:
    name: str
    fixings: Tuple[Tuple[Tuple[str, str], Any], ...] = ()


@ser.serializable
@dataclass(frozen=True)
class UniversalFix:
    fixings: Tuple[Tuple[Tuple[str, str], Any], ...]


def _check_fixings(state: "UniversalState", fixings: Mapping, signers) -> None:
    """Fixings are oracle claims: each source's registered oracle must
    have signed the command carrying them."""
    for source, _name in fixings:
        oracle = state.oracle_for(source)
        require_that(
            f"an oracle is registered for source {source!r}",
            oracle is not None,
        )
        require_that(
            f"fixing for {source!r} is signed by its oracle",
            oracle.owning_key in signers,
        )


class UniversalContract:
    """Verify agreement evolution (universal/UniversalContract.kt)."""

    def verify(self, ltx) -> None:
        cmds = [
            c for c in ltx.commands
            if isinstance(
                c.value, (UniversalIssue, UniversalAction, UniversalFix)
            )
        ]
        require_that("one universal command per transaction", len(cmds) == 1)
        cmd = cmds[0]
        signers = set(cmd.signers)
        ins = [
            sar.state.data for sar in ltx.inputs
            if isinstance(sar.state.data, UniversalState)
        ]
        outs = [
            ts.data for ts in ltx.outputs
            if isinstance(ts.data, UniversalState)
        ]
        window = None
        if ltx.time_window is not None:
            window = (ltx.time_window.from_time, ltx.time_window.until_time)

        if isinstance(cmd.value, UniversalIssue):
            require_that("issue consumes no agreement", not ins)
            require_that("issue creates one agreement", len(outs) == 1)
            state = outs[0]
            for p in liable_parties(state.arrangement):
                require_that(
                    f"issue is signed by liable party {p.name}",
                    p.owning_key in signers,
                )
            require_that(
                "state parties cover everyone involved",
                involved_parties(state.arrangement)
                <= set(state.parties),
            )
            return

        require_that("evolution consumes one agreement", len(ins) == 1)
        before = ins[0]

        if isinstance(cmd.value, UniversalFix):
            require_that("fix produces one agreement", len(outs) == 1)
            fixings = dict(cmd.value.fixings)
            _check_fixings(before, fixings, signers)
            expected = substitute_arrangement(before.arrangement, fixings)
            require_that(
                "fix only substitutes fixed observables",
                outs[0].arrangement == expected
                and outs[0].parties == before.parties
                and outs[0].oracles == before.oracles,
            )
            return

        # UniversalAction
        require_that(
            "agreement root offers actions",
            isinstance(before.arrangement, Actions),
        )
        act = before.arrangement.by_name(cmd.value.name)
        fixings = dict(cmd.value.fixings)
        _check_fixings(before, fixings, signers)
        if not perceive(act.condition, fixings, window):
            raise ContractViolation(
                f"condition for action {act.name!r} does not hold"
            )
        for p in act.actors:
            require_that(
                f"action is signed by actor {p.name}",
                p.owning_key in signers,
            )
        continuation = substitute_arrangement(act.arrangement, fixings)
        if isinstance(continuation, Zero):
            require_that(
                "discharged agreement produces no output state",
                len(outs) == 0,
            )
        else:
            require_that("evolution produces one agreement", len(outs) == 1)
            require_that(
                "output arrangement is the action's continuation",
                outs[0].arrangement == continuation,
            )
            require_that(
                "parties are preserved",
                outs[0].parties == before.parties
                and outs[0].oracles == before.oracles,
            )


register_contract(UNIVERSAL_CONTRACT, UniversalContract())
