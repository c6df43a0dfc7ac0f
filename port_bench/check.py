"""The comparison that decides `correct`, its control, and the faults it
must catch.

Every answer of every call the window submitted (those drained after
its end too) is compared with the plain reference's answer for its row,
worked out again from the bytes the benchmark made, once the window has
closed. The numbers compared, each with its limit:

  mismatched_rows  answers that differ from the reference's    limit 0
  unanswered_rows  answers missing, surplus to the call's rows,
                   or neither true nor false                    limit 0
  failed_rows      rows of calls that raised                    limit 0
  calls_checked    calls whose answers were compared            at least 1

Rows repeat across the window's calls (a cell cycles a few thousand
distinct rows), so a verdict cache keyed by the whole row would pass
this comparison. The configurations rule it out: every row is verified
afresh in every call (their `guarantees`), as for real signatures,
which do not repeat; a program that keeps verdicts across calls gives a
different result, not a faster one.

The control (`MemoControl`) is the reference put in the program's place
with one guarantee of the configuration broken: it memoises a verdict by
(key, signature) and so answers a row with another message by the first
verdict it gave. The faults (`Faulty`) break a sound verifier where its
answers are produced.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import ec_ref as R

# Corda's scheme ids (Crypto.kt) of the schemes the reference verifies
SCHEME_OF_ID = {2: R.K1, 3: R.P256, 4: R.ED25519}

LIMITS = {"mismatched_rows": 0, "unanswered_rows": 0, "failed_rows": 0}
MIN_CALLS = 1


def reference_answers(rows) -> list:
    """The reference's verdict for each distinct row."""
    ref = R.Reference()
    return [ref.verify(r.scheme, r.key, r.signature, r.message) for r in rows]


def compare(calls, layouts: list, answers: list) -> dict:
    """The numbers compared over `calls` (loop.Call) against the
    reference's `answers` per distinct row."""
    want = [bytes(int(answers[i]) for i in layout) for layout in layouts]
    mismatched = unanswered = failed = checked = 0
    for call in calls:
        if call.error is not None:
            failed += call.rows
            continue
        got, exp = call.answers, want[call.layout]
        checked += 1
        if got == exp:
            continue
        if isinstance(got, bytes) and len(got) == len(exp) and max(got, default=0) <= 1:
            mismatched += sum(a != b for a, b in zip(got, exp))
            continue
        got = list(got)
        unanswered += max(0, len(got) - len(exp))        # a row is answered once
        got += [None] * (len(exp) - len(got))
        for a, b in zip(got, exp):
            if a is True or a is False or (type(a) is int and a in (0, 1)):
                mismatched += int(a) != b
            else:
                unanswered += 1
    return {"mismatched_rows": mismatched, "unanswered_rows": unanswered,
            "failed_rows": failed, "calls_checked": checked}


def is_correct(numbers: dict) -> bool:
    return (all(numbers[k] <= v for k, v in LIMITS.items())
            and numbers["calls_checked"] >= MIN_CALLS)


def lines(numbers: dict) -> list:
    """One plain line per number compared, with its limit."""
    out = [f"check {k} {numbers[k]} limit {v}" for k, v in LIMITS.items()]
    out.append(f"check calls_checked {numbers['calls_checked']} limit >= {MIN_CALLS}")
    return out


def record(numbers: dict) -> dict:
    """The numbers and limits for the result line's last key."""
    out = {k: {"value": numbers[k], "limit": v} for k, v in LIMITS.items()}
    out["calls_checked"] = {"value": numbers["calls_checked"], "min": MIN_CALLS}
    return out


# ---------------------------------------------------------------------------
# stand-ins with the SPI's shape: verify_batch_async(requests) -> a handle
# with result(), stage_seconds and device_seconds()


@dataclass
class Done:
    answers: list
    stage_seconds: float = 0.0

    def result(self) -> list:
        return self.answers

    def device_seconds(self) -> float:
        return 0.0


def _row(req) -> tuple:
    return SCHEME_OF_ID[req.key.scheme_id], req.key.data, req.signature, req.message


class ReferenceVerifier:
    """The reference in the program's place, sound: a verdict is kept by
    the whole row, so a row that repeats is looked up, not recomputed."""

    def __init__(self):
        self._ref = R.Reference()
        self._seen: dict = {}

    def _memo_key(self, row: tuple):
        return row

    def verify_batch_async(self, requests) -> Done:
        out = []
        for req in requests:
            row = _row(req)
            key = self._memo_key(row)
            got = self._seen.get(key)
            if got is None:
                got = self._seen[key] = self._ref.verify(*row)
            out.append(got)
        return Done(out)


class MemoControl(ReferenceVerifier):
    """The control: a verdict memoised by (scheme, key, signature), so
    a signature is not bound to its message."""

    def _memo_key(self, row: tuple):
        return row[:3]


class Faulty:
    """A sound verifier broken where its answers are produced:
      stale  every call returns the previous call's answers
      half   the second half of each call's rows gets the first half's answers
      flip   one answer of each call is flipped"""

    FAULTS = ("stale", "half", "flip")

    def __init__(self, inner, fault: str):
        if fault not in self.FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.inner, self.fault = inner, fault
        self._last = None

    def verify_batch_async(self, requests) -> Done:
        answers = list(self.inner.verify_batch_async(requests).result())
        if self.fault == "stale":
            previous, self._last = self._last, answers
            answers = previous if previous is not None else answers
        elif self.fault == "half":
            half = len(answers) // 2
            answers = answers[:half] + answers[: len(answers) - half]
        else:
            answers[0] = not answers[0]
        return Done(answers)
