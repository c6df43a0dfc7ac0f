"""The expect DSL (testing/expect.py) in the port, held against the
reference.

- Every case of the reference's tests/test_expect.py runs on the port
  with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module): sequence, parallel, predicates,
  strict and non-strict matching, replicate with backtracking, actions
  fired once on the surviving branch, and record() over the port's
  Observable.
- One drive of seeded event streams through both packages' matchers
  gives equal matches (the actions' hits, in order) and equal failure
  messages, exactly.
"""

from __future__ import annotations

import importlib
import random
import re

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")


@pytest.mark.parametrize("name,case", port_cases("test_expect", {}))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(port_test_module("test_expect"), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_expect", {})) == 10


class Ping:
    def __init__(self, n):
        self.n = n

    def __repr__(self):
        return f"Ping({self.n})"


class Pong:
    def __init__(self, n):
        self.n = n

    def __repr__(self):
        return f"Pong({self.n})"


def _expect_drive(prefix: str, seed: int) -> list:
    """Seeded streams against a fixed set of trees: per stream, the
    actions' hits on success or the AssertionError's text (function
    addresses aside)."""
    ex = importlib.import_module(f"{prefix}.testing.expect")
    rng = random.Random(seed)
    out = []
    for trial in range(40):
        events = [rng.choice((Ping, Pong))(k) for k in range(rng.randrange(1, 6))]
        hits = []

        def hit(tag):
            return lambda e: hits.append((tag, e.n))

        trees = (
            ex.sequence(ex.expect(Ping, action=hit("p")), ex.expect(Pong, action=hit("q"))),
            ex.parallel(ex.replicate(2, lambda i: ex.expect(Ping, action=hit(f"r{i}"))),
                        ex.expect(Pong, action=hit("q"))),
            ex.sequence(ex.expect(Ping), ex.parallel(ex.expect(Ping), ex.expect(Pong))),
        )
        for t, tree in enumerate(trees):
            for strict in (True, False):
                hits.clear()
                try:
                    ex.expect_events(events, tree, strict=strict)
                    out.append((trial, t, strict, "ok", list(hits)))
                except AssertionError as e:
                    # the residue's repr names the action lambdas by address
                    out.append((trial, t, strict, "fail",
                                re.sub(r" at 0x[0-9a-f]+", "", str(e))))
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_expect_drive_equals_the_references(seed):
    ref, port = (_expect_drive(p, seed) for p in PACKAGES)
    assert port == ref
    kinds = {r[3] for r in ref}
    assert kinds == {"ok", "fail"}
    assert any("unexpected event" in r[4] for r in ref if r[3] == "fail")
    assert any("not satisfied" in r[4] for r in ref if r[3] == "fail")
