"""The port's attachment sandbox (core/sandbox.py) against the reference's.

An attachment's bytes are part of a transaction's id, so the same bytes
must run in both packages: its source imports the platform API by the
reference's module names, and the port's import hook serves them from
the port's own modules. Each case packs one contract source into an
attachment, loads it from a transaction's attachments in both packages
and runs it on the same ledger transaction built in each; the outcomes
must be equal — a pass, or the same exception class (ContractViolation,
SandboxViolation, CostLimitExceeded, OverlappingAttachments) with the
same message.
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import corda_tpu.core.sandbox as rsandbox  # noqa: E402
import corda_tpu.finance.commercial_paper  # noqa: E402,F401  (wire classes)
import corda_tpu.finance.obligation  # noqa: E402,F401
import corda_tpu_torch.core.sandbox as psandbox  # noqa: E402
import corda_tpu_torch.finance.commercial_paper as pcp  # noqa: E402
import corda_tpu_torch.finance.obligation as pobl  # noqa: E402
from corda_tpu_torch.testing.notary_fixture import MAGIC_SOURCE  # noqa: E402
from test_torch_serialization import PORT, REF  # noqa: E402


def _ltx(ns, quantities, contract="demo.case"):
    """A ledger transaction of ns's classes: one 100 Cash input, outputs
    of the given quantities under `contract`, a Cash move signed by the
    owner."""
    kp = ns.generate_keypair(ns.EDDSA_ED25519_SHA512, seed=31)
    notary = ns.Party("Notary", ns.generate_keypair(ns.EDDSA_ED25519_SHA512, seed=32).public)
    token = ns.Issued(ns.PartyAndReference(ns.Party("Bank", kp.public), b"\x01"), "USD")
    sar = ns.StateAndRef(ns.TransactionState(ns.CashState(ns.Amount(100, token), kp.public),
                                             ns.CASH_CONTRACT, notary),
                         ns.StateRef(ns.SecureHash.sha256(b"in"), 0))
    outs = tuple(ns.TransactionState(ns.CashState(ns.Amount(q, token), kp.public), contract, notary)
                 for q in quantities)
    cmds = (ns.CommandWithParties((kp.public,), (), ns.CashMove()),)
    return ns.LedgerTransaction((sar,), outs, cmds, (), notary, None, ns.SecureHash.sha256(b"t"))


# contract sources: (id, class name, source, output quantities, expected class)
PLATFORM = '''
from corda_tpu.core.contracts import Amount, require_that
from corda_tpu.core.identity import Party
from corda_tpu.core.clauses import Clause
from corda_tpu.crypto.hashes import SecureHash
from corda_tpu.finance.cash import CashState
from corda_tpu.finance.commercial_paper import CommercialPaperState
from corda_tpu.finance.obligation import ObligationState
from dataclasses import dataclass
from typing import Optional

class Platform:
    def verify(self, ltx):
        states = [ts.data for ts in ltx.outputs]
        require_that("outputs are cash", all(isinstance(s, CashState) for s in states))
        require_that("amounts are amounts", all(isinstance(s.amount, Amount) for s in states))
        require_that("no paper", not any(isinstance(s, CommercialPaperState) for s in states))
        require_that("no obligation", not any(isinstance(s, ObligationState) for s in states))
        require_that("the id is a hash", isinstance(ltx.id, SecureHash))
        require_that("sum is 100", sum(s.amount.quantity for s in states) == 100)
'''
CASES = [
    ("magic-pass", "MagicContract", MAGIC_SOURCE.replace("demo.magic", "demo.case"), (50, 50), None),
    ("magic-violation", "MagicContract", MAGIC_SOURCE.replace("demo.magic", "demo.case"),
     (60, 40), "ContractViolation"),
    ("platform-pass", "Platform", PLATFORM, (30, 70), None),
    ("platform-violation", "Platform", PLATFORM, (30, 60), "ContractViolation"),
    ("clock", "C", "import time\nclass C:\n    def verify(self, ltx):\n        time.time()\n",
     (100,), "SandboxViolation"),
    ("io-and-pow", "C", "class C:\n    def verify(self, ltx):\n        open('x')\n        x = 2 ** 8\n",
     (100,), "SandboxViolation"),
    ("dunder", "C", "class C:\n    def verify(self, ltx):\n        ltx.__class__\n",
     (100,), "SandboxViolation"),
    ("format", "C", "class C:\n    def verify(self, ltx):\n        '{0}'.format(ltx)\n",
     (100,), "SandboxViolation"),
    ("forbidden-import", "C", "from corda_tpu.node.services import ServiceHub\nclass C:\n"
     "    def verify(self, ltx):\n        pass\n", (100,), "SandboxViolation"),
    ("relative-import", "C", "from . import x\nclass C:\n    def verify(self, ltx):\n        pass\n",
     (100,), "SandboxViolation"),
    ("no-class", "Missing", "class C:\n    def verify(self, ltx):\n        pass\n",
     (100,), "SandboxViolation"),
    ("loop-budget", "C", "class C:\n    def verify(self, ltx):\n        n = 0\n"
     "        for i in range(1000):\n            for j in range(1000):\n                n += 1\n",
     (100,), "CostLimitExceeded"),
    ("range-budget", "C", "class C:\n    def verify(self, ltx):\n        for i in range(10000000):\n"
     "            pass\n", (100,), "CostLimitExceeded"),
    ("repeat-cap", "C", "class C:\n    def verify(self, ltx):\n        x = 'a' * 10000000\n",
     (100,), "CostLimitExceeded"),
    ("shift-cap", "C", "class C:\n    def verify(self, ltx):\n        x = 1 << 100000\n",
     (100,), "CostLimitExceeded"),
    ("recursion", "C", "def f(n):\n    return f(n + 1)\nclass C:\n    def verify(self, ltx):\n"
     "        f(0)\n", (100,), "CostLimitExceeded"),
]


def _run(ns, sandbox, name, cls, source, quantities, extra=()):
    try:
        att = sandbox.make_contract_attachment("demo.case", cls, source)
        contract = sandbox.contract_from_attachments("demo.case", [att, *extra])
        contract.verify(_ltx(ns, quantities))
        return None
    except Exception as e:   # noqa: BLE001 - the outcome under test
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_same_attachment_same_outcome(case):
    name, cls, source, quantities, expected = case
    assert (psandbox.make_contract_attachment("demo.case", cls, source).id.bytes_
            == rsandbox.make_contract_attachment("demo.case", cls, source).id.bytes_)
    got = _run(PORT, psandbox, name, cls, source, quantities)
    want = _run(REF, rsandbox, name, cls, source, quantities)
    assert got == want
    assert (None if got is None else got[0]) == expected


def test_overlapping_and_missing_attachments():
    """Two different attachments claiming one contract raise
    OverlappingAttachments; the same attachment listed twice does not;
    no attachment at all is an unknown contract — alike in both."""
    other = "class MagicContract:\n    def verify(self, ltx):\n        pass\n"
    outs = []
    for ns, sandbox in ((PORT, psandbox), (REF, rsandbox)):
        a = sandbox.make_contract_attachment("demo.case", "MagicContract", MAGIC_SOURCE)
        b = sandbox.make_contract_attachment("demo.case", "MagicContract", other)
        row = []
        for atts in ([a, b], [a, a], [ns.Attachment.of(b"unrelated")]):
            try:
                sandbox.contract_from_attachments("demo.case", atts)
                row.append(None)
            except Exception as e:   # noqa: BLE001 - the outcome under test
                row.append((type(e).__name__, str(e)))
        outs.append(row)
    assert outs[0] == outs[1]
    assert [o and o[0] for o in outs[0]] == ["OverlappingAttachments", None, "ContractViolation"]


def test_upgrade_conversion_from_an_attachment():
    """upgrade_from_attachments: the attachment's `convert` runs under the
    budget in both packages and gives equal converted states."""
    src = ("from corda_tpu.finance.cash import CashState\n"
           "from corda_tpu.core.contracts import Amount\n"
           "def convert(old):\n    return CashState(Amount(old.amount.quantity * 2, "
           "old.amount.token), old.owner)\n")
    got = []
    for ns, sandbox in ((PORT, psandbox), (REF, rsandbox)):
        att = sandbox.make_contract_attachment("demo.new", "C", src, upgrades_from="demo.old")
        convert = sandbox.upgrade_from_attachments("demo.old", "demo.new", [att])
        assert sandbox.upgrade_from_attachments("demo.old", "demo.other", [att]) is None
        state = _ltx(ns, (100,)).inputs[0].state.data
        new = convert(state)
        assert type(new) is ns.CashState
        got.append(ns.ser.encode(new))
    assert got[0] == got[1]


def test_attachment_code_switch(monkeypatch):
    """CORDA_TPU_ATTACHMENT_CODE=0 refuses attachment code in both."""
    monkeypatch.setenv("CORDA_TPU_ATTACHMENT_CODE", "0")
    outs = [_run(ns, sb, "off", "MagicContract", MAGIC_SOURCE, (50,))
            for ns, sb in ((PORT, psandbox), (REF, rsandbox))]
    assert outs[0] == outs[1] and outs[0][0] == "ContractViolation"


def test_served_modules_are_the_ports():
    """The import hook maps every platform name to the port's module of
    the same path, and the port's contract modules register under the
    reference's contract names."""
    assert psandbox.ALLOWED_MODULES == rsandbox.ALLOWED_MODULES
    for name, served in psandbox.PORT_MODULES.items():
        assert served == (name.replace("corda_tpu.", "corda_tpu_torch.", 1)
                          if name.startswith("corda_tpu.") else name)
    assert pcp.CP_CONTRACT == "corda_tpu.finance.CommercialPaper"
    assert pobl.OBLIGATION_CONTRACT == "corda_tpu.finance.Obligation"
    assert PORT.contract_by_name(pcp.CP_CONTRACT) is not None
