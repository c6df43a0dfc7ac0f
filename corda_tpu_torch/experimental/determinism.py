"""Deterministic-contract checker: static audit of contract verify code.

Port of corda_tpu/experimental/determinism.py, the same rules. Reference:
the deterministic-JVM sandbox prototype (experimental/sandbox/ —
`WhitelistClassLoader` + bytecode instrumentation rejecting
non-deterministic APIs and metering cost, planned to wrap out-of-process
verifiers, docs/source/out-of-process-verification.rst:11-13). Matching
scope here: a static AST audit that flags non-deterministic constructs in
a contract's `verify`, usable as a CI gate and by a verifier before
registering a contract.

This module is the STATIC half; the RUNTIME half (restricted builtins,
allowlisted imports, operation-budget metering for attachment-carried
contract code) lives in core/sandbox.py, which calls `audit_source`
before executing anything. Python cannot be fully confined from inside
one process; together the two catch the accident class (clocks,
randomness, IO, runaway loops), while organisational review covers
malice — the same posture the reference's prototype takes.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass

# names whose *use* in contract code is non-deterministic or effectful
FORBIDDEN_NAMES = {
    "open", "input", "print", "eval", "exec", "compile", "globals",
    "vars", "id", "hash", "object",
}
FORBIDDEN_MODULES = {
    "time", "random", "os", "sys", "io", "socket", "subprocess",
    "threading", "multiprocessing", "datetime", "secrets", "uuid",
    "requests", "urllib", "pathlib", "tempfile",
}
FORBIDDEN_ATTRS = {
    "now", "today", "urandom", "getrandbits", "random", "randint",
    "choice", "shuffle", "time", "time_ns", "monotonic", "perf_counter",
}
# names additionally unavailable to UNREVIEWED attachment code (sandbox
# mode): pow is an unmetered-exponentiation budget bypass, format is a
# format-string attribute-traversal leak (core/sandbox.py removes both
# from the runtime builtins; the audit makes the failure a load-time one)
SANDBOX_FORBIDDEN_NAMES = {"pow", "format"}


@dataclass(frozen=True)
class Violation:
    line: int
    message: str


class DeterminismError(Exception):
    def __init__(self, contract_name: str, violations: list[Violation]):
        self.violations = violations
        detail = "; ".join(f"L{v.line}: {v.message}" for v in violations)
        super().__init__(
            f"contract {contract_name} fails the determinism audit: {detail}"
        )


class _Auditor(ast.NodeVisitor):
    def __init__(self, sandbox: bool = False):
        # sandbox mode adds the escape-surface rules that only make
        # sense for UNREVIEWED attachment-shipped code (core/sandbox.py);
        # installed contracts may use private helpers freely
        self.sandbox = sandbox
        self.violations: list[Violation] = []

    def _flag(self, node: ast.AST, message: str) -> None:
        self.violations.append(Violation(getattr(node, "lineno", 0), message))

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            root = alias.name.split(".")[0]
            if root in FORBIDDEN_MODULES:
                self._flag(node, f"imports non-deterministic module {root!r}")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        root = (node.module or "").split(".")[0]
        if root in FORBIDDEN_MODULES:
            self._flag(node, f"imports non-deterministic module {root!r}")
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            if node.id in FORBIDDEN_NAMES:
                self._flag(node, f"uses forbidden builtin {node.id!r}")
            if node.id in FORBIDDEN_MODULES:
                self._flag(node, f"references module {node.id!r}")
            if self.sandbox and node.id in SANDBOX_FORBIDDEN_NAMES:
                self._flag(
                    node,
                    f"{node.id!r} is not available in sandboxed contract "
                    "code",
                )
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in FORBIDDEN_ATTRS:
            self._flag(node, f"calls non-deterministic API .{node.attr}")
        if self.sandbox and node.attr.startswith("_"):
            # underscore attributes are the sandbox-escape surface:
            # __class__/__subclasses__/__globals__ walks, and private
            # module internals like dataclasses.sys
            self._flag(
                node, f"underscore attribute access .{node.attr} is forbidden"
            )
        if self.sandbox and node.attr in ("format", "format_map"):
            # '{0.__class__.__init__.__globals__}'.format(x) traverses
            # attributes via a string constant the static underscore
            # audit cannot see
            self._flag(
                node,
                f".{node.attr} format-string methods are forbidden in "
                "sandboxed contract code",
            )
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if self.sandbox and isinstance(node.op, ast.Pow):
            # unmetered exponentiation (10**10**8) bypasses the tick
            # budget in a single expression
            self._flag(node, "the ** operator is forbidden in sandboxed "
                             "contract code")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if self.sandbox and isinstance(node.op, ast.Pow):
            self._flag(node, "the **= operator is forbidden in sandboxed "
                             "contract code")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        # unbounded loops are a cost/DoS hazard; contracts iterate over
        # transaction components (bounded) with for-loops
        self._flag(node, "while-loops are not allowed in contract code")
        self.generic_visit(node)

    def visit_Try(self, node: ast.Try) -> None:
        for handler in node.handlers:
            if handler.type is None:
                self._flag(
                    handler,
                    "bare except can swallow verification failures",
                )
        self.generic_visit(node)


def audit_source(source: str, sandbox: bool = False) -> list[Violation]:
    tree = ast.parse(textwrap.dedent(source))
    auditor = _Auditor(sandbox=sandbox)
    auditor.visit(tree)
    return sorted(auditor.violations, key=lambda v: v.line)


def audit_contract(contract) -> list[Violation]:
    """Audit a contract CLASS's full source (verify plus every helper
    method it may call — auditing verify alone would let `verify ->
    self._helper -> random()` slip through). Module-level helpers
    outside the class remain out of scope; keep contract logic on the
    class. Raises DeterminismError on violations; returns [] when
    clean."""
    source = inspect.getsource(type(contract))
    violations = audit_source(source)
    if violations:
        raise DeterminismError(type(contract).__name__, violations)
    return violations


def audit_registered_contracts() -> dict[str, list[Violation]]:
    """Audit every registered contract (the verifier-pool gate). Returns
    {contract_name: violations} for OFFENDERS only."""
    from ..core.contracts import _CONTRACT_REGISTRY

    offenders: dict[str, list[Violation]] = {}
    for name, contract in _CONTRACT_REGISTRY.items():
        try:
            audit_contract(contract)
        except DeterminismError as e:
            offenders[name] = e.violations
        except (OSError, TypeError):
            offenders[name] = [
                Violation(0, "verify() source unavailable for audit")
            ]
    return offenders
