"""Sandboxed execution of attachment-carried contract code.

Port of corda_tpu/core/sandbox.py: the same attachment format, static
audit, operation budget, builtins allowlist and caches, so the same
attachment bytes give the same outcome in both packages. Closes two
reference gaps with one mechanism:

* AttachmentsClassLoader (core/.../serialization/AttachmentsClassLoader.kt:23)
  loads contract classes from attachment JARs so a node can verify
  transactions governed by code it never installed — here an attachment
  carries restricted Python source, content-addressed by the
  transaction itself (the tx references the attachment hash, so the
  code identity is part of what gets signed).
* The deterministic sandbox prototype (experimental/sandbox/ —
  WhitelistClassLoader + RuntimeCostAccounter.java bytecode metering)
  rejects non-deterministic APIs and meters runtime cost. Here: a
  static AST audit (experimental/determinism.py), a curated builtins
  allowlist, an import hook serving only the platform API, and AST
  instrumentation that charges an operation budget at every function
  entry and loop iteration.

Attachment source names the platform API by the reference package's
module names (`from corda_tpu.core.contracts import ...`): those bytes
are hashed into the transaction id, so they cannot change between the
packages. The import hook serves each allowed name from the port's own
module of the same path (PORT_MODULES) and never imports the reference.

Posture (same as the reference's prototype): this confines the
*accident* class — clocks, randomness, IO, runaway loops — and makes
the cost of verification boundable. CPython cannot promise a hard
security boundary from inside the process; organisational review of
attachment code covers malice, exactly as JAR signing does for the
reference.
"""

from __future__ import annotations

import ast
import json
import textwrap
from collections import OrderedDict
from typing import Any, Optional

from .contracts import Attachment, ContractViolation

# attachment wire format: MAGIC + json header + NUL + utf-8 source
CONTRACT_MAGIC = b"CORDA-CONTRACT\x00"

DEFAULT_OP_BUDGET = 200_000

# modules the sandboxed import hook will serve (the platform API a
# contract legitimately needs — the analogue of the JAR classpath the
# reference's WhitelistClassLoader exposes), by the names attachment
# source uses
ALLOWED_MODULES = (
    "corda_tpu.core.contracts",
    "corda_tpu.core.identity",
    "corda_tpu.core.clauses",
    "corda_tpu.crypto.hashes",
    "corda_tpu.finance.cash",
    "corda_tpu.finance.commercial_paper",
    "corda_tpu.finance.obligation",
    "dataclasses",
    "typing",
)

# the module that serves each allowed name here: the platform API's
# names resolve to the port's module of the same path
PORT_MODULES = {
    name: "corda_tpu_torch" + name[len("corda_tpu"):]
    if name.startswith("corda_tpu.") else name
    for name in ALLOWED_MODULES
}

_SAFE_BUILTIN_NAMES = (
    # NB deliberately absent: `pow` (unmetered big-int exponentiation is
    # an op-budget bypass) and `format`/str.format (format-string
    # attribute traversal — '{0.__class__}' — is invisible to the
    # static underscore-attribute audit because it is a string constant)
    "abs", "all", "any", "bool", "bytes", "callable", "chr", "dict",
    "divmod", "enumerate", "filter", "float", "frozenset",
    "int", "isinstance", "issubclass", "len", "list", "map",
    "max", "min", "next", "ord", "property", "repr", "reversed",
    "round", "set", "slice", "sorted", "staticmethod", "classmethod",
    "str", "sum", "super", "tuple", "type", "zip",
    # exception types contract code raises/catches
    "ArithmeticError", "AssertionError", "AttributeError", "Exception",
    "IndexError", "KeyError", "LookupError", "OverflowError",
    "RuntimeError", "StopIteration", "TypeError", "ValueError",
    "ZeroDivisionError",
)


class SandboxViolation(ContractViolation):
    """Attachment code failed the audit or broke sandbox rules."""


def _check_enabled() -> None:
    """Deployment gate: CORDA_TPU_ATTACHMENT_CODE=0 disables execution
    of attachment-shipped code entirely (nodes then only verify with
    locally installed contracts, the pre-sandbox behaviour)."""
    import os

    if os.environ.get("CORDA_TPU_ATTACHMENT_CODE", "1") == "0":
        raise ContractViolation(
            "attachment code execution is disabled on this node "
            "(CORDA_TPU_ATTACHMENT_CODE=0)"
        )


class CostLimitExceeded(ContractViolation):
    """The operation budget ran out (RuntimeCostAccounter analogue)."""


class _Instrument(ast.NodeTransformer):
    """Inject `__corda_tick__()` at every function entry and loop-body
    iteration, and route growth-capable binary operators (`*`, `+`,
    `<<`) through the size-guarded `__corda_binop__` — the AST analogue
    of the reference's bytecode instrumentation
    (costing/RuntimeCostAccounter.java). The binop guard closes the
    "single unmetered expression" budget bypass ('a' * 10**9,
    s = s + s doubling, 1 << huge): each guarded op ticks AND bounds
    the result size before computing it."""

    # operators that can grow data superlinearly per evaluation; `**`
    # is audit-rejected outright in sandbox mode but lands on the
    # guard's refusal branch if a caller runs with audit=False
    _GUARDED_OPS = {
        ast.Mult: "*", ast.Add: "+", ast.LShift: "<<", ast.Pow: "**",
    }

    @staticmethod
    def _tick() -> ast.stmt:
        return ast.Expr(
            ast.Call(
                func=ast.Name("__corda_tick__", ast.Load()),
                args=[],
                keywords=[],
            )
        )

    def _with_tick(self, node):
        self.generic_visit(node)
        node.body.insert(0, self._tick())
        return node

    def visit_FunctionDef(self, node):
        return self._with_tick(node)

    def visit_AsyncFunctionDef(self, node):  # pragma: no cover - audited out
        raise SandboxViolation("async functions are not allowed")

    def visit_For(self, node):
        return self._with_tick(node)

    def visit_While(self, node):
        # the static audit already rejects while; keep the charge in
        # case a caller runs with audit=False
        return self._with_tick(node)

    def _guard_call(self, sym: str, left, right, at):
        return ast.copy_location(
            ast.Call(
                func=ast.Name("__corda_binop__", ast.Load()),
                args=[ast.copy_location(ast.Constant(sym), at), left, right],
                keywords=[],
            ),
            at,
        )

    def visit_BinOp(self, node):
        self.generic_visit(node)
        sym = self._GUARDED_OPS.get(type(node.op))
        if sym is None:
            return node
        return self._guard_call(sym, node.left, node.right, node)

    def visit_AugAssign(self, node):
        self.generic_visit(node)
        sym = self._GUARDED_OPS.get(type(node.op))
        if sym is None:
            return node
        # desugar `target op= value` into `target = guard(target, value)`
        # (in-place list aliasing semantics are not preserved, an
        # accepted sandbox deviation). Attribute/Subscript targets
        # evaluate their object/index subexpressions into temps FIRST —
        # naively re-evaluating the target as a Load would run a
        # side-effecting index (xs[next(it)] += 1) twice.
        import copy as _copy

        def assign_tmp(name: str, value) -> ast.stmt:
            return ast.copy_location(
                ast.Assign(
                    targets=[ast.copy_location(
                        ast.Name(name, ast.Store()), node)],
                    value=value,
                ),
                node,
            )

        if isinstance(node.target, ast.Name):
            load = ast.copy_location(
                ast.Name(node.target.id, ast.Load()), node
            )
            return ast.copy_location(
                ast.Assign(
                    targets=[node.target],
                    value=self._guard_call(sym, load, node.value, node),
                ),
                node,
            )
        if isinstance(node.target, ast.Attribute):
            pre = assign_tmp("__corda_aug_obj__", node.target.value)
            obj = ast.copy_location(
                ast.Name("__corda_aug_obj__", ast.Load()), node
            )
            load = ast.copy_location(
                ast.Attribute(obj, node.target.attr, ast.Load()), node
            )
            store = ast.copy_location(
                ast.Attribute(
                    _copy.deepcopy(obj), node.target.attr, ast.Store()
                ),
                node,
            )
        elif isinstance(node.target, ast.Subscript):
            obj = ast.copy_location(
                ast.Name("__corda_aug_obj__", ast.Load()), node
            )
            if isinstance(node.target.slice, ast.Slice):
                # a Slice node cannot be hoisted into a temp; its
                # bounds are re-evaluated (plain names/constants in
                # practice — slice-assignment with side-effecting
                # bounds keeps the (documented) re-evaluation caveat)
                pre = [assign_tmp("__corda_aug_obj__", node.target.value)]
                key = node.target.slice
            else:
                pre = [
                    assign_tmp("__corda_aug_obj__", node.target.value),
                    assign_tmp("__corda_aug_key__", node.target.slice),
                ]
                key = ast.copy_location(
                    ast.Name("__corda_aug_key__", ast.Load()), node
                )
            load = ast.copy_location(ast.Subscript(obj, key, ast.Load()), node)
            store = ast.copy_location(
                ast.Subscript(
                    _copy.deepcopy(obj), _copy.deepcopy(key), ast.Store()
                ),
                node,
            )
        else:   # pragma: no cover - not reachable via augassign grammar
            raise SandboxViolation("unsupported augmented-assignment target")
        assign = ast.copy_location(
            ast.Assign(
                targets=[store],
                value=self._guard_call(sym, load, node.value, node),
            ),
            node,
        )
        out = pre if isinstance(pre, list) else [pre]
        return out + [assign]


# growth bounds enforced by __corda_binop__: generous for legitimate
# contract math (crypto-sized ints, component lists), far below DoS size
MAX_INT_BITS = 8192
MAX_SEQ_LEN = 1_000_000

_SIZED = (str, bytes, list, tuple)


def _sandbox_env(budget_cell: list[int]) -> dict[str, Any]:
    import builtins as _b

    def __corda_tick__():
        budget_cell[0] -= 1
        if budget_cell[0] < 0:
            raise CostLimitExceeded(
                "contract exceeded its operation budget"
            )

    def __corda_binop__(sym: str, a, b):
        __corda_tick__()
        if sym == "*":
            if isinstance(a, int) and isinstance(b, _SIZED):
                a, b = b, a
            if isinstance(a, _SIZED) and isinstance(b, int):
                if b > 0 and len(a) * b > MAX_SEQ_LEN:
                    raise CostLimitExceeded(
                        f"sequence repetition of {len(a) * b} elements "
                        f"exceeds the {MAX_SEQ_LEN}-element cap"
                    )
            elif isinstance(a, int) and isinstance(b, int):
                if a.bit_length() + b.bit_length() > MAX_INT_BITS:
                    raise CostLimitExceeded(
                        f"integer product exceeds {MAX_INT_BITS} bits"
                    )
            return a * b
        if sym == "+":
            if (
                isinstance(a, _SIZED)
                and isinstance(b, _SIZED)
                and len(a) + len(b) > MAX_SEQ_LEN
            ):
                raise CostLimitExceeded(
                    f"concatenation of {len(a) + len(b)} elements "
                    f"exceeds the {MAX_SEQ_LEN}-element cap"
                )
            return a + b
        if sym == "<<":
            if isinstance(a, int) and isinstance(b, int):
                if b > MAX_INT_BITS or a.bit_length() + b > MAX_INT_BITS:
                    raise CostLimitExceeded(
                        f"left shift result exceeds {MAX_INT_BITS} bits"
                    )
            return a << b
        # `**`: audit-rejected in sandbox mode; refuse even with
        # audit=False — unmetered exponentiation is the budget bypass
        raise SandboxViolation(
            f"operator {sym!r} is not permitted in sandboxed contract code"
        )

    def _range(*args):
        r = range(*args)
        if len(r) > max(budget_cell[0], 0) + 1:
            raise CostLimitExceeded(
                f"range({len(r)}) exceeds the remaining operation budget"
            )
        return r

    def _import(name, globals=None, locals=None, fromlist=(), level=0):
        if level != 0:
            raise SandboxViolation("relative imports are not allowed")
        if name not in ALLOWED_MODULES:
            raise SandboxViolation(
                f"import of {name!r} is not allowed in contract code"
            )
        if not fromlist and "." in name:
            raise SandboxViolation(
                "use 'from X import Y' for dotted modules in contract code"
            )
        import importlib
        import types

        module = importlib.import_module(PORT_MODULES[name])
        # expose only the module's public non-module names: raw module
        # objects leak their own imports (dataclasses.sys -> os escape)
        return types.SimpleNamespace(
            **{
                k: v
                for k, v in vars(module).items()
                if not k.startswith("_")
                and not isinstance(v, types.ModuleType)
            }
        )

    def _iter(obj):
        # one-arg form only: iter(callable, sentinel) builds infinite
        # iterators that C-level consumers (any/sum/...) drain without
        # ever passing an instrumented tick point
        return iter(obj)

    safe = {n: getattr(_b, n) for n in _SAFE_BUILTIN_NAMES}
    safe["range"] = _range
    safe["iter"] = _iter
    safe["__import__"] = _import
    safe["__build_class__"] = _b.__build_class__
    safe["ContractViolation"] = ContractViolation
    return {
        "__builtins__": safe,
        "__corda_tick__": __corda_tick__,
        "__corda_binop__": __corda_binop__,
        "__name__": "corda_contract_sandbox",
    }


class SandboxedContract:
    """Wraps an attachment-loaded contract: every verify() call runs
    under a fresh operation budget."""

    def __init__(self, inner, op_budget: int, budget_cell: list[int]):
        self._inner = inner
        self._op_budget = op_budget
        self._budget_cell = budget_cell

    def verify(self, ltx) -> None:
        self._budget_cell[0] = self._op_budget
        try:
            self._inner.verify(ltx)
        except RecursionError as e:
            # the interpreter's own limit can fire before the tick
            # budget on tight recursion — same verdict either way
            raise CostLimitExceeded(
                "contract exceeded the recursion limit (cost budget)"
            ) from e


def _exec_sandboxed(
    source: str, op_budget: int, audit: bool
) -> tuple[dict, list[int]]:
    """The one compile-in-sandbox pipeline: dedent, sandbox-mode audit,
    tick instrumentation, restricted exec. Returns (env, budget_cell)."""
    from ..experimental import determinism

    source = textwrap.dedent(source)
    if audit:
        violations = determinism.audit_source(source, sandbox=True)
        if violations:
            raise SandboxViolation(
                "attachment code fails the determinism audit: "
                + "; ".join(f"L{v.line}: {v.message}" for v in violations)
            )
    tree = _Instrument().visit(ast.parse(source))
    ast.fix_missing_locations(tree)
    code = compile(tree, "<contract-attachment>", "exec")
    budget_cell = [op_budget]
    env = _sandbox_env(budget_cell)
    exec(code, env)  # noqa: S102 - the sandbox IS the point
    return env, budget_cell


def load_contract_source(
    source: str,
    class_name: str,
    op_budget: int = DEFAULT_OP_BUDGET,
    audit: bool = True,
) -> SandboxedContract:
    """Compile + exec restricted contract source, returning a budgeted
    contract instance exposing `verify(ltx)`."""
    env, budget_cell = _exec_sandboxed(source, op_budget, audit)
    cls = env.get(class_name)
    if cls is None:
        raise SandboxViolation(
            f"attachment does not define contract class {class_name!r}"
        )
    return SandboxedContract(cls(), op_budget, budget_cell)


# ---------------------------------------------------------------------------
# attachment wire format


def make_contract_attachment(
    contract_name: str,
    class_name: str,
    source: str,
    upgrades_from: Optional[str] = None,
) -> Attachment:
    """Package contract source as a content-addressed attachment.

    `upgrades_from` marks the attachment as a ContractUpgradeFlow code
    delivery: the source must additionally define `convert(old_state)`
    (the authorised state conversion the reference registers via
    `UpgradedContract.upgrade`, ContractUpgradeFlow.kt)."""
    header = {"contract": contract_name, "class": class_name}
    if upgrades_from is not None:
        header["upgrades"] = upgrades_from
    return Attachment.of(
        CONTRACT_MAGIC
        + json.dumps(header, sort_keys=True).encode()
        + b"\x00"
        + textwrap.dedent(source).encode()
    )


def _parse_header(att: Attachment) -> Optional[tuple[dict, str]]:
    data = att.data
    if not data.startswith(CONTRACT_MAGIC):
        return None
    rest = data[len(CONTRACT_MAGIC):]
    sep = rest.find(b"\x00")
    if sep < 0:
        return None
    try:
        header = json.loads(rest[:sep].decode())
        return dict(header), rest[sep + 1 :].decode()
    except (ValueError, UnicodeDecodeError):
        return None


def parse_contract_attachment(
    att: Attachment,
) -> Optional[tuple[str, str, str]]:
    """(contract_name, class_name, source) if `att` carries contract
    code, else None."""
    parsed = _parse_header(att)
    if parsed is None:
        return None
    header, source = parsed
    try:
        return str(header["contract"]), str(header["class"]), source
    except KeyError:
        return None


class OverlappingAttachments(ContractViolation):
    """Two attachments with different hashes both claim to provide the
    same contract — ambiguous code identity the verifier must refuse
    (AttachmentsClassLoader.kt:28,43-47 `OverlappingAttachments`)."""


# bounded LRU caches keyed by attachment hash: a long-running notary
# seeing unique attachments (attacker or churn) must not grow compiled
# SandboxedContract objects without eviction
_CACHE_CAP = 128
_loaded_cache: OrderedDict = OrderedDict()
_upgrade_cache: OrderedDict = OrderedDict()


def _cache_get(cache, key):
    val = cache.get(key)
    if val is not None:
        cache.move_to_end(key)
    return val


def _cache_put(cache, key, val) -> None:
    cache[key] = val
    cache.move_to_end(key)
    while len(cache) > _CACHE_CAP:
        cache.popitem(last=False)


def contract_from_attachments(name: str, attachments) -> SandboxedContract:
    """Resolve contract `name` from a transaction's attachments
    (AttachmentsClassLoader.kt:23 analogue). The attachment hash is
    referenced by the transaction, so the loaded code is exactly what
    the signers signed over. Cached by attachment id.

    Scans ALL attachments: two distinct attachments claiming the same
    contract raise OverlappingAttachments rather than silently running
    whichever sorts first (AttachmentsClassLoader.kt:43-47)."""
    _check_enabled()
    matches: list[tuple[Any, str, str]] = []   # (att, class_name, source)
    seen_ids: set[bytes] = set()
    for att in attachments:
        if not isinstance(att, Attachment):
            continue
        if att.id.bytes_ in seen_ids:
            continue   # the same attachment listed twice is not ambiguous
        cached = _cache_get(_loaded_cache, att.id.bytes_)
        if cached is not None:
            if cached[0] == name:
                seen_ids.add(att.id.bytes_)
                matches.append((att, "", ""))
            continue
        parsed = parse_contract_attachment(att)
        if parsed is None:
            continue
        att_name, class_name, source = parsed
        if att_name != name:
            continue
        seen_ids.add(att.id.bytes_)
        matches.append((att, class_name, source))
    if not matches:
        raise ContractViolation(
            f"unknown contract {name!r}: not installed and no attachment "
            "carries it"
        )
    if len(matches) > 1:
        hashes = ", ".join(m[0].id.bytes_.hex()[:16] for m in matches)
        raise OverlappingAttachments(
            f"{len(matches)} attachments declare contract {name!r} "
            f"({hashes}): ambiguous contract code identity"
        )
    att, class_name, source = matches[0]
    cached = _cache_get(_loaded_cache, att.id.bytes_)
    if cached is not None:
        return cached[1]
    contract = load_contract_source(source, class_name)
    _cache_put(_loaded_cache, att.id.bytes_, (name, contract))
    return contract


def upgrade_from_attachments(
    old_contract: str, new_contract: str, attachments
):
    """A budgeted `convert(old_state)` from an upgrade attachment, or
    None. The ContractUpgradeFlow code-delivery path: nodes that never
    installed the new cordapp verify the upgrade with the conversion
    the transaction itself ships (and states under the new contract
    verify afterwards via contract_from_attachments)."""
    for att in attachments:
        if not isinstance(att, Attachment):
            continue
        parsed = _parse_header(att)
        if parsed is None:
            continue
        header, source = parsed
        if (
            header.get("upgrades") != old_contract
            or header.get("contract") != new_contract
        ):
            continue
        _check_enabled()
        cached = _cache_get(_upgrade_cache, att.id.bytes_)
        if cached is not None:
            return cached
        env, budget_cell = _exec_sandboxed(
            source, DEFAULT_OP_BUDGET, audit=True
        )
        convert = env.get("convert")
        if convert is None:
            raise SandboxViolation(
                "upgrade attachment does not define convert(old_state)"
            )

        def budgeted_convert(state, _c=convert, _cell=budget_cell):
            _cell[0] = DEFAULT_OP_BUDGET
            try:
                return _c(state)
            except RecursionError as e:
                raise CostLimitExceeded(
                    "conversion exceeded the recursion limit (cost budget)"
                ) from e

        _cache_put(_upgrade_cache, att.id.bytes_, budgeted_convert)
        return budgeted_convert
    return None
