"""Vault query DSL: criteria AST compiled to SQL or an in-memory filter.

Port of corda_tpu/node/vault_query.py, unchanged: the same criteria,
the same SQL over the same `vault_states` columns, and the same page
and sort semantics, so both packages answer a query with equal pages.

Reference: the `QueryCriteria` hierarchy (core/.../node/services/vault/
QueryCriteria.kt:23 — VaultQueryCriteria, LinearStateQueryCriteria,
FungibleAssetQueryCriteria, And/Or composition), paging + sorting
(`PageSpecification`, `Sort`), the `VaultService.queryBy/trackBy` API
(core/.../node/services/VaultService.kt:157, CordaRPCOps.vaultQueryBy
CordaRPCOps.kt:92), and `HibernateQueryCriteriaParser` (node/.../vault/
HibernateQueryCriteriaParser.kt) which turns the AST into JPA SQL.

Here every criterion compiles BOTH ways from one definition:
`sql()` emits a WHERE fragment over the denormalised `vault_states`
table (persistence.py), `matches()` evaluates against live rows — so
the in-memory Ring-2/3 vault and the sqlite vault answer identically,
and tests assert exactly that.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..core import serialization as ser
from ..core.contracts import StateAndRef, UniqueIdentifier
from ..crypto import composite as comp

# -- status enum -------------------------------------------------------------

UNCONSUMED = "UNCONSUMED"
CONSUMED = "CONSUMED"
ALL = "ALL"

_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">": lambda a, b: a is not None and a > b,
    ">=": lambda a, b: a is not None and a >= b,
    "<": lambda a, b: a is not None and a < b,
    "<=": lambda a, b: a is not None and a <= b,
}
_SQL_OPS = {"==": "=", "!=": "<>", ">": ">", ">=": ">=", "<": "<", "<=": "<="}


@dataclass(frozen=True)
class ColumnPredicate:
    """op ∈ {==, !=, >, >=, <, <=} applied to a comparable column."""

    op: str
    value: Any

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown comparison op {self.op!r}")


# -- row model ---------------------------------------------------------------


@dataclass(frozen=True)
class VaultRow:
    """The queryable projection of one vault state — what the sqlite
    table stores per row and what the in-memory vault synthesises on
    the fly (the MappedSchema projection, PersistentTypes.kt)."""

    state_and_ref: StateAndRef
    status: str                       # UNCONSUMED | CONSUMED
    contract_tag: str
    notary_name: Optional[str]
    quantity: Optional[int]
    product: Optional[str]
    issuer_name: Optional[str]
    linear_id: Optional[bytes]
    participant_fps: tuple[bytes, ...]
    recorded_at: int


def row_of(sar: StateAndRef, status: str, recorded_at: int) -> VaultRow:
    """Project a StateAndRef into its queryable row (in-memory path)."""
    data = sar.state.data
    amount = getattr(data, "amount", None)
    quantity = product = issuer = None
    if amount is not None:
        quantity = getattr(amount, "quantity", None)
        token = getattr(amount, "token", None)
        product = token
        if token is not None and hasattr(token, "issuer"):
            issuer = token.issuer.party.name
            product = token.product
        product = None if product is None else str(product)
    lid = getattr(data, "linear_id", None)
    lid_b = None
    if lid is not None:
        lid_b = lid if isinstance(lid, bytes) else ser.encode(lid)
    from .services import _owning_key_of

    fps = []
    for p in data.participants:
        for leaf in comp.leaves_of(_owning_key_of(p)):
            fps.append(leaf.fingerprint())
    return VaultRow(
        state_and_ref=sar,
        status=status,
        contract_tag=type(data).__name__,
        notary_name=sar.state.notary.name if sar.state.notary else None,
        quantity=quantity,
        product=product,
        issuer_name=issuer,
        linear_id=lid_b,
        participant_fps=tuple(fps),
        recorded_at=recorded_at,
    )


# -- criteria AST ------------------------------------------------------------


class QueryCriteria:
    """Base: composable with & and | (QueryCriteria.kt and/or)."""

    status: str = UNCONSUMED

    def __and__(self, other: "QueryCriteria") -> "QueryCriteria":
        return And(self, other)

    def __or__(self, other: "QueryCriteria") -> "QueryCriteria":
        return Or(self, other)

    # each criterion implements:
    def matches(self, row: VaultRow) -> bool:
        raise NotImplementedError

    def sql(self) -> tuple[str, list]:
        """(where_fragment, params) over vault_states AS v."""
        raise NotImplementedError


def _status_match(status: str, row: VaultRow) -> bool:
    return status == ALL or row.status == status


def _status_sql(status: str) -> tuple[str, list]:
    if status == ALL:
        return "1=1", []
    return "v.status = ?", [0 if status == UNCONSUMED else 1]


@dataclass(frozen=True)
class VaultQueryCriteria(QueryCriteria):
    """General criteria (QueryCriteria.VaultQueryCriteria): status,
    state types, notary, recording-time window."""

    status: str = UNCONSUMED
    contract_state_types: Optional[tuple] = None   # classes or tag strings
    notary_names: Optional[tuple[str, ...]] = None
    recorded_between: Optional[tuple[int, int]] = None   # [from, until) µs

    def _tags(self) -> Optional[list[str]]:
        if self.contract_state_types is None:
            return None
        return [
            t if isinstance(t, str) else t.__name__
            for t in self.contract_state_types
        ]

    def matches(self, row: VaultRow) -> bool:
        if not _status_match(self.status, row):
            return False
        tags = self._tags()
        if tags is not None and row.contract_tag not in tags:
            return False
        if self.notary_names is not None and row.notary_name not in self.notary_names:
            return False
        if self.recorded_between is not None:
            lo, hi = self.recorded_between
            if not (lo <= row.recorded_at < hi):
                return False
        return True

    def sql(self) -> tuple[str, list]:
        frags, params = [], []
        s, p = _status_sql(self.status)
        frags.append(s)
        params += p
        tags = self._tags()
        if tags is not None:
            frags.append(
                f"v.contract_tag IN ({','.join('?' * len(tags))})"
            )
            params += tags
        if self.notary_names is not None:
            frags.append(f"v.notary IN ({','.join('?' * len(self.notary_names))})")
            params += list(self.notary_names)
        if self.recorded_between is not None:
            frags.append("v.recorded_at >= ? AND v.recorded_at < ?")
            params += list(self.recorded_between)
        return " AND ".join(frags), params


@dataclass(frozen=True)
class FungibleAssetQueryCriteria(QueryCriteria):
    """Fungible-schema criteria (QueryCriteria.FungibleAssetQuery-
    Criteria): quantity comparisons, product, issuer, participant."""

    status: str = UNCONSUMED
    quantity: Optional[ColumnPredicate] = None
    product: Optional[str] = None
    issuer_names: Optional[tuple[str, ...]] = None
    participant_key: Optional[Any] = None   # PublicKey/CompositeKey

    def matches(self, row: VaultRow) -> bool:
        if not _status_match(self.status, row):
            return False
        if row.quantity is None:
            return False
        if self.quantity is not None and not _OPS[self.quantity.op](
            row.quantity, self.quantity.value
        ):
            return False
        if self.product is not None and row.product != self.product:
            return False
        if self.issuer_names is not None and row.issuer_name not in self.issuer_names:
            return False
        if self.participant_key is not None:
            fps = {
                leaf.fingerprint()
                for leaf in comp.leaves_of(self.participant_key)
            }
            if not fps & set(row.participant_fps):
                return False
        return True

    def sql(self) -> tuple[str, list]:
        frags, params = [], []
        s, p = _status_sql(self.status)
        frags.append(s)
        params += p
        frags.append("v.quantity IS NOT NULL")
        if self.quantity is not None:
            frags.append(f"v.quantity {_SQL_OPS[self.quantity.op]} ?")
            params.append(self.quantity.value)
        if self.product is not None:
            frags.append("v.token = ?")
            params.append(self.product)
        if self.issuer_names is not None:
            frags.append(f"v.issuer IN ({','.join('?' * len(self.issuer_names))})")
            params += list(self.issuer_names)
        if self.participant_key is not None:
            fps = [
                leaf.fingerprint()
                for leaf in comp.leaves_of(self.participant_key)
            ]
            frags.append(
                "EXISTS (SELECT 1 FROM vault_parts vp WHERE"
                " vp.ref_tx = v.ref_tx AND vp.ref_index = v.ref_index"
                f" AND vp.fingerprint IN ({','.join('?' * len(fps))}))"
            )
            params += fps
        return " AND ".join(frags), params


@dataclass(frozen=True)
class LinearStateQueryCriteria(QueryCriteria):
    """Linear-schema criteria (QueryCriteria.LinearStateQueryCriteria):
    match by linear id thread / external id."""

    status: str = UNCONSUMED
    linear_ids: Optional[tuple[UniqueIdentifier, ...]] = None
    external_ids: Optional[tuple[str, ...]] = None

    def _encoded_ids(self) -> Optional[list[bytes]]:
        if self.linear_ids is None:
            return None
        return [ser.encode(lid) for lid in self.linear_ids]

    def matches(self, row: VaultRow) -> bool:
        if not _status_match(self.status, row):
            return False
        if row.linear_id is None:
            return False
        ids = self._encoded_ids()
        if ids is not None and row.linear_id not in ids:
            return False
        if self.external_ids is not None:
            try:
                lid = ser.decode(row.linear_id)
            except ser.SerializationError:
                return False   # raw-bytes linear ids carry no external id
            if (
                not isinstance(lid, UniqueIdentifier)
                or lid.external_id not in self.external_ids
            ):
                return False
        return True

    def sql(self) -> tuple[str, list]:
        frags, params = [], []
        s, p = _status_sql(self.status)
        frags.append(s)
        params += p
        frags.append("v.linear_id IS NOT NULL")
        ids = self._encoded_ids()
        if ids is not None:
            frags.append(f"v.linear_id IN ({','.join('?' * len(ids))})")
            params += ids
        if self.external_ids is not None:
            # external id has no dedicated column: match candidate rows
            # in SQL, refine in Python (the parser's custom-criteria
            # fallback path).
            pass
        return " AND ".join(frags), params

    def needs_refine(self) -> bool:
        return self.external_ids is not None


@dataclass(frozen=True)
class And(QueryCriteria):
    left: QueryCriteria
    right: QueryCriteria

    def matches(self, row: VaultRow) -> bool:
        return self.left.matches(row) and self.right.matches(row)

    def sql(self) -> tuple[str, list]:
        ls, lp = self.left.sql()
        rs, rp = self.right.sql()
        return f"({ls}) AND ({rs})", lp + rp


@dataclass(frozen=True)
class CustomColumnCriteria(QueryCriteria):
    """Criterion over a CorDapp-registered MappedSchema column
    (VaultCustomQueryCriteria, QueryCriteria.kt + the custom-column
    branch of HibernateQueryCriteriaParser.kt).

    SQL path: row-value subquery into the schema's own table; in-memory
    path: run the schema's `project` on the live state. States the
    schema does not apply to never match.
    """

    schema_name: str
    column: str
    predicate: ColumnPredicate
    status: str = UNCONSUMED

    def _schema(self):
        from .schemas import schema_by_name

        return schema_by_name(self.schema_name)

    def matches(self, row: VaultRow) -> bool:
        schema = self._schema()
        # keep backend parity: the SQL path raises on an unknown
        # column, so the in-memory path must too (not return False).
        # Validated once per criteria (matches runs per vault row).
        if not self.__dict__.get("_column_ok"):
            if self.column not in {c for c, _ in schema.columns}:
                raise ValueError(
                    f"schema {schema.name!r} has no column {self.column!r}"
                )
            object.__setattr__(self, "_column_ok", True)
        if not _status_match(self.status, row):
            return False
        data = row.state_and_ref.state.data
        if not isinstance(data, schema.applies_to):
            return False
        value = schema.project(data).get(self.column)
        if value is None:
            # SQL three-valued logic: NULL never satisfies any
            # comparison (incl. <>), and both backends must agree
            return False
        return _OPS[self.predicate.op](value, self.predicate.value)

    def sql(self) -> tuple[str, list]:
        schema = self._schema()
        if self.column not in {c for c, _ in schema.columns}:
            raise ValueError(
                f"schema {schema.name!r} has no column {self.column!r}"
            )
        ss, sp = _status_sql(self.status)
        frag = (
            f"({ss}) AND (v.ref_tx, v.ref_index) IN "
            f"(SELECT ref_tx, ref_index FROM {schema.table}"
            f" WHERE {self.column} {_SQL_OPS[self.predicate.op]} ?)"
        )
        return frag, sp + [self.predicate.value]


@dataclass(frozen=True)
class Or(QueryCriteria):
    left: QueryCriteria
    right: QueryCriteria

    def matches(self, row: VaultRow) -> bool:
        return self.left.matches(row) or self.right.matches(row)

    def sql(self) -> tuple[str, list]:
        ls, lp = self.left.sql()
        rs, rp = self.right.sql()
        return f"({ls}) OR ({rs})", lp + rp


def _needs_refine(criteria: QueryCriteria) -> bool:
    if isinstance(criteria, LinearStateQueryCriteria):
        return criteria.needs_refine()
    if isinstance(criteria, (And, Or)):
        return _needs_refine(criteria.left) or _needs_refine(criteria.right)
    return False


# -- paging & sorting --------------------------------------------------------


@dataclass(frozen=True)
class PageSpecification:
    """1-based pages (QueryCriteria.kt PageSpecification)."""

    page_number: int = 1
    page_size: int = 200

    def __post_init__(self):
        if self.page_number < 1 or self.page_size < 1:
            raise ValueError("bad page spec")


_SORT_COLUMNS = {
    "recorded_at": ("v.recorded_at", lambda r: r.recorded_at),
    "quantity": ("v.quantity", lambda r: r.quantity or 0),
    "contract_tag": ("v.contract_tag", lambda r: r.contract_tag),
    "ref": (
        "v.ref_tx, v.ref_index",
        lambda r: (r.state_and_ref.ref.txhash.bytes_, r.state_and_ref.ref.index),
    ),
}


@dataclass(frozen=True)
class Sort:
    column: str = "ref"
    descending: bool = False

    def __post_init__(self):
        if self.column not in _SORT_COLUMNS:
            raise ValueError(
                f"unsortable column {self.column!r}; "
                f"choose from {sorted(_SORT_COLUMNS)}"
            )


@dataclass(frozen=True)
class Page:
    """One result page + the total row count before paging
    (Vault.Page: states + totalStatesAvailable)."""

    states: tuple[StateAndRef, ...]
    total_states_available: int


# -- execution ---------------------------------------------------------------


def run_in_memory(
    rows: list[VaultRow],
    criteria: QueryCriteria,
    paging: PageSpecification = PageSpecification(),
    sorting: Sort = Sort(),
) -> Page:
    hits = [r for r in rows if criteria.matches(r)]
    _, key = _SORT_COLUMNS[sorting.column]
    hits.sort(key=key, reverse=sorting.descending)
    lo = (paging.page_number - 1) * paging.page_size
    page = hits[lo : lo + paging.page_size]
    return Page(tuple(r.state_and_ref for r in page), len(hits))


def run_sql(
    db,
    criteria: QueryCriteria,
    paging: PageSpecification = PageSpecification(),
    sorting: Sort = Sort(),
) -> Page:
    """Execute over the vault_states table (persistence.py schema). When
    a criterion needs Python refinement (e.g. external ids), rows are
    refined before paging so page boundaries stay correct."""
    where, params = criteria.sql()
    order_col, _ = _SORT_COLUMNS[sorting.column]
    direction = "DESC" if sorting.descending else "ASC"
    order = ", ".join(
        f"{c} {direction}" for c in order_col.split(", ")
    )
    base = (
        "SELECT v.ref_tx, v.ref_index, v.state, v.status, v.contract_tag,"
        " v.notary, v.quantity, v.token, v.issuer, v.linear_id,"
        " v.recorded_at FROM vault_states v"
        f" WHERE {where} ORDER BY {order}"
    )
    refine = _needs_refine(criteria)
    if not refine:
        lo = (paging.page_number - 1) * paging.page_size
        rows = db.query(base + " LIMIT ? OFFSET ?", (*params, paging.page_size, lo))
        total = db.query(
            f"SELECT COUNT(*) FROM vault_states v WHERE {where}", tuple(params)
        )[0][0]
        return Page(tuple(_sar_of(r) for r in rows), total)
    raw = db.query(base, tuple(params))
    # participant fingerprints only materialise if the criteria tree can
    # read them, and then in one batched query — not one per row
    fps_map = (
        _fps_map(db, [(bytes(r[0]), r[1]) for r in raw])
        if _needs_fps(criteria)
        else {}
    )
    vrows = [_vault_row_of(r, fps_map) for r in raw]
    hits = [v for v in vrows if criteria.matches(v)]
    lo = (paging.page_number - 1) * paging.page_size
    page = hits[lo : lo + paging.page_size]
    return Page(tuple(v.state_and_ref for v in page), len(hits))


def _needs_fps(criteria: QueryCriteria) -> bool:
    if isinstance(criteria, FungibleAssetQueryCriteria):
        return criteria.participant_key is not None
    if isinstance(criteria, (And, Or)):
        return _needs_fps(criteria.left) or _needs_fps(criteria.right)
    return False


def _fps_map(db, refs: list[tuple[bytes, int]]) -> dict:
    out: dict = {r: [] for r in refs}
    CHUNK = 100
    for i in range(0, len(refs), CHUNK):
        chunk = refs[i : i + CHUNK]
        where = " OR ".join("(ref_tx=? AND ref_index=?)" for _ in chunk)
        params = [x for ref in chunk for x in ref]
        for tx, idx, fp in db.query(
            f"SELECT ref_tx, ref_index, fingerprint FROM vault_parts"
            f" WHERE {where}",
            tuple(params),
        ):
            out[(bytes(tx), idx)].append(bytes(fp))
    return out


def _sar_of(r) -> StateAndRef:
    from ..core.contracts import StateRef
    from ..crypto.hashes import SecureHash

    return StateAndRef(
        ser.decode(bytes(r[2])), StateRef(SecureHash(bytes(r[0])), r[1])
    )


def _vault_row_of(r, fps_map: dict) -> VaultRow:
    sar = _sar_of(r)
    return VaultRow(
        state_and_ref=sar,
        status=UNCONSUMED if r[3] == 0 else CONSUMED,
        contract_tag=r[4],
        notary_name=r[5],
        quantity=r[6],
        product=r[7],
        issuer_name=r[8],
        linear_id=None if r[9] is None else bytes(r[9]),
        participant_fps=tuple(fps_map.get((bytes(r[0]), r[1]), ())),
        recorded_at=r[10],
    )


# ---------------------------------------------------------------------------
# wire registration — criteria travel over RPC (CordaRPCOps.vaultQueryBy
# takes the criteria AST from the client; the reference serializes the
# QueryCriteria object graph over Kryo/AMQP)

for _cls in (
    ColumnPredicate,
    FungibleAssetQueryCriteria,
    LinearStateQueryCriteria,
    And,
    Or,
    PageSpecification,
    Sort,
    Page,
):
    ser.serializable(_cls)

# VaultQueryCriteria may hold Python classes in contract_state_types;
# they normalise to tag strings on the wire (the SQL compiler and
# matcher treat both identically).
ser.register_custom(
    VaultQueryCriteria,
    "VaultQueryCriteria",
    lambda c: [
        c.status,
        None if c.contract_state_types is None else c._tags(),
        None if c.notary_names is None else list(c.notary_names),
        None if c.recorded_between is None else list(c.recorded_between),
    ],
    lambda v: VaultQueryCriteria(
        v[0],
        None if v[1] is None else tuple(v[1]),
        None if v[2] is None else tuple(v[2]),
        None if v[3] is None else tuple(v[3]),
    ),
)
