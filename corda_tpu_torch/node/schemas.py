"""CorDapp-registered vault schemas — the MappedSchema analogue.

Port of corda_tpu/node/schemas.py, unchanged: the same schema names,
tables and column types, so a vault database written by either package
holds the same projection tables.

Reference: `MappedSchema`/`PersistentState` let a CorDapp declare an
ORM projection of its states (core/.../schemas/PersistentTypes.kt);
`HibernateObserver` persists the projection on every vault update
(node/.../services/schema/) and `HibernateQueryCriteriaParser` accepts
custom-column criteria against it (VaultCustomQueryCriteria).

Here a schema is a declarative table: name, columns (sqlite types) and
a pure `project(state_data) -> {column: value}` function. The
persistent vault writes one row per produced state into the schema's
own table (keyed by StateRef, joined against vault_states for status),
and `CustomColumnCriteria` (vault_query.py) compiles to a row-value
subquery in SQL or evaluates `project` on the fly in memory — both
backends answer identically, same as the built-in columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

_SQL_TYPES = {"TEXT", "INTEGER", "REAL", "BLOB"}


@dataclass(frozen=True)
class MappedSchema:
    """A CorDapp's declared projection of one state family."""

    name: str                                  # e.g. "cash.v1"
    version: int
    table: str                                 # sqlite table name
    columns: tuple[tuple[str, str], ...]       # (column, sqlite type)
    applies_to: type                           # state data class
    project: Callable[[Any], dict]             # state -> {column: value}

    def __post_init__(self):
        if not self.table.replace("_", "").isalnum():
            raise ValueError(f"unsafe table name {self.table!r}")
        for col, typ in self.columns:
            if not col.replace("_", "").isalnum():
                raise ValueError(f"unsafe column name {col!r}")
            if typ.upper() not in _SQL_TYPES:
                raise ValueError(f"unknown sqlite type {typ!r} for {col!r}")

    def ddl(self) -> str:
        cols = ", ".join(f"{c} {t}" for c, t in self.columns)
        return (
            f"CREATE TABLE IF NOT EXISTS {self.table} ("
            "ref_tx BLOB NOT NULL, ref_index INTEGER NOT NULL, "
            f"{cols}, PRIMARY KEY (ref_tx, ref_index))"
        )

    def row_values(self, state_data) -> tuple:
        proj = self.project(state_data)
        unknown = set(proj) - {c for c, _ in self.columns}
        if unknown:
            raise ValueError(
                f"projection of {type(state_data).__name__} produced "
                f"undeclared columns {sorted(unknown)}"
            )
        return tuple(proj.get(c) for c, _ in self.columns)


_SCHEMA_REGISTRY: dict[str, MappedSchema] = {}


def register_schema(schema: MappedSchema) -> None:
    """Install a schema process-wide (the CorDapp-scan analogue: call
    from the cordapp module, next to register_contract)."""
    existing = _SCHEMA_REGISTRY.get(schema.name)
    if existing is not None and existing != schema:
        raise ValueError(f"schema {schema.name!r} already registered")
    _SCHEMA_REGISTRY[schema.name] = schema


def schema_by_name(name: str) -> MappedSchema:
    s = _SCHEMA_REGISTRY.get(name)
    if s is None:
        raise KeyError(f"unknown schema {name!r}")
    return s


def registered_schemas() -> tuple[MappedSchema, ...]:
    return tuple(_SCHEMA_REGISTRY.values())


def schemas_for(state_data) -> list[MappedSchema]:
    return [
        s
        for s in _SCHEMA_REGISTRY.values()
        if isinstance(state_data, s.applies_to)
    ]
