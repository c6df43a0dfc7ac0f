"""Audit service: structured record of security-relevant node events.

Reference: `AuditService` (node/.../services/api/AuditService.kt) — an
interface the reference ships as a STUB (SURVEY §5 "Audit service
interface exists but is a stub"). Here the interface is the same shape
but comes with a working in-memory + persistent implementation, because
the hooks (flow start, RPC auth failures, notary conflicts) already
exist in this codebase.

Port of corda_tpu/node/audit.py. It has no card path.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class AuditEvent:
    at_micros: int
    category: str          # "flow" | "rpc" | "notary" | "system"
    principal: str         # who (user, peer, flow id)
    description: str
    context: tuple = ()    # extra (key, value) string pairs


class AuditService:
    """The recording interface (AuditService.kt's recordAuditEvent)."""

    def record(
        self,
        category: str,
        principal: str,
        description: str,
        clock=None,
        **context: str,
    ) -> AuditEvent:
        event = AuditEvent(
            at_micros=(
                clock.now_micros() if clock is not None
                else time.time_ns() // 1_000
            ),
            category=category,
            principal=principal,
            description=description,
            context=tuple(sorted(context.items())),
        )
        self._store(event)
        return event

    def _store(self, event: AuditEvent) -> None:
        raise NotImplementedError

    def events(
        self, category: Optional[str] = None
    ) -> list[AuditEvent]:
        raise NotImplementedError


class InMemoryAuditService(AuditService):
    def __init__(self):
        self._events: list[AuditEvent] = []

    def _store(self, event: AuditEvent) -> None:
        self._events.append(event)

    def events(self, category=None):
        return [
            e for e in self._events
            if category is None or e.category == category
        ]


class PersistentAuditService(AuditService):
    """Append-only audit rows in the node database."""

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS audit_log (
        seq         INTEGER PRIMARY KEY AUTOINCREMENT,
        at_micros   INTEGER NOT NULL,
        category    TEXT NOT NULL,
        principal   TEXT NOT NULL,
        description TEXT NOT NULL,
        context     TEXT NOT NULL
    );
    """

    def __init__(self, db):
        self._db = db
        db.execute_script(self._SCHEMA)

    def _store(self, event: AuditEvent) -> None:
        self._db.execute(
            "INSERT INTO audit_log"
            " (at_micros, category, principal, description, context)"
            " VALUES (?,?,?,?,?)",
            (
                event.at_micros,
                event.category,
                event.principal,
                event.description,
                json.dumps(list(event.context)),
            ),
        )

    def events(self, category=None):
        where = "" if category is None else " WHERE category = ?"
        params = () if category is None else (category,)
        rows = self._db.query(
            "SELECT at_micros, category, principal, description, context"
            f" FROM audit_log{where} ORDER BY seq",
            params,
        )
        return [
            AuditEvent(
                r[0], r[1], r[2], r[3],
                tuple(tuple(p) for p in json.loads(r[4])),
            )
            for r in rows
        ]
