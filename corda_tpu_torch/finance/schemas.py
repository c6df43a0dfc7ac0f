"""Finance vault schemas, the port's copy of corda_tpu/finance/schemas.py
(reference: finance/.../schemas/CashSchemaV1.kt,
CommercialPaperSchemaV1.kt — MappedSchema projections the vault
persists and the query DSL exposes as custom columns)."""

from __future__ import annotations

from ..node.schemas import MappedSchema, register_schema
from .cash import CashState
from .commercial_paper import CommercialPaperState


def _cash_projection(state: CashState) -> dict:
    token = state.amount.token
    return {
        "currency": str(token.product),
        "pennies": state.amount.quantity,
        "issuer_name": token.issuer.party.name,
        "issuer_ref": token.issuer.reference,
        "owner_fp": state.owner.fingerprint(),
    }


CASH_SCHEMA_V1 = MappedSchema(
    name="cash.v1",
    version=1,
    table="cash_states_v1",
    columns=(
        ("currency", "TEXT"),
        ("pennies", "INTEGER"),
        ("issuer_name", "TEXT"),
        ("issuer_ref", "BLOB"),
        ("owner_fp", "BLOB"),
    ),
    applies_to=CashState,
    project=_cash_projection,
)


def _cp_projection(state: CommercialPaperState) -> dict:
    return {
        "currency": str(state.face_value.token.product),
        "face_value": state.face_value.quantity,
        "maturity_micros": state.maturity_micros,
        "issuer_name": state.issuance.party.name,
    }


COMMERCIAL_PAPER_SCHEMA_V1 = MappedSchema(
    name="commercial_paper.v1",
    version=1,
    table="cp_states_v1",
    columns=(
        ("currency", "TEXT"),
        ("face_value", "INTEGER"),
        ("maturity_micros", "INTEGER"),
        ("issuer_name", "TEXT"),
    ),
    applies_to=CommercialPaperState,
    project=_cp_projection,
)

register_schema(CASH_SCHEMA_V1)
register_schema(COMMERCIAL_PAPER_SCHEMA_V1)
