"""Carpenter: runtime type synthesis for schema-carrying payloads.

Reference: core/.../serialization/carpenter/ClassCarpenter.kt:26 — the
AMQP scheme carries its schema on the wire, and when a deserialising
node lacks the class (e.g. an RPC client receiving a CorDapp type it
never linked), the carpenter synthesises a matching class with ASM so
the object is still usable. Here the CTS object encoding already
carries (tag, {field: value}), so the carpenter synthesises a frozen
dataclass per (tag, field-set) and installs itself as the decoder's
unknown-tag handler.

Scope rules (mirroring the reference's trust boundaries):
  - The consensus path (tx-id preimages, signed payloads, contract
    verification) never runs with the carpenter active — unknown tags
    there stay hard errors (whitelist stance, CordaClassResolver.kt).
  - Client-facing contexts (RPC tooling, explorers, log inspection)
    opt in with `carpenter_context()` / `decode_tolerant`.

Synthesised objects re-encode bit-identically (they remember their
wire tag via `__cts_tag__`), so a tool can receive, inspect, and
forward values whose classes it does not have. Inside a carpenter
context, known-class decodes are also evolution-tolerant: fields added
by newer senders are dropped, fields this version adds fill from
dataclass defaults.

Port of corda_tpu/core/carpenter.py. The port's codec (Python and
native) reads the same thread-local handler slot, so inside a context
both decode unknown tags to the same synthesized objects as the
reference's.
"""

from __future__ import annotations

import dataclasses
import keyword
from contextlib import contextmanager
from typing import Any, Iterable

from . import serialization as ser

_SYNTH: dict[tuple, type] = {}


class CarpenterError(ser.SerializationError):
    pass


def _check_name(name: str, what: str) -> str:
    if not name.isidentifier() or keyword.iskeyword(name):
        raise CarpenterError(f"cannot carpent {what} named {name!r}")
    return name


def synthesize(tag: str, field_names: Iterable[str]) -> type:
    """Build (or reuse) a frozen dataclass for a wire schema. One class
    per (tag, field-set): two payloads with the same shape share a
    type, so equality works across decodes (ClassCarpenter caches per
    schema the same way)."""
    names = tuple(field_names)
    key = (tag, names)
    cls = _SYNTH.get(key)
    if cls is None:
        class_name = _check_name(tag.rsplit(".", 1)[-1], "class")
        cls = dataclasses.make_dataclass(
            class_name,
            [_check_name(n, "field") for n in names],
            frozen=True,
            eq=True,
            repr=True,
        )
        cls.__cts_tag__ = tag
        cls.__module__ = __name__
        _SYNTH[key] = cls
    return cls


def _handler(tag: str, kwargs: dict) -> Any:
    cls = synthesize(tag, kwargs.keys())
    return cls(**{k: ser._tuplify(v) for k, v in kwargs.items()})


@contextmanager
def carpenter_context():
    """Within the context, decoding synthesises unknown types and is
    evolution-tolerant for known ones. The handler slot is thread-local:
    other threads (e.g. the fabric's consensus-path decoder loop) stay
    strict while a tooling thread is inside this context."""
    prev = ser._unknown_tag_handler()
    ser.set_unknown_tag_handler(_handler)
    try:
        yield
    finally:
        ser.set_unknown_tag_handler(prev)


def decode_tolerant(buf: bytes) -> Any:
    """One-shot carpenter decode (client/tooling contexts)."""
    with carpenter_context():
        return ser.decode(buf)


def is_synthesized(obj: Any) -> bool:
    return type(obj) in set(_SYNTH.values())
