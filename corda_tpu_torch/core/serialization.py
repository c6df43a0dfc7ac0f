"""Canonical deterministic serialization (consensus-critical).

Port of corda_tpu/core/serialization.py, the pure-Python codec (the
reference's native C codec of the same format is Queue 1 #7). One
deterministic, self-describing binary format ("CTS") for every context:
the tx-id preimage and the signed payload must be bit-stable across
hosts, and across the two packages: a registered object's wire tag is
its class name, so the port's classes keep the reference's names and
field order, and equal values encode to equal bytes in both.

Format (byte-tagged, big-endian lengths):
  N           0x00                      None
  T/F         0x01/0x02                 booleans
  I+ / I-     0x03 varint / 0x04 varint unsigned/negated integers
  B           0x05 varint payload       bytes
  S           0x06 varint utf8          str
  L           0x07 varint count items   list/tuple (frozenset: sorted)
  M           0x08 varint count k,v*    dict, keys sorted by encoding
  O           0x09 tag-str field-map    registered object

Determinism rules: map keys sorted by their encoded bytes; registered
objects encode as (tag, {field: value}) with fields in declaration
order; integers are minimal-length varints; no floats.

Objects register with @serializable (dataclasses) or register_custom();
decoding is whitelist-only: unknown tags raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

_REGISTRY_BY_TAG: dict[str, type] = {}
_REGISTRY_BY_TYPE: dict[type, str] = {}
_CUSTOM_ENC: dict[type, Callable[[Any], Any]] = {}
_CUSTOM_DEC: dict[str, Callable[[Any], Any]] = {}
_CLASS_ENC_CACHE: dict[type, tuple] = {}

# Explicit nesting bound, the reference's: the accept/reject decision on
# deep structures must not depend on the interpreter's recursion limit.
MAX_DEPTH = 500


class SerializationError(Exception):
    pass


def serializable(cls=None, *, tag: Optional[str] = None):
    """Register a (data)class for canonical object encoding."""

    def wrap(c):
        t = tag or c.__name__
        if t in _REGISTRY_BY_TAG and _REGISTRY_BY_TAG[t] is not c:
            raise SerializationError(f"duplicate serialization tag {t!r}")
        _REGISTRY_BY_TAG[t] = c
        _REGISTRY_BY_TYPE[c] = t
        _CLASS_ENC_CACHE.pop(c, None)
        return c

    return wrap(cls) if cls is not None else wrap


def register_custom(cls: type, tag: str, enc, dec) -> None:
    """Register a non-dataclass type with explicit encode/decode fns.

    enc: obj -> encodable value; dec: value -> obj.
    """
    _REGISTRY_BY_TAG[tag] = cls
    _REGISTRY_BY_TYPE[cls] = tag
    _CUSTOM_ENC[cls] = enc
    _CUSTOM_DEC[tag] = dec
    _CLASS_ENC_CACHE.pop(cls, None)


def _varint(n: int) -> bytes:
    if n < 0:
        raise SerializationError("varint must be non-negative")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        if i >= len(buf):
            raise SerializationError("truncated varint")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            if b == 0 and shift:
                raise SerializationError("non-minimal varint")
            return val, i
        shift += 7
        if shift > 640:
            raise SerializationError("varint too long")


def encode(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def _encode_at(obj: Any, depth: int) -> bytes:
    out = bytearray()
    _enc(obj, out, depth)
    return bytes(out)


def _enc(obj: Any, out: bytearray, depth: int = 0) -> None:
    if depth > MAX_DEPTH:
        raise SerializationError("nesting too deep")
    if obj is None:
        out.append(0x00)
    elif obj is True:
        out.append(0x01)
    elif obj is False:
        out.append(0x02)
    elif isinstance(obj, int):
        if obj >= 0:
            out.append(0x03)
            out += _varint(obj)
        else:
            out.append(0x04)
            out += _varint(-obj)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(0x05)
        out += _varint(len(obj))
        out += bytes(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(0x06)
        out += _varint(len(b))
        out += b
    elif isinstance(obj, (list, tuple)):
        out.append(0x07)
        out += _varint(len(obj))
        for item in obj:
            _enc(item, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(0x08)
        out += _varint(len(obj))
        entries = sorted(
            (_encode_at(k, depth + 1), _encode_at(v, depth + 1))
            for k, v in obj.items()
        )
        for ek, ev in entries:
            out += ek
            out += ev
    elif isinstance(obj, frozenset):
        out.append(0x07)
        items = sorted(_encode_at(i, depth + 1) for i in obj)
        out += _varint(len(items))
        for e in items:
            out += e
    else:
        info = _class_enc_info(type(obj))
        if info is None:
            raise SerializationError(
                f"type {type(obj).__name__} is not canonically serializable"
            )
        header, custom, field_encs = info
        out += header
        if custom is not None:
            _enc(custom(obj), out, depth + 1)
        else:
            for name_bytes, name in field_encs:
                out += name_bytes
                _enc(getattr(obj, name), out, depth + 1)


def _class_enc_info(cls):
    """(header_bytes, custom_enc_or_None, ((name_encoding, name), ...))
    for a registered class — every byte here is per-class constant, so
    it is cached (the encode walk is the id-preimage hot path)."""
    info = _CLASS_ENC_CACHE.get(cls)
    if info is None:
        tag = _REGISTRY_BY_TYPE.get(cls)
        if tag is None:
            return None   # not cached: the class may register later
        tb = tag.encode("utf-8")
        header = bytes([0x09]) + _varint(len(tb)) + tb
        custom = _CUSTOM_ENC.get(cls)
        if custom is not None:
            info = (header, custom, ())
        else:
            names = [
                f.name
                for f in dataclasses.fields(cls)
                if f.metadata.get("serialize", True)
            ]
            field_encs = tuple(
                (
                    bytes([0x06])
                    + _varint(len(nb := name.encode("utf-8")))
                    + nb,
                    name,
                )
                for name in names
            )
            info = (header + _varint(len(names)), None, field_encs)
        _CLASS_ENC_CACHE[cls] = info
    return info


def decode(buf: bytes) -> Any:
    val, i = _dec(buf, 0)
    if i != len(buf):
        raise SerializationError("trailing bytes")
    return val


def _dec(buf: bytes, i: int, depth: int = 0) -> tuple[Any, int]:
    if depth > MAX_DEPTH:
        raise SerializationError("nesting too deep")
    if i >= len(buf):
        raise SerializationError("truncated")
    tag = buf[i]
    i += 1
    if tag == 0x00:
        return None, i
    if tag == 0x01:
        return True, i
    if tag == 0x02:
        return False, i
    if tag == 0x03:
        return _read_varint(buf, i)
    if tag == 0x04:
        v, i = _read_varint(buf, i)
        return -v, i
    if tag == 0x05:
        n, i = _read_varint(buf, i)
        if i + n > len(buf):
            raise SerializationError("truncated bytes")
        return bytes(buf[i : i + n]), i + n
    if tag == 0x06:
        n, i = _read_varint(buf, i)
        if i + n > len(buf):
            raise SerializationError("truncated str")
        try:
            return buf[i : i + n].decode("utf-8"), i + n
        except UnicodeDecodeError:
            raise SerializationError("invalid utf-8 in str")
    if tag == 0x07:
        n, i = _read_varint(buf, i)
        out = []
        for _ in range(n):
            v, i = _dec(buf, i, depth + 1)
            out.append(v)
        return out, i
    if tag == 0x08:
        n, i = _read_varint(buf, i)
        d = {}
        for _ in range(n):
            k, i = _dec(buf, i, depth + 1)
            v, i = _dec(buf, i, depth + 1)
            d[k] = v
        return d, i
    if tag == 0x09:
        n, i = _read_varint(buf, i)
        if i + n > len(buf):
            raise SerializationError("truncated tag")
        try:
            tname = buf[i : i + n].decode("utf-8")
        except UnicodeDecodeError:
            raise SerializationError("invalid utf-8 in tag")
        i += n
        cls = _REGISTRY_BY_TAG.get(tname)
        if cls is None:
            raise SerializationError(f"unknown object tag {tname!r}")
        if tname in _CUSTOM_DEC:
            payload, i = _dec(buf, i, depth + 1)
            return _CUSTOM_DEC[tname](payload), i
        nf, i = _read_varint(buf, i)
        kwargs = {}
        for _ in range(nf):
            name, i = _dec(buf, i, depth + 1)
            value, i = _dec(buf, i, depth + 1)
            kwargs[name] = value
        return _decode_dataclass(cls, kwargs), i
    raise SerializationError(f"unknown tag byte {tag:#x}")


def _tuplify(v):
    """Frozen dataclasses use tuple fields; sequences decode as tuples."""
    if isinstance(v, list):
        return tuple(_tuplify(i) for i in v)
    return v


def _decode_dataclass(cls, kwargs):
    try:
        return cls(**{k: _tuplify(v) for k, v in kwargs.items()})
    except TypeError as e:
        raise SerializationError(f"cannot reconstruct {cls.__name__}: {e}")
