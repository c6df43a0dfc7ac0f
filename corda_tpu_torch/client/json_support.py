"""JSON mapping for core types + string-to-flow-call parsing.

Port of corda_tpu/client/json_support.py: the same JSON form over the
port's serialization registry, so a tree one package writes the other
reads.

Reference: client/jackson/ — Jackson (de)serialisers for Party,
SecureHash, Amount, public keys and friends, plus
`StringToMethodCallParser` (used by the shell's `flow start Foo bar: 1`
syntax and the webserver).

The JSON form piggybacks the canonical codec's registry: any
@serializable/registered type renders as {"@type": tag, ...fields} and
parses back through the same whitelist — so the JSON surface can never
construct a type the wire codec could not.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

from ..core import serialization as ser


def to_jsonable(obj: Any) -> Any:
    """Core value -> JSON-compatible tree."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, (bytes, bytearray)):
        return {"@bytes": bytes(obj).hex()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        # JSON keys must be strings; non-str keys round-trip as pairs
        if all(isinstance(k, str) for k in obj):
            return {k: to_jsonable(v) for k, v in obj.items()}
        return {
            "@map": [[to_jsonable(k), to_jsonable(v)] for k, v in obj.items()]
        }
    cls = type(obj)
    tag = ser._REGISTRY_BY_TYPE.get(cls)
    if tag is None:
        raise ValueError(f"{cls.__name__} has no wire registration")
    if cls in ser._CUSTOM_ENC:
        return {"@type": tag, "value": to_jsonable(ser._CUSTOM_ENC[cls](obj))}
    out: dict = {"@type": tag}
    for f in dataclasses.fields(obj):
        if f.metadata.get("serialize", True):
            out[f.name] = to_jsonable(getattr(obj, f.name))
    return out


def from_jsonable(tree: Any) -> Any:
    """JSON tree -> core value (whitelist-only, like the codec)."""
    if tree is None or isinstance(tree, (bool, int, str)):
        return tree
    if isinstance(tree, list):
        return tuple(from_jsonable(x) for x in tree)
    if isinstance(tree, dict):
        if "@bytes" in tree and len(tree) == 1:
            return bytes.fromhex(tree["@bytes"])
        if "@map" in tree and len(tree) == 1:
            return {
                from_jsonable(k): from_jsonable(v) for k, v in tree["@map"]
            }
        if "@type" in tree:
            tag = tree["@type"]
            cls = ser._REGISTRY_BY_TAG.get(tag)
            if cls is None:
                raise ValueError(f"unknown type tag {tag!r}")
            if tag in ser._CUSTOM_DEC:
                return ser._CUSTOM_DEC[tag](from_jsonable(tree["value"]))
            kwargs = {
                k: from_jsonable(v) for k, v in tree.items() if k != "@type"
            }
            return cls(**kwargs)
        return {k: from_jsonable(v) for k, v in tree.items()}
    raise ValueError(f"unsupported JSON node {type(tree).__name__}")


def dumps(obj: Any, **kw) -> str:
    return json.dumps(to_jsonable(obj), **kw)


def loads(text: str) -> Any:
    return from_jsonable(json.loads(text))


# ---------------------------------------------------------------------------
# string -> flow call (StringToMethodCallParser)


class CallParseError(Exception):
    pass


def parse_flow_args(
    text: str, resolve_party=None
) -> dict[str, Any]:
    """Parse `name: value, name: value` into constructor kwargs
    (StringToMethodCallParser's yaml-ish syntax). Values are JSON
    literals; bare words resolve as party names via `resolve_party`
    (the shell passes the network map lookup)."""
    args: dict[str, Any] = {}
    if not text.strip():
        return args
    for chunk in _split_top_level(text, ","):
        if ":" not in chunk:
            raise CallParseError(f"expected 'name: value' in {chunk!r}")
        name, raw = chunk.split(":", 1)
        name = name.strip()
        raw = raw.strip()
        try:
            value = json.loads(raw)
            value = from_jsonable(value)
        except (json.JSONDecodeError, ValueError):
            if resolve_party is not None:
                party = resolve_party(raw)
                if party is None:
                    raise CallParseError(
                        f"{raw!r} is neither JSON nor a known party"
                    )
                value = party
            else:
                raise CallParseError(f"cannot parse value {raw!r}")
        args[name] = value
    return args


def _split_top_level(text: str, sep: str) -> list[str]:
    """Split on `sep` outside brackets/braces/quotes."""
    out, depth, quote, start = [], 0, None, 0
    escaped = False
    for i, ch in enumerate(text):
        if quote:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
        elif ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        elif ch == sep and depth == 0:
            out.append(text[start:i])
            start = i + 1
    out.append(text[start:])
    return [c for c in out if c.strip()]
