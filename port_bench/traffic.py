"""The one generator of the benchmark's traffic: rows and calls from a
configuration, a traffic file and a seed.

A configuration (configs/*.json) states the deployment: the schemes it
verifies, the message length, the signers per scheme, and the share of
each adversarial kind of row. A traffic file (workloads/*.json) states
the calls: rows per call, calls in flight per caller, callers, distinct
rows, the share of each scheme in a call, and how many call layouts the
run cycles through. The seed fixes every key, message and signature and
the order of the rows; the sizes are the same for every seed, so two
seeds do the same work in another order.

Kinds of row (Corda's signature checks see all of them):
  valid          signed by its key over its message
  wrong_message  a valid row's key and signature over another message
  flipped_byte   a valid row's signature with one byte XORed
  truncated      a valid row's signature cut short by at least a byte
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

from . import ec_ref as R

KINDS = ("valid", "wrong_message", "flipped_byte", "truncated")


@dataclass(frozen=True)
class Row:
    scheme: str           # a Corda code name, as ec_ref.SCHEMES
    key: bytes            # SEC1 uncompressed point, or the 32-byte ed25519 key
    signature: bytes      # DER (ECDSA) or R || S (ed25519)
    message: bytes
    kind: str             # one of KINDS; the label is kind == "valid"


def _rng(seed: int, *what) -> random.Random:
    return random.Random(":".join(map(str, (seed, *what))))


def _shares(total: int, shares: dict) -> dict:
    """Split `total` by `shares` (name -> weight), largest remainder
    first, ties in the order given: the same counts for every seed."""
    weight = sum(shares.values())
    exact = {k: total * v / weight for k, v in shares.items()}
    out = {k: int(v) for k, v in exact.items()}
    rest = sorted(shares, key=lambda k: -(exact[k] - out[k]))
    for k in rest[: total - sum(out.values())]:
        out[k] += 1
    return out


def _signers(seed: int, scheme: str, count: int) -> list:
    """[(private, public key bytes)] of `count` signers of `scheme`."""
    out = []
    for i in range(count):
        secret = hashlib.sha256(f"{seed}:{scheme}:signer:{i}".encode()).digest()
        if scheme == R.ED25519:
            out.append((secret, R.ed25519_public(secret)))
        else:
            d = int.from_bytes(secret, "big") % (R.CURVES[scheme].n - 1) + 1
            out.append((d, R.ecdsa_public(scheme, d)))
    return out


def _sign(scheme: str, private, public: bytes, msg: bytes) -> bytes:
    if scheme == R.ED25519:
        return R.ed25519_sign(private, public, msg)
    return R.ecdsa_sign(scheme, private, msg)


def scheme_rows(seed: int, config: dict, scheme: str, count: int) -> list:
    """`count` distinct rows of one scheme, kinds in the configuration's
    shares, in a seeded order. Each adversarial row derives from a valid
    row of the same scheme, so it shares that row's key and, but for its
    fault, its signature."""
    rng = _rng(seed, scheme, "rows")
    msg_len = int(config["message_bytes"])
    kinds = _shares(count, {"valid": 1 - sum(config["adversarial"].values()),
                            **config["adversarial"]})
    signers = _signers(seed, scheme, int(config["signers_per_scheme"]))
    valid = []
    for i in range(kinds["valid"]):
        private, public = signers[rng.randrange(len(signers))]
        msg = rng.randbytes(msg_len)
        valid.append(Row(scheme, public, _sign(scheme, private, public, msg), msg, "valid"))
    rows = list(valid)
    for kind in KINDS[1:]:
        for j in range(kinds.get(kind, 0)):
            base = valid[j % len(valid)]
            sig, msg = base.signature, base.message
            if kind == "wrong_message":
                msg = rng.randbytes(msg_len)
            elif kind == "flipped_byte":
                b = bytearray(sig)
                b[rng.randrange(len(b))] ^= rng.randrange(1, 256)
                sig = bytes(b)
            else:
                sig = sig[: rng.randrange(len(sig))]
            rows.append(Row(scheme, base.key, sig, msg, kind))
    rng.shuffle(rows)
    return rows


@dataclass
class Traffic:
    rows: list            # distinct rows, every scheme
    layouts: list         # per call layout, the row indices of one call, in call order
    rows_per_call: int
    in_flight: int
    callers: int


def build(seed: int, config: dict, traffic: dict) -> Traffic:
    """The distinct rows and the call layouts of one run."""
    mix = traffic["mix"]
    unknown = set(mix) - set(config["schemes"])
    if unknown:
        raise ValueError(f"traffic mixes {sorted(unknown)}, which the configuration "
                         f"does not verify ({config['schemes']})")
    per_call = _shares(int(traffic["rows_per_call"]), mix)
    distinct = _shares(int(traffic["distinct_rows"]), mix)
    rows, by_scheme = [], {}
    for scheme in mix:
        start = len(rows)
        rows.extend(scheme_rows(seed, config, scheme, distinct[scheme]))
        by_scheme[scheme] = list(range(start, len(rows)))
    # each scheme's rows go round in epochs, every epoch in its own
    # seeded order; a call takes the next rows_per_call of each scheme
    streams = {}
    for scheme, idxs in by_scheme.items():
        rng = _rng(seed, scheme, "stream")
        need = per_call[scheme] * int(traffic["call_layouts"])
        out = []
        while len(out) < need:
            epoch = list(idxs)
            rng.shuffle(epoch)
            out.extend(epoch)
        streams[scheme] = out
    layouts = []
    order = _rng(seed, "interleave")
    for c in range(int(traffic["call_layouts"])):
        call = []
        for scheme, n in per_call.items():
            call.extend(streams[scheme][c * n : (c + 1) * n])
        order.shuffle(call)
        layouts.append(call)
    return Traffic(rows, layouts, int(traffic["rows_per_call"]), int(traffic["in_flight"]),
                   int(traffic["callers"]))
