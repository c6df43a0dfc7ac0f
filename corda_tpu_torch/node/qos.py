"""Deadline shedding: the part of the QoS plane the wire ingest needs.

Port of `DeadlineExpired` and `expired` from corda_tpu/node/qos.py. An
optional absolute-microsecond deadline rides the fabric as a message
header (messaging.Message.deadline) and through the ingest pipeline; a
frame whose deadline has passed is shed pre-decode into a typed
`DeadlineExpired` in its slot instead of being verified for nobody.
The rest of the reference's plane (priority lanes, the token bucket,
the adaptive batch controller, brownout, `NotaryQos`) is not ported.
"""

from __future__ import annotations

from typing import Optional


class DeadlineExpired(Exception):
    """Pre-decode shed marker: the frame's deadline passed before any
    work was spent on it. Carried in IngestedTx.error so the wire path
    reports sheds per-slot exactly like malformed frames."""

    def __init__(self, deadline_micros: int, now_micros: int):
        self.deadline_micros = deadline_micros
        self.now_micros = now_micros
        super().__init__(
            f"deadline {deadline_micros} expired "
            f"{now_micros - deadline_micros} us before processing"
        )


def expired(deadline_micros: Optional[int], now_micros: int) -> bool:
    """The ONE expiry predicate: None never expires; expiry is
    inclusive so a deadline equal to `now` sheds — serving it would
    complete strictly after it."""
    return deadline_micros is not None and now_micros >= deadline_micros
