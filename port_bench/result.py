"""What a run hands the metric readers (metrics/*.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .devtrace import TraceSummary


@dataclass
class Run:
    seconds: float          # the window's length, as asked
    setup_s: float          # process start to the window's start
    calls: list             # loop.Call completed inside the window
    all_calls: list         # every call the window submitted, the drained ones too
    chunks: list            # per call layout, its device chunks (rows per scheme over the
                            # largest batch size, rounded up)
    trace: Optional[TraceSummary] = None     # the traced run's capture
    imad: Optional[list] = None              # per call layout, the frozen IMAD of its rows
    bytes: Optional[list] = None             # per call layout, the frozen bytes of its rows
    peak: Optional[dict] = None              # the card's peaks: imad_per_s, bytes_per_s
