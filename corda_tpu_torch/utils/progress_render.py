"""ANSI progress rendering for flow ProgressTrackers.

Port of corda_tpu/utils/progress_render.py, over the port's
flows.api.ProgressTracker.

Reference: `ANSIProgressRenderer` (node/.../utilities/
ANSIProgressRenderer.kt) — paints a flow's hierarchical step tree in
the terminal with done/current markers, consumed by the shell's
`flow watch` (FlowWatchPrintingSubscriber.kt).
"""

from __future__ import annotations

from typing import Optional

from ..flows.api import ProgressTracker

DONE = "✓"       # ✓
CURRENT = "▶"    # ▶
PENDING = " "

_GREEN = "\x1b[32m"
_BOLD = "\x1b[1m"
_RESET = "\x1b[0m"


def render(tracker: ProgressTracker, ansi: bool = True) -> str:
    """Multi-line rendering of a tracker's step list: completed steps
    get a check, the current one an arrow, the rest stay pending."""
    done: set = set()
    for label in tracker.history:
        if label != tracker.current:
            done.add(label)
    lines = []
    for step in tracker.steps:
        if step == tracker.current:
            mark, style = CURRENT, _BOLD
        elif step in done:
            mark, style = DONE, _GREEN
        else:
            mark, style = PENDING, ""
        if ansi and style:
            lines.append(f"{style}{mark} {step}{_RESET}")
        else:
            lines.append(f"{mark} {step}")
    # steps announced outside the declared list still show (sub-flows);
    # ordered-unique, or repeat announcements would grow the render
    seen: set = set()
    for label in tracker.history:
        if label not in tracker.steps and label not in seen:
            seen.add(label)
            mark = CURRENT if label == tracker.current else DONE
            lines.append(f"{mark} {label}")
    return "\n".join(lines)


class ProgressRenderer:
    """Streams re-renders on every step change (the renderer's
    subscription role); `out` is any write()-able."""

    def __init__(self, tracker: ProgressTracker, out, ansi: bool = False):
        self.tracker = tracker
        self.out = out
        self.ansi = ansi
        tracker.observers.append(self._on_step)

    def _on_step(self, label: str) -> None:
        self.out.write(render(self.tracker, self.ansi) + "\n")

    def close(self) -> None:
        if self._on_step in self.tracker.observers:
            self.tracker.observers.remove(self._on_step)
