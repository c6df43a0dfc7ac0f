"""Rows answered, accepted or rejected, in calls completed inside the
window, over the window's seconds (host clock)."""

MOVES = None


def read(run):
    if not run.calls:
        return None
    return sum(c.rows for c in run.calls) / run.seconds
