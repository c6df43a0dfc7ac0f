"""Host staging per row: the program's own PendingVerification
.stage_seconds (DER, SEC1, SHA-256 or SHA-512 mod L into records) over
the rows of the calls completed inside the window, in µs (us)."""

MOVES = "verifies_per_s"


def read(run):
    rows = sum(c.rows for c in run.calls)
    staged = sum(c.stage_s for c in run.calls)
    if not rows or staged <= 0:
        return None
    return staged / rows * 1e6
