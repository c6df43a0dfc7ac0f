"""The verify kernels' share of their roofline: the least time the card
needs for the rows of every call the traced window submitted (padding
not counted), the larger of their frozen IMAD count (imad.py) over the
IMAD peak and their frozen bytes over the memory bandwidth (peaks.json),
over the summed device time of every kernel in the capture, in %. The
IMAD term binds: a row's work is about a million IMAD against some
hundred bytes."""

MOVES = "verifies_per_s"


def read(run):
    if run.trace is None or run.imad is None or run.peak is None or run.trace.kernel_s <= 0:
        return None
    done = [c for c in run.all_calls if c.error is None]
    work = sum(run.imad[c.layout] for c in done)
    moved = sum(run.bytes[c.layout] for c in done)
    least = max(work / run.peak["imad_per_s"], moved / run.peak["bytes_per_s"])
    return 100.0 * least / run.trace.kernel_s
