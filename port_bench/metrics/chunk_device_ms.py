"""Device time per chunk: the program's own CUDA events around each
chunk, copy in to copy out (PendingVerification.device_seconds), over
the chunks of the calls completed inside the window, in ms."""

MOVES = "call_p95_ms"


def read(run):
    chunks = sum(run.chunks[c.layout] for c in run.calls)
    device = sum(c.device_s for c in run.calls)
    if not chunks or device <= 0:
        return None
    return device / chunks * 1e3
