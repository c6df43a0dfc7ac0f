"""The SPI's host time per call: bucketing, chunking, staging, pinned
copies and launches, the benchmark's span around verify_batch_async
(host clock), averaged over the calls completed inside the window, in
ms."""

MOVES = "call_p95_ms"


def read(run):
    if not run.calls:
        return None
    return sum(c.t_submitted - c.t_submit for c in run.calls) / len(run.calls) * 1e3
