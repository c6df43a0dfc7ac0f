"""The share of the traced window in which the card ran no kernel, copy
or fill (torch.profiler), in %."""

MOVES = "verifies_per_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None             # nothing ran on a card: nothing to read
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
