"""The 95th percentile over every call completed inside the window of
its time from the start of its submission to its last answer (host
clock), in ms."""

import statistics

MOVES = None


def read(run):
    lat = [(c.t_done - c.t_submit) * 1e3 for c in run.calls]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
