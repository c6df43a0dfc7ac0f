"""Seconds from the benchmark process's start to the window's start:
imports, the CUDA context, the kernel libraries (built in a checkout's
first run), the inputs and one warm pass of every call shape the cell
uses."""

MOVES = None


def read(run):
    return run.setup_s
