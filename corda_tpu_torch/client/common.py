"""Shared client plumbing: flow-class resolution + pump-driven waits
(used by both the shell and the webserver so they cannot diverge).

Port of corda_tpu/client/common.py. The search list keeps the
reference's module names, which are the flows' wire tags: each is
imported as the port's module of the same path
(`cordapp.port_module_name`), and a match returns the reference's tag,
which RPC's `construct_logic` resolves in the port."""

from __future__ import annotations

import importlib
import time
from typing import Callable

# flow classes may be referred to by their short name; search these
# packages for a match (InteractiveShell does classpath search). The
# names are tags: a package not in the port is skipped as missing
FLOW_SEARCH_PACKAGES = (
    "corda_tpu.finance.cash",
    "corda_tpu.finance.trade_flows",
    "corda_tpu.flows.core_flows",
    "corda_tpu.flows.replacement",
    "corda_tpu.samples.irs_demo",
    "corda_tpu.samples.attachment_demo",
    "corda_tpu.testing.flows",
)


class FlowLookupError(ValueError):
    pass


def find_flow_class(name: str) -> str:
    """Short flow name -> fully-qualified tag. Only FlowLogic
    subclasses resolve — a state or helper class sharing the name must
    fail HERE with a clear lookup error, not deep in the server."""
    from ..flows.api import FlowLogic
    from ..node.cordapp import port_module_name

    if "." in name:
        return name
    for pkg in FLOW_SEARCH_PACKAGES:
        try:
            mod = importlib.import_module(port_module_name(pkg))
        except ImportError:
            continue
        candidate = getattr(mod, name, None)
        if (
            isinstance(candidate, type)
            and issubclass(candidate, FlowLogic)
        ):
            return f"{pkg}.{name}"
    raise FlowLookupError(f"no flow class named {name!r} found")


def wait_rpc(fut, pump: Callable[[], None], timeout: float):
    """Pump until the RPC future resolves or the deadline passes."""
    deadline = time.monotonic() + timeout
    while not fut.done and time.monotonic() < deadline:
        pump()
        time.sleep(0.01)
    if not fut.done:
        raise TimeoutError("RPC call timed out")
    return fut.get()
