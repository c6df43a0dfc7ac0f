"""CorDapp service discovery — the @CordaService scan analogue.

Port of corda_tpu/node/cordapp.py.

Reference: `AbstractNode` scans installed CorDapps with
FastClasspathScanner (AbstractNode.kt:427) and installs every class
annotated `@CordaService` by constructing it with the ServiceHub
(`installCordaServices`, AbstractNode.kt:226-279). Here the scan is the
`config.cordapps` import list (node.py imports each module before
services start) and the annotation is the `@corda_service` decorator:
importing the module registers the class; `install_cordapp_services`
constructs one instance per node at startup, looked up afterwards via
`ServiceHub.cordapp_service(Cls)` (the reference's
`serviceHub.cordaService(Cls::class.java)`).
"""

from __future__ import annotations

from typing import Any

_SERVICE_REGISTRY: list[type] = []


def corda_service(cls: type) -> type:
    """Class decorator: mark a CorDapp service for node installation.
    The class is constructed once per node as `cls(services)` during
    startup (after persistence and identity, before flows run)."""
    if cls not in _SERVICE_REGISTRY:
        _SERVICE_REGISTRY.append(cls)
    return cls


def registered_services() -> tuple[type, ...]:
    return tuple(_SERVICE_REGISTRY)


def install_cordapp_services(
    services, cordapps: Any = None
) -> dict[type, Any]:
    """Construct registered services against this node's hub and expose
    them via `services.cordapp_service(Cls)`.

    `cordapps`: this node's configured cordapp module list — only
    services defined inside those modules install (the reference scans
    the node's OWN plugin jars, AbstractNode.kt:427). None installs
    everything registered in the process (MockNetwork's stance: the
    classpath is shared, so every node gets every cordapp, matching
    MockNode). A service whose constructor raises aborts node start
    with the class named — silent half-installed CorDapps are worse
    than a crash (the reference logs and rethrows the same way)."""
    installed: dict[type, Any] = {}
    for cls in _SERVICE_REGISTRY:
        if cordapps is not None and not any(
            cls.__module__ == m or cls.__module__.startswith(m + ".")
            for m in cordapps
        ):
            continue
        try:
            installed[cls] = cls(services)
        except Exception as e:
            raise RuntimeError(
                f"cordapp service {cls.__name__} failed to install: {e}"
            ) from e
    services.cordapp_services = installed
    return installed
