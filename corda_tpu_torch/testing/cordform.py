"""Cordform: generate a deployable node-directory tree from a network spec.

Port of corda_tpu/testing/cordform.py. The tree's node.toml files are
the reference's bytes (cordapps keep the reference's module names); each
run.sh runs `python -m corda_tpu_torch.node`.

Reference: the `cordformation` gradle plugin (`deployNodes` task —
gradle-plugins/cordformation/.../Cordform.groovy + Node.groovy, shared
model in cordform-common): a DSL describing the nodes of a network is
turned into per-node directories with their config files, ready to
launch.

Here the spec is data (NodeSpec list), the output is a directory per
node containing node.toml plus a run.sh, with static ports assigned
from a base and every node pointed at the map host. `python -m
corda_tpu_torch.node --config <dir>/node.toml` boots each one.
"""

from __future__ import annotations

import os
import stat
from dataclasses import dataclass, field
from typing import Optional

from ..node.config import NodeConfig, RpcUserConfig, write_config


@dataclass(frozen=True)
class NodeSpec:
    """One node in the network DSL (Node.groovy's fields)."""

    name: str
    notary: str = ""
    cluster_peers: tuple[str, ...] = ()
    cluster_name: str = "DistributedNotary"
    rpc_users: tuple[RpcUserConfig, ...] = (
        RpcUserConfig("user1", "password", ("ALL",)),
    )
    cordapps: tuple[str, ...] = ("corda_tpu.finance",)
    extra: dict = field(default_factory=dict)


def deploy_nodes(
    specs: list[NodeSpec],
    out_dir: str,
    base_port: int = 10000,
    host: str = "127.0.0.1",
    map_host_name: Optional[str] = None,
) -> dict[str, NodeConfig]:
    """Write one directory per node under `out_dir` (the deployNodes
    task). The first spec (or `map_host_name`) becomes the network map
    host; every other node is configured against its static port.
    Returns name -> NodeConfig."""
    if not specs:
        raise ValueError("no nodes in the network spec")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError("duplicate node names in the network spec")
    map_name = map_host_name or specs[0].name
    if map_name not in names:
        raise ValueError(f"map host {map_name!r} is not in the spec")
    ports = {s.name: base_port + i for i, s in enumerate(specs)}

    # Pre-generate the map host's TLS identity so every other config can
    # pin its fingerprint statically (at runtime the node finds the
    # material already in its database and reuses it — the cert-
    # distribution role of the reference's generated node directories).
    from ..node.fabric import TlsIdentity
    from ..node.persistence import NodeDatabase, PersistentKVStore

    map_dir = os.path.join(out_dir, map_name)
    os.makedirs(map_dir, exist_ok=True)
    db = NodeDatabase(os.path.join(map_dir, "node.db"))
    try:
        store = PersistentKVStore(db, "node_tls")
        cert, key = store.get(b"cert"), store.get(b"key")
        if cert is None or key is None:   # partial writes regenerate
            tls = TlsIdentity.generate(map_name)
            store.put(b"cert", tls.cert_pem)
            store.put(b"key", tls.key_pem)
        else:
            tls = TlsIdentity(bytes(cert), bytes(key))
    finally:
        db.close()

    configs: dict[str, NodeConfig] = {}
    for spec in specs:
        node_dir = os.path.join(out_dir, spec.name)
        os.makedirs(node_dir, exist_ok=True)
        kw = dict(spec.extra)
        if spec.name != map_name:
            kw.update(
                network_map_peer=map_name,
                network_map_host=host,
                network_map_port=ports[map_name],
                network_map_fingerprint=tls.fingerprint,
            )
        cfg = NodeConfig(
            name=spec.name,
            base_dir=node_dir,
            p2p_host=host,
            p2p_port=ports[spec.name],
            notary=spec.notary,
            cluster_peers=spec.cluster_peers,
            cluster_name=spec.cluster_name,
            rpc_users=spec.rpc_users,
            cordapps=spec.cordapps,
            **kw,
        )
        conf_path = os.path.join(node_dir, "node.toml")
        write_config(cfg, conf_path)
        run_path = os.path.join(node_dir, "run.sh")
        with open(run_path, "w") as f:
            f.write(
                "#!/bin/sh\n"
                f'exec python -m corda_tpu_torch.node --config "{conf_path}" "$@"\n'
            )
        os.chmod(run_path, os.stat(run_path).st_mode | stat.S_IEXEC)
        configs[spec.name] = cfg
    return configs
