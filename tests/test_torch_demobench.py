"""DemoBench and its web launcher (tools/demobench.py,
tools/web_demobench.py) in the port, held against the reference.

Both cases of the reference's tests/test_demobench.py run on the port
with their imports read as corda_tpu_torch
(test_torch_health.port_test_module), over a real HTTP server and real
node processes (`python -m corda_tpu_torch.node`): the page and the
JSON API's validation, the map host (a validating notary with a web
gateway) and a client node launched, the pane, the gateway's explorer
reached through the announced port, a node stopped; and a node that
fails at boot reported, cleared and relaunched under its name. Every
node is added with "verifier_backend": "cpu", as the reference's cases
already ask; a node of the port without it verifies on the card.
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402


@pytest.mark.parametrize("name,case", port_cases("test_demobench", {}))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(port_test_module("test_demobench"), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_demobench", {})) == 2
