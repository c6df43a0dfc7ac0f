"""Doorman registration (node/registration.py) in the port, held against
the reference.

- Every case of the reference's tests/test_registration.py runs on the
  port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module): auto and manual approval, the
  rejection and its retry, a pinned network root, the email over HTTP,
  a resumed request, idempotent resubmission, the legal-name rules, the
  doorman's own rejections, the HTTP endpoints and their 401, the
  doorman's persistence across a restart, and a node booting on the
  registered TLS chain (or failing on a corrupt one).
- The same CSRs (one key, a resubmission, a rule-violating name, a
  taken name) give equal request ids and byte-equal request ledgers
  (`requests.json`) in both packages' doormen; a doorman directory
  written by one package is reloaded by the other, which issues the
  pending request's chain under the same root.
- Across the packages over HTTP: a port node registers with a
  reference doorman and the reverse; each certificate directory boots
  the other package's node, which serves the registered TLS leaf.
"""

from __future__ import annotations

import importlib
import json

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")


@pytest.mark.parametrize("name,case", port_cases("test_registration", {}))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(port_test_module("test_registration"), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_registration", {})) == 17


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def _csrs() -> list:
    """CSR PEMs (made with the port's x509 module; the bytes are what
    both doormen read): Acme twice over one key, a rule-violating name,
    Unique Bank, and Unique Bank again over another key."""
    xu = _m("corda_tpu_torch", "utils.x509")
    acme = xu.generate_tls_key()
    return [xu.csr_pem(xu.create_csr(name, key)) for name, key in (
        ("Acme", acme), ("Acme", acme), ("evil node corp", xu.generate_tls_key()),
        ("Unique Bank", xu.generate_tls_key()), ("Unique Bank", xu.generate_tls_key()))]


def test_request_ids_and_ledgers_equal_the_references(tmp_path):
    csrs = _csrs()
    got = {}
    for prefix in PACKAGES:
        dm = _m(prefix, "node.registration").Doorman.create(
            auto_approve=False, data_dir=str(tmp_path / prefix))
        ids = [dm.submit(pem, email="ops@example.com") for pem in csrs]
        got[prefix] = (ids, (tmp_path / prefix / "requests.json").read_bytes())
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    ids, ledger = got["corda_tpu"]
    assert ids[0] == ids[1] and len(set(ids)) == 4
    statuses = {rid: r["status"] for rid, r in json.loads(ledger).items()}
    assert statuses[ids[2]] == "rejected" and statuses[ids[4]] == "rejected"
    assert statuses[ids[0]] == statuses[ids[3]] == "pending"


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]],
                         ids=["reference_to_port", "port_to_reference"])
def test_doorman_directory_carried_across(writer, reader, tmp_path):
    xu = _m(reader, "utils.x509")
    key = xu.generate_tls_key()
    pem = xu.csr_pem(xu.create_csr("Carried Bank", key))
    first = _m(writer, "node.registration").Doorman.create(
        auto_approve=False, data_dir=str(tmp_path))
    rid = first.submit(pem)
    second = _m(reader, "node.registration").Doorman.create(
        auto_approve=False, data_dir=str(tmp_path))
    assert second.pending() == [rid] and second.submit(pem) == rid
    assert second.root.cert_pem == first.root.cert_pem
    second.approve(rid)
    chain = [xu.load_cert(p) for p in second.retrieve(rid)]
    assert xu.validate_chain(*chain)
    assert second.retrieve(rid) == _m(writer, "node.registration").Doorman.create(
        data_dir=str(tmp_path)).retrieve(rid)


@pytest.mark.parametrize("doorman,node", [PACKAGES, PACKAGES[::-1]],
                         ids=["reference_doorman", "port_doorman"])
def test_registration_over_http_across_the_packages(doorman, node, tmp_path):
    """The helper of `node` registers over HTTP with the doorman of
    `doorman`; the certificate directory it stores boots a node of each
    package, serving the registered TLS leaf."""
    reg = _m(doorman, "node.registration")
    server = reg.PermissioningServer(reg.Doorman.create(auto_approve=True)).start()
    try:
        nreg = _m(node, "node.registration")
        helper = nreg.NetworkRegistrationHelper(
            str(tmp_path / "node"), "RegBank", nreg.HttpRegistrationService(server.url),
            poll_interval=0.01, max_polls=50, log=lambda *a: None)
        assert helper.build_keystore() is True
    finally:
        server.stop()
    for prefix in PACKAGES:
        xu = _m(prefix, "utils.x509")
        cfg = _m(prefix, "node.config").NodeConfig(
            name="RegBank", base_dir=str(tmp_path / "node"), verifier_backend="cpu", cordapps=())
        booted = _m(prefix, "node.node").Node(cfg).start()
        try:
            pem = helper.tls_file.read_bytes()
            stored = xu.load_cert(pem[pem.index(b"-----BEGIN CERTIFICATE"):])
            served = xu.load_cert(booted.tls.cert_pem)
            assert (served.subject, served.serial_number) == (stored.subject,
                                                             stored.serial_number)
        finally:
            booted.stop()
