"""Network permissioning (doorman) and initial node registration.

Port of corda_tpu/node/registration.py: the doorman's request ledger,
the request ids and the certificate directory it writes are the
reference's, so either package's node registers with either package's
doorman and boots on the other's certificates.

Reference: `node/.../utilities/registration/` —
`NetworkRegistrationHelper.kt:31` (buildKeystore: self-signed temp key
held while the request is in flight, submit-or-resume via a persisted
`certificate-request-id.txt`, poll loop, then store the signed node-CA
chain + a freshly minted TLS cert and the root into the trust store),
`HTTPNetworkRegistrationService.kt:16` (the HTTP client: POST
`/api/certificate` -> request id; GET `/api/certificate/<id>` ->
200 chain | 204 pending | 401 rejected) and the
`NetworkRegistrationService.kt:7` interface.

The reference ships only the CLIENT half — its permissioning server
("doorman") is an external R3 service. Here the doorman itself is part
of the framework so a permissioned network can be stood up end-to-end:
`python -m corda_tpu_torch.node.registration --port 8080 --data-dir dm/`
runs one over HTTP, auto-approving by default or holding requests for
an operator (`--manual` + the /admin endpoints).

Scope note: registration certifies the node's *transport* identity —
the node-CA chain and the TLS leaf the fabric serves (node.py prefers
`certificates/tls.pem` over a generated self-signed cert). Ledger
identity keys remain the node's own (identity service); the stored
node-CA key is the material a production deployment would use to
certify them.
"""

from __future__ import annotations

import json
import threading
from ..utils import locks
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from ..utils import x509 as xu


class CertificateRequestException(Exception):
    """The signing request was rejected (HTTP 401 in the reference)."""


# ---------------------------------------------------------------------------
# Doorman: the signing authority + request ledger


class Doorman:
    """The permissioning authority: holds the network intermediate CA,
    keeps a ledger of signing requests, and issues node-CA chains.

    Request ids are the SHA-256 of the CSR's subject + public key
    (NOT the signed CSR bytes — ECDSA signatures are randomised, so a
    re-created CSR over the same key would hash differently). A node
    that lost its request-id file and resubmits with the same key
    resumes the same request instead of colliding with itself (the
    reference leaves this to the operator; determinism costs nothing).
    """

    def __init__(
        self,
        root: xu.CertAndKey,
        intermediate: xu.CertAndKey,
        auto_approve: bool = True,
        data_dir: Optional[str] = None,
    ):
        self.root = root
        self.intermediate = intermediate
        self.auto_approve = auto_approve
        self._dir = Path(data_dir) if data_dir else None
        self._lock = locks.make_lock("Doorman._lock")
        # id -> {"csr": pem, "status": pending|approved|rejected,
        #        "reason": str}
        self._requests: dict[str, dict] = {}
        if self._dir is not None:
            self._dir.mkdir(parents=True, exist_ok=True)
            journal = self._dir / "requests.json"
            if journal.exists():
                raw = json.loads(journal.read_text())
                self._requests = {
                    rid: {**r, "csr": r["csr"].encode()} for rid, r in raw.items()
                }

    @staticmethod
    def create(
        auto_approve: bool = True, data_dir: Optional[str] = None
    ) -> "Doorman":
        """Fresh authority (new root + intermediate), or reload one
        from `data_dir` if it was persisted there before."""
        if data_dir is not None:
            d = Path(data_dir)
            root_f, inter_f = d / "root.pem", d / "intermediate.pem"
            if root_f.exists() and inter_f.exists():
                return Doorman(
                    _load_certandkey(root_f),
                    _load_certandkey(inter_f),
                    auto_approve,
                    data_dir,
                )
        root = xu.create_root_ca()
        inter = xu.create_intermediate_ca(root)
        dm = Doorman(root, inter, auto_approve, data_dir)
        if data_dir is not None:
            d = Path(data_dir)
            (d / "root.pem").write_bytes(root.cert_pem + root.key_pem)
            (d / "intermediate.pem").write_bytes(inter.cert_pem + inter.key_pem)
        return dm

    def _persist(self) -> None:
        if self._dir is None:
            return
        raw = {
            rid: {**r, "csr": r["csr"].decode()}
            for rid, r in self._requests.items()
        }
        (self._dir / "requests.json").write_text(json.dumps(raw))

    def submit(self, csr_pem: bytes, email: str = "") -> str:
        import hashlib

        from cryptography.x509.oid import NameOID

        from ..utils.legal_name import validate_legal_name

        csr = xu.load_csr(csr_pem)          # raises on garbage
        if not csr.is_signature_valid:
            raise ValueError("CSR signature invalid")
        cn = csr.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
        name = cn[0].value if cn else ""
        rid = hashlib.sha256(
            csr.subject.public_bytes()
            + csr.public_key().public_bytes(_Enc.DER, _PubFmt.SubjectPublicKeyInfo)
        ).hexdigest()[:24]
        with self._lock:
            prior = self._requests.get(rid)
            if prior is not None and prior["status"] != "rejected":
                return rid
            # a resubmission of a previously-rejected request is
            # re-evaluated fresh (round-3 advisor): the operator may
            # have reversed a mistaken rejection or the conflicting
            # name may have freed up — the deterministic request id
            # must not wedge a subject+key on a stale rejection
            status = "approved" if self.auto_approve else "pending"
            reason = ""
            # the reference doorman auto-rejects rule-violating and
            # already-taken legal names (permissioning.rst; the name is
            # THE unique identifier on the network)
            try:
                validate_legal_name(name)
            except ValueError as e:
                status, reason = "rejected", str(e)
            else:
                taken = any(
                    r.get("name") == name and r["status"] != "rejected"
                    for r in self._requests.values()
                )
                if taken:
                    status = "rejected"
                    reason = f"legal name already in use: {name}"
            self._requests[rid] = {
                "csr": csr_pem, "status": status, "reason": reason,
                "name": name, "email": email,
            }
            self._persist()
        return rid

    def retrieve(self, request_id: str) -> Optional[list[bytes]]:
        """Leaf-first PEM chain if approved, None while pending.
        Raises CertificateRequestException if rejected, KeyError if
        the id is unknown."""
        with self._lock:
            req = self._requests[request_id]
            if req["status"] == "pending":
                return None
            if req["status"] == "rejected":
                raise CertificateRequestException(
                    "Certificate signing request has been rejected: "
                    f"{req['reason']}"
                )
            # issue exactly once: repeated polls must return THE
            # certificate, not a fresh one with a new serial
            if "chain" not in req:
                node_ca = xu.sign_csr_as_node_ca(
                    self.intermediate, xu.load_csr(req["csr"])
                )
                req["chain"] = [
                    node_ca.public_bytes(_PEM).decode(),
                    self.intermediate.cert_pem.decode(),
                    self.root.cert_pem.decode(),
                ]
                self._persist()
            return [p.encode() for p in req["chain"]]

    # -- operator surface (the doorman approval workflow) ---------------
    def pending(self) -> list[str]:
        with self._lock:
            return [
                rid for rid, r in self._requests.items()
                if r["status"] == "pending"
            ]

    def approve(self, request_id: str) -> None:
        self._set_status(request_id, "approved", "")

    def reject(self, request_id: str, reason: str) -> None:
        self._set_status(request_id, "rejected", reason)

    def _set_status(self, request_id: str, status: str, reason: str) -> None:
        with self._lock:
            self._requests[request_id]["status"] = status
            self._requests[request_id]["reason"] = reason
            self._persist()


def _load_certandkey(path: Path) -> xu.CertAndKey:
    blocks = dict(xu.pem_blocks(path.read_bytes()))
    return xu.CertAndKey(
        xu.load_cert(blocks["CERTIFICATE"]),
        xu.load_key(blocks["PRIVATE KEY"]),
    )


from cryptography.hazmat.primitives.serialization import (
    Encoding as _Enc,
    PublicFormat as _PubFmt,
)

_PEM = _Enc.PEM


# ---------------------------------------------------------------------------
# The service interface + transports (NetworkRegistrationService.kt:7)


class RegistrationService:
    """What the helper talks to: submit a CSR, poll for the chain."""

    def submit_request(self, csr_pem: bytes, email: str = "") -> str:
        raise NotImplementedError

    def retrieve_certificates(self, request_id: str) -> Optional[list[bytes]]:
        raise NotImplementedError


class InProcessRegistrationService(RegistrationService):
    """Direct doorman binding (tests / MockNetwork)."""

    def __init__(self, doorman: Doorman):
        self.doorman = doorman

    def submit_request(self, csr_pem: bytes, email: str = "") -> str:
        return self.doorman.submit(csr_pem, email)

    def retrieve_certificates(self, request_id: str) -> Optional[list[bytes]]:
        return self.doorman.retrieve(request_id)


class HttpRegistrationService(RegistrationService):
    """The production client (HTTPNetworkRegistrationService.kt:16):
    POST /api/certificate, GET /api/certificate/<id>."""

    client_version = "1.0"

    def __init__(self, server_url: str):
        self.server = server_url.rstrip("/")

    def submit_request(self, csr_pem: bytes, email: str = "") -> str:
        import urllib.request

        headers = {
            "Content-Type": "application/octet-stream",
            "Client-Version": self.client_version,
        }
        if email:
            # the reference submits emailAddress alongside the signing
            # request (NetworkRegistrationHelper.kt:132)
            headers["X-Email"] = email
        req = urllib.request.Request(
            f"{self.server}/api/certificate",
            data=csr_pem,
            method="POST",
            headers=headers,
        )
        with urllib.request.urlopen(req) as resp:
            return resp.read().decode()

    def retrieve_certificates(self, request_id: str) -> Optional[list[bytes]]:
        import urllib.error
        import urllib.request

        url = f"{self.server}/api/certificate/{request_id}"
        try:
            with urllib.request.urlopen(url) as resp:
                if resp.status == 204:
                    return None
                pems = json.loads(resp.read().decode())
                return [p.encode() for p in pems]
        except urllib.error.HTTPError as e:
            if e.code == 401:
                raise CertificateRequestException(e.read().decode()) from None
            raise


class PermissioningServer:
    """HTTP front for a Doorman (the server the reference never shipped).

      POST /api/certificate          submit CSR (PEM body) -> request id
      GET  /api/certificate/<id>     200 JSON [pem,...] | 204 | 401
      GET  /admin/requests           pending request ids
      POST /admin/approve/<id>       operator approval (manual mode)
      POST /admin/reject/<id>        body = reason

    The /admin surface shares the listener with the public /api, so
    when `admin_token` is set every /admin call must carry
    `Authorization: Bearer <token>` — without it, anyone who can reach
    the port could self-admit to the network.
    """

    def __init__(self, doorman: Doorman, host: str = "127.0.0.1",
                 port: int = 0, admin_token: Optional[str] = None):
        self.doorman = doorman
        self.admin_token = admin_token
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes = b"",
                      ctype: str = "text/plain"):
                self.send_response(code)
                if body:
                    self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _admin_ok(self) -> bool:
                if outer.admin_token is None:
                    return True
                auth = self.headers.get("Authorization", "")
                return auth == f"Bearer {outer.admin_token}"

            def do_GET(self):
                if self.path == "/admin/requests":
                    if not self._admin_ok():
                        self._send(403, b"admin token required")
                        return
                    self._send(
                        200,
                        json.dumps(outer.doorman.pending()).encode(),
                        "application/json",
                    )
                    return
                prefix = "/api/certificate/"
                if not self.path.startswith(prefix):
                    self._send(404)
                    return
                rid = self.path[len(prefix):]
                try:
                    chain = outer.doorman.retrieve(rid)
                except KeyError:
                    self._send(404, b"unknown request id")
                    return
                except CertificateRequestException as e:
                    self._send(401, str(e).encode())
                    return
                if chain is None:
                    self._send(204)
                else:
                    body = json.dumps([p.decode() for p in chain]).encode()
                    self._send(200, body, "application/json")

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if self.path == "/api/certificate":
                    try:
                        rid = outer.doorman.submit(
                            body, self.headers.get("X-Email", "")
                        )
                    except ValueError as e:
                        self._send(400, str(e).encode())
                        return
                    self._send(200, rid.encode())
                    return
                for action in ("approve", "reject"):
                    prefix = f"/admin/{action}/"
                    if self.path.startswith(prefix):
                        if not self._admin_ok():
                            self._send(403, b"admin token required")
                            return
                        rid = self.path[len(prefix):]
                        try:
                            if action == "approve":
                                outer.doorman.approve(rid)
                            else:
                                outer.doorman.reject(
                                    rid, body.decode() or "rejected"
                                )
                        except KeyError:
                            self._send(404, b"unknown request id")
                            return
                        self._send(200, b"ok")
                        return
                self._send(404)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "PermissioningServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# The node-side helper (NetworkRegistrationHelper.kt:31)


class NetworkRegistrationHelper:
    """Build the node's certificates directory by registering with the
    permissioning service. Restart-safe at every step: the in-flight
    key and request id are persisted, so a crash mid-poll resumes the
    SAME request with the SAME key (submitOrResumeCertificateSigning-
    Request); a completed registration is a no-op."""

    def __init__(
        self,
        base_dir: str,
        legal_name: str,
        service: RegistrationService,
        poll_interval: float = 10.0,
        max_polls: Optional[int] = None,
        log=print,
        email: str = "",
        network_root_pem: Optional[bytes] = None,
    ):
        """`email`: operator contact submitted with the CSR (the
        reference's emailAddress, NetworkRegistrationHelper.kt:132).
        `network_root_pem`: optional out-of-band pinned network root
        certificate — when set, the returned chain's root must match
        it byte-for-byte before anything is stored, closing the
        registration-time MITM window the plain-http transport leaves
        open (without it, trust-on-first-use like the reference)."""
        self.certs_dir = Path(base_dir) / "certificates"
        self.legal_name = legal_name
        self.service = service
        self.poll_interval = poll_interval
        self.max_polls = max_polls
        self.log = log
        self.email = email
        self.network_root_pem = network_root_pem
        self._request_id_file = self.certs_dir / "certificate-request-id.txt"
        self._temp_key_file = self.certs_dir / "selfsigned-key.pem"
        self.node_ca_file = self.certs_dir / "node-ca.pem"
        self.tls_file = self.certs_dir / "tls.pem"
        self.truststore_file = self.certs_dir / "truststore.pem"

    def build_keystore(self) -> bool:
        """True if a registration was performed, False if certificates
        already exist (the reference prints and terminates)."""
        from ..utils.legal_name import validate_legal_name

        validate_legal_name(self.legal_name)   # fail before any IO
        if self.node_ca_file.exists():
            self.log("Certificate already exists, nothing to do.")
            return False
        self.certs_dir.mkdir(parents=True, exist_ok=True)

        if self._temp_key_file.exists():
            key = xu.load_key(self._temp_key_file.read_bytes())
        else:
            key = xu.generate_tls_key()
            self._temp_key_file.write_bytes(xu.key_pem(key))

        request_id = self._submit_or_resume(key)
        try:
            chain_pems = self._poll(request_id)
        except CertificateRequestException:
            # a rejected request must not wedge the node: drop BOTH the
            # dead id AND the in-flight key — the request id is a hash
            # of subject+pubkey, so retrying over the same key would
            # resolve to the same (rejected) request forever (round-3
            # advisor)
            self._request_id_file.unlink(missing_ok=True)
            self._temp_key_file.unlink(missing_ok=True)
            raise

        certs = [xu.load_cert(p) for p in chain_pems]
        self._validate(certs, key)
        self.log(
            "Certificate signing request approved, storing private key "
            "with the certificate chain."
        )
        chain_blob = b"".join(c.public_bytes(_PEM) for c in certs)
        self.node_ca_file.write_bytes(xu.key_pem(key) + chain_blob)
        self.truststore_file.write_bytes(certs[-1].public_bytes(_PEM))

        # TLS leaf under the fresh node CA (the reference generates the
        # messaging-service SSL cert here too)
        node_ca = xu.CertAndKey(certs[0], key)
        tls = xu.create_leaf(node_ca, self.legal_name, tls=True)
        self.tls_file.write_bytes(tls.key_pem + tls.cert_pem + chain_blob)

        self._temp_key_file.unlink(missing_ok=True)
        self._request_id_file.unlink(missing_ok=True)
        self.log(f"Node certificates stored in {self.certs_dir}.")
        return True

    def _submit_or_resume(self, key) -> str:
        if self._request_id_file.exists():
            rid = self._request_id_file.read_text().strip()
            self.log(f"Resuming from previous request, request ID: {rid}.")
            return rid
        csr = xu.create_csr(self.legal_name, key)
        self.log(
            f"Submitting certificate signing request for "
            f"{self.legal_name!r} to the permissioning server."
        )
        rid = self.service.submit_request(xu.csr_pem(csr), self.email)
        self._request_id_file.write_text(rid)
        self.log(f"Successfully submitted request, request ID: {rid}.")
        return rid

    def _poll(self, request_id: str) -> list[bytes]:
        polls = 0
        while True:
            chain = self.service.retrieve_certificates(request_id)
            if chain is not None:
                return chain
            polls += 1
            if self.max_polls is not None and polls >= self.max_polls:
                raise TimeoutError(
                    f"request {request_id} still pending after {polls} polls"
                )
            time.sleep(self.poll_interval)

    def _validate(self, certs, key) -> None:
        spki = (_Enc.DER, _PubFmt.SubjectPublicKeyInfo)
        leaf_pub = certs[0].public_key().public_bytes(*spki)
        my_pub = key.public_key().public_bytes(*spki)
        if leaf_pub != my_pub:
            raise CertificateRequestException(
                "returned certificate is not over this node's key"
            )
        if not xu.validate_chain(*certs):
            raise CertificateRequestException(
                "returned certificate chain does not validate"
            )
        if self.network_root_pem is not None:
            pinned = xu.load_cert(self.network_root_pem)
            if certs[-1].public_bytes(_PEM) != pinned.public_bytes(_PEM):
                raise CertificateRequestException(
                    "returned chain's root does not match the pinned "
                    "network root (network_root_file) — possible MITM "
                    "on the registration transport"
                )


def main(argv=None) -> int:
    """Run a permissioning server:
    `python -m corda_tpu_torch.node.registration --port 8080 --data-dir dm/`"""
    import argparse

    parser = argparse.ArgumentParser(
        prog="corda_tpu_torch.node.registration",
        description="Run a network permissioning (doorman) server",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument(
        "--data-dir", default=None,
        help="persist CA material + request journal here",
    )
    parser.add_argument(
        "--manual", action="store_true",
        help="hold requests for operator approval via /admin endpoints",
    )
    parser.add_argument(
        "--admin-token", default=None,
        help="bearer token required on /admin calls; auto-generated "
        "(and printed) when --manual binds a non-loopback host",
    )
    args = parser.parse_args(argv)

    token = args.admin_token
    if (
        token is None
        and args.manual
        and args.host not in ("127.0.0.1", "localhost", "::1")
    ):
        # an unauthenticated /admin/approve on a reachable port would
        # let anyone self-admit to the network (round-3 advisor)
        import secrets

        token = secrets.token_urlsafe(16)
        print(
            f"ADMIN_TOKEN={token}  (auto-generated: --manual on a "
            "non-loopback host without --admin-token)",
            flush=True,
        )
    doorman = Doorman.create(
        auto_approve=not args.manual, data_dir=args.data_dir
    )
    server = PermissioningServer(
        doorman, args.host, args.port, admin_token=token
    ).start()
    print(f"DOORMAN_URL={server.url}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
