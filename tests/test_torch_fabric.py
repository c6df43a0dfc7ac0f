"""The TCP fabric (node/fabric.py) and cordform in the port, held against
the reference.

Every case of the reference's tests/test_fabric.py (13) and
tests/test_cordform.py (2) runs with its imports read as
corda_tpu_torch (test_torch_persistence.port_module) on the port, over
real localhost sockets, and must pass its own assertions (the deployed
tree binds a free port range in place of the reference's static one,
which the reference's own run of that case holds); the two
two-process cases and the deployed tree's boot run their child
processes on the port too. The reference side of each case is the
reference's own module. These runs are not recorded frame for frame:
every connection's handshake nonce and every TLS certificate is fresh.
The wire is held byte for byte here instead:
- every frame kind `_write_frame` writes (msg with and without headers,
  challenge, auth, ok, reject, ack) and the headers blob, each read back
  by the other package's `_read_frame`;
- the uid mapping at the sqlite boundary;
- a journal's sqlite dump (fabric_out, fabric_in, fabric_meta) after
  the same seeded sends, ingests and pumps on the same key;
- a TLS identity's fingerprint.
"""

from __future__ import annotations

import asyncio
import importlib
import inspect
import random
import re
import socket
import sqlite3
import sys
import types

import pytest

pytest.importorskip("torch")

from test_torch_persistence import TESTS, _dump_sqlite, port_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")


def port_cases(name: str, left_out: dict) -> list:
    """(name, case) for every case of a reference module that is not in
    `left_out` (case -> reason), marked slow where the reference marks
    it slow."""
    mod = importlib.import_module(f"tests.{name}")

    def marks(fn):
        slow = any(m.name == "slow" for m in getattr(fn, "pytestmark", ()))
        return (pytest.mark.slow,) if slow else ()

    return [pytest.param(name, case, id=case, marks=marks(fn))
            for case, fn in vars(mod).items()
            if case.startswith("test_") and callable(fn) and case not in left_out]


def run_port_case(mod, case: str, tmp_path, **given) -> None:
    """One reference case, from the port module `mod`, with its fixtures
    (plain or generator, and the fixtures they take) built once each the
    way pytest builds them; `given` supplies pytest's own fixtures (e.g.
    monkeypatch) by name."""
    fn = getattr(mod, case)
    teardown, built, counter = [], dict(given), iter(range(100))

    def tmp():
        d = tmp_path / f"tmp{next(counter)}"
        d.mkdir()
        return d

    def build(arg):
        if arg == "tmp_path":
            return tmp()
        if arg not in built:
            fixture = getattr(mod, arg).__wrapped__
            value = fixture(**{a: build(a) for a in inspect.signature(fixture).parameters})
            if inspect.isgenerator(value):
                teardown.append(value)
                value = next(value)
            built[arg] = value
        return built[arg]

    try:
        fn(**{arg: build(arg) for arg in inspect.signature(fn).parameters})
    finally:
        for gen in reversed(teardown):
            for _ in gen:
                pass


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


# ---------------------------------------------------------------------------
# the reference's cases on the port


def _free_base(n: int) -> int:
    """A port p with p .. p + n - 1 free now."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        try:
            held = []
            for k in range(n):
                held.append(socket.socket())
                held[-1].bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for h in held:
                h.close()
    raise RuntimeError("no free port range")


def cordform_port_module() -> types.ModuleType:
    """tests/test_cordform.py on the port. Its deployed tree binds the
    static ports 31840-31842, as the reference's own run of the module
    does; the port's run takes a free range instead, so the two runs
    never contend for a port."""
    key = "_torch_port_test_cordform"
    if key not in sys.modules:
        src = (TESTS / "test_cordform.py").read_text()
        assert src.count("    base = 31840\n") == 1
        src = src.replace("    base = 31840\n", f"    base = {_free_base(3)}\n")
        src = re.sub(r"\bcorda_tpu\.", "corda_tpu_torch.", src)
        mod = types.ModuleType(key)
        mod.__file__ = str(TESTS / "test_cordform.py")
        sys.modules[key] = mod
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return sys.modules[key]


@pytest.mark.parametrize("name,case",
                         port_cases("test_fabric", {}) + port_cases("test_cordform", {}))
def test_reference_case_on_the_port(name, case, tmp_path):
    mod = cordform_port_module() if name == "test_cordform" else port_module(name)
    run_port_case(mod, case, tmp_path)


def test_case_count():
    assert [len(port_cases(n, {})) for n in ("test_fabric", "test_cordform")] == [13, 2]


# ---------------------------------------------------------------------------
# the wire, byte for byte


class _Writer:
    def __init__(self):
        self.data = bytearray()

    def write(self, b: bytes) -> None:
        self.data += b


def _frames(prefix: str) -> list:
    schemes = _m(prefix, "crypto.schemes")
    fabric = _m(prefix, "node.fabric")
    kp = schemes.generate_keypair(seed=7)
    nonce = bytes(range(32))
    headers = fabric._encode_headers((2**63 + 5, 77, 123456), 9_000_000)
    return [
        ["msg", 1, "platform.session", b"payload", 42],
        ["msg", 2, "verifier.requests", bytes(300), 2**64 - 1, headers],
        ["challenge", nonce],
        ["auth", "Alice", kp.public.scheme_id, kp.public.data,
         kp.private.sign(b"fabric-auth" + nonce), "127.0.0.1", 10002, b"\x01" * 32],
        ["ok"],
        ["reject", "identity key mismatch"],
        ["ack", 2],
    ]


def _wire(prefix: str) -> bytes:
    fabric = _m(prefix, "node.fabric")
    w = _Writer()
    for frame in _frames(prefix):
        fabric._write_frame(w, frame)
    return bytes(w.data)


def _read_all(prefix: str, data: bytes) -> list:
    fabric = _m(prefix, "node.fabric")

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        out = []
        for _ in range(7):
            out.append(await fabric._read_frame(reader))
        return out

    return asyncio.run(go())


def test_frames_and_headers_are_the_references():
    ref, port = _wire("corda_tpu"), _wire("corda_tpu_torch")
    assert port == ref and len(ref) > 600
    # each package reads the other's bytes back to the same frames
    assert _read_all("corda_tpu_torch", ref) == _read_all("corda_tpu", port) \
        == _frames("corda_tpu_torch")
    for prefix in PACKAGES:
        fabric = _m(prefix, "node.fabric")
        blob = fabric._encode_headers((1, 2, 3), None)
        assert fabric._decode_headers(blob) == ((1, 2, 3), None)
        assert fabric._encode_headers(None, None) is None
    assert _m("corda_tpu", "node.fabric")._encode_headers((1, 2, 3), 4) == \
        _m("corda_tpu_torch", "node.fabric")._encode_headers((1, 2, 3), 4)


@pytest.mark.parametrize("uid", [0, 1, 2**63 - 1, 2**63, 2**64 - 1])
def test_uid_mapping_is_the_references(uid):
    ref, port = _m("corda_tpu", "node.fabric"), _m("corda_tpu_torch", "node.fabric")
    assert port._to_db_uid(uid) == ref._to_db_uid(uid)
    assert port._from_db_uid(port._to_db_uid(uid)) == uid


def _journal_dump(prefix: str, path) -> list:
    """Seeded sends, ingests and a pump on an unstarted endpoint; the
    journal's sqlite dump."""
    schemes = _m(prefix, "crypto.schemes")
    fabric = _m(prefix, "node.fabric")
    db = _m(prefix, "node.persistence").NodeDatabase(str(path))
    ep = fabric.FabricEndpoint("Alice", schemes.generate_keypair(seed=3), db,
                               resolve=lambda peer: None)
    rng = random.Random(5)
    for k in range(40):
        uid = None if k % 3 else rng.getrandbits(64)
        trace = (rng.getrandbits(64), rng.getrandbits(32), k) if k % 4 == 0 else None
        deadline = 10_000_000 + k if k % 5 == 0 else None
        ep.send(f"topic.{k % 3}", rng.randbytes(k + 1), f"peer{k % 4}",
                unique_id=uid, trace=trace, deadline=deadline)
    got = []
    ep.add_handler("topic.0", lambda msg: got.append((msg.sender, msg.unique_id, msg.trace,
                                                      msg.deadline, msg.payload)))
    for k in range(30):
        headers = fabric._encode_headers((k, k + 1, k + 2), None) if k % 2 else None
        ep._ingest(f"peer{k % 3}", f"topic.{k % 2}", rng.randbytes(8), rng.getrandbits(64),
                   headers)
    ep._ingest("peer0", "topic.0", b"dup", 7)
    ep._ingest("peer0", "topic.0", b"dup", 7)    # the (sender, uid) key swallows it
    delivered = ep.pump()
    depths = ep.wire_depths()
    db.close()
    conn = sqlite3.connect(str(path))
    try:
        return [_dump_sqlite(conn), got, delivered, depths]
    finally:
        conn.close()


def test_journal_dump_equals_the_references(tmp_path):
    ref = _journal_dump("corda_tpu", tmp_path / "ref.db")
    port = _journal_dump("corda_tpu_torch", tmp_path / "port.db")
    assert port == ref
    tables = {t for kind, t, _, rows in ref[0] if kind == "table" and rows}
    assert {"fabric_out", "fabric_in", "fabric_meta"} <= tables and ref[2] == 16


def test_tls_fingerprint_is_the_references():
    from corda_tpu_torch.testing.dev_tls import dev_tls_pems

    pem = dev_tls_pems()[0]
    cut = pem.index(b"-----BEGIN CERTIFICATE-----")
    ids = [_m(p, "node.fabric").TlsIdentity(pem[cut:], pem[:cut]) for p in PACKAGES]
    assert ids[0].fingerprint == ids[1].fingerprint and len(ids[1].fingerprint) == 32
