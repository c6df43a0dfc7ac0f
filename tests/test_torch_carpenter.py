"""The class carpenter (core/carpenter.py) and the codec's handler slot
(core/serialization.py) in the port, held against the reference.

- Every case of the reference's tests/test_carpenter.py runs on the port
  with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module): synthesis, bit-identical
  re-encoding, shared types per schema, nesting, hostile names refused,
  evolution tolerance and known types untouched.
- The handler slot is per thread: while one thread holds a carpenter
  context, a decode on another thread (as the TCP fabric's loop thread
  decodes frames) stays whitelist-only, on the native and the Python
  codec, and the holder is strict again once its context ends.
- The four-way decode of unknown tags inside a context (the port's
  native and Python codecs, the reference's Python codec and its C
  library) is in tests/test_torch_native.py.
"""

from __future__ import annotations

import threading

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402


@pytest.mark.parametrize("name,case", port_cases("test_carpenter", {}))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(port_test_module("test_carpenter"), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_carpenter", {})) == 7


def _unknown() -> bytes:
    mod = port_test_module("test_carpenter")
    return mod._wire_object("FabricOnlyThing", {"x": 3, "who": "bob"})


def test_other_threads_stay_strict_while_one_holds_a_context():
    from corda_tpu_torch.core import carpenter
    from corda_tpu_torch.core import serialization as ser

    buf = _unknown()
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def holder():
        with carpenter.carpenter_context():
            seen["holder"] = (ser.decode(buf), ser.decode_py(buf))
            inside.set()
            release.wait(30)
        seen["after"] = [_outcome(lambda d=d: d(buf)) for d in (ser.decode, ser.decode_py)]

    def fabric_loop():
        seen["loop"] = [_outcome(lambda d=d: d(buf)) for d in (ser.decode, ser.decode_py)]

    t = threading.Thread(target=holder)
    t.start()
    assert inside.wait(30)
    try:
        loop = threading.Thread(target=fabric_loop, name="fabric-loop")
        loop.start()
        loop.join(30)
        main = [_outcome(lambda d=d: d(buf)) for d in (ser.decode, ser.decode_py)]
    finally:
        release.set()
        t.join(30)
    strict = [("err", "SerializationError")] * 2
    assert seen["loop"] == main == seen["after"] == strict
    native, python = seen["holder"]
    assert carpenter.is_synthesized(native) and native == python
    assert (native.x, native.who) == (3, "bob") and ser.encode(native) == buf
    assert ser._unknown_tag_handler() is None


def _outcome(fn):
    try:
        fn()
        return ("ok",)
    except Exception as e:  # noqa: BLE001 - outcome comparison
        return ("err", type(e).__name__)
