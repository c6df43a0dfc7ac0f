"""BatchSignatureVerifier SPI — the verification seam, on the card.

Port of corda_tpu/crypto/batch_verifier.py for the EC schemes
(ed25519, the default, and ECDSA over secp256r1 and secp256k1). Callers
hand `verify_batch` a sequence of (key, signature, message)
requests and get one bool per request, in order.

Implementations:
  * CpuBatchVerifier  — pure-python reference semantics (refmath), one
    request at a time on the host: the bit-exactness anchor.
  * CudaBatchVerifier — the TpuBatchVerifier counterpart: per-scheme
    buckets (one call may mix schemes), padding to the configured batch
    sizes, chunking at the largest, staging into pinned host buffers,
    the torch prologue and the CUDA ladder kernel on the card, and a
    non-blocking copy of each chunk's result back to the host behind a
    CUDA event, so PendingVerification.chunks() streams: it waits for
    compute only. With `mesh=` (parallel/mesh.py) each padded chunk
    splits into one contiguous slice of rows per mesh device, each slice
    verified on its own card, on that card's current stream.

per_shard_verifiers builds one verifier per commit-plane shard, pinned
to `devices[k % len(devices)]`: the sharded notary's per-card dispatch.

Rows of a scheme that has no kernel in either package (RSA_SHA256 and
SPHINCS256_SHA256: HOST_SCHEMES) are verified on the host by the CPU
reference, after every device chunk of the call has been dispatched, so
that work overlaps the card's — the reference's semantics
(corda_tpu/crypto/batch_verifier.py:430). A row of a scheme with a
kernel never goes to the host, and any other id (COMPOSITE, unknown)
raises UnsupportedScheme. A CUDA error or a refused launch raises
DeviceFaultError, the class the batching notary's degraded mode catches.

Every chunk is accounted as in the reference: the staging copy's bytes
and seconds (`record_transfer` on the kernel and the device ledgers),
the launch wall (`KernelAccounting.record_call`: the first call of a
(scheme, batch) on this instance is the "compile", where the kernels'
build and module load land) and `DeviceAccounting.record_dispatch`
(busy = the launch wall, with the queue wait since the bucket's entry),
and each launch is named by `tracing.annotate` in a torch.profiler
capture. The device ledger's key is the pinned device's index, the
current card's for an unpinned verifier, 0 on the plain CPU, and -1 for
a mesh dispatch (one chunk over every mesh device), as in the reference.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh as meshlib
from ..utils import device_telemetry as devlib
from ..utils import perf as perflib
from ..utils import tracing
from . import encodings, schemes
from .cuda_ec import DeviceFaultError
from .ecdsa import ecdsa_verify_packed
from .eddsa import ed25519_verify_packed


@dataclass(frozen=True)
class VerificationRequest:
    """One signature check: does `signature` by `key` cover `message`?"""

    key: schemes.PublicKey
    signature: bytes
    message: bytes


SCHEME_KERNELS = frozenset(
    {
        schemes.ECDSA_SECP256K1_SHA256,
        schemes.ECDSA_SECP256R1_SHA256,
        schemes.EDDSA_ED25519_SHA512,
    }
)

# schemes no device path verifies, in either package: host rows
HOST_SCHEMES = frozenset({schemes.RSA_SHA256, schemes.SPHINCS256_SHA256})


class BatchSignatureVerifier:
    """SPI: verify a batch of signature requests, preserving order."""

    def verify_batch(self, requests: Sequence[VerificationRequest]) -> list[bool]:
        raise NotImplementedError


class CpuBatchVerifier(BatchSignatureVerifier):
    """Reference semantics, one at a time on the host."""

    def verify_batch(self, requests: Sequence[VerificationRequest]) -> list[bool]:
        return [
            schemes.verify_one(r.key, r.signature, r.message) for r in requests
        ]


_CUDA_ERRORS = tuple(
    t for t in (getattr(torch, "AcceleratorError", None),) if t is not None
)


@contextmanager
def _device_faults(what: str):
    """Re-raise a CUDA runtime error inside the block as DeviceFaultError."""
    try:
        yield
    except DeviceFaultError:
        raise
    except RuntimeError as e:
        if isinstance(e, _CUDA_ERRORS) or "CUDA" in str(e):
            raise DeviceFaultError(f"{what}: {e}") from e
        raise


_TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _pinned(a: np.ndarray) -> torch.Tensor:
    """A pinned host tensor holding `a`, written once."""
    h = torch.empty(a.shape, dtype=_TORCH_DTYPES[a.dtype], pin_memory=True)
    h.numpy()[:] = a
    return h


@dataclass
class _Chunk:
    result: torch.Tensor        # [batch] bool on the host
    idxs: list                  # request indices of the first n rows
    n: int
    started: Optional[torch.cuda.Event] = None   # None on the CPU path
    done: Optional[torch.cuda.Event] = None
    keep: tuple = ()            # pinned staging buffers, alive until `done`


def _check_device(device: torch.device) -> None:
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: CudaBatchVerifier runs on the "
                "card (pass device='cpu' to run the plain torch versions)"
            )
        if device.index is not None and device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{device} is not a visible card ({torch.cuda.device_count()} visible)"
            )
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")


class CudaBatchVerifier(BatchSignatureVerifier):
    """Batched verification on CUDA devices with per-scheme bucketing.

    `device` (None: "cuda", the current card) pins every dispatch to one
    device; construction raises where CUDA is not available;
    `device="cpu"` runs the same path with the kernels' plain torch
    versions (the tests do). `windowed` forces the windowed (True) or
    plain (False) ladder for every curve; None keeps each curve's
    default (cuda_ec.use_windowed_ladder).

    `mesh` (parallel/mesh.Mesh; mutually exclusive with `device`): each
    chunk, padded to its batch size, splits into one contiguous slice
    of rows per mesh device in mesh order, every slice staged through
    its own pinned buffers and verified on its own device, and the
    answers gathered back into request order only after every slice
    was issued; a slice that holds only padding rows is not launched.
    A mesh of CPU devices runs the same split on the plain versions.
    Every batch size must split evenly over the mesh. A fault
    on any card raises DeviceFaultError naming it; nothing is re-run
    elsewhere.

    `perf`: a utils/perf.KernelAccounting this verifier records its
    per-(scheme, batch) first-call-vs-execute timings, retraces and
    transfer bytes into; None records into the process default
    (perf.get_kernel_accounting()), which the node's PerfPlane adopts.
    The device ledger is always the process default
    (device_telemetry.get_device_accounting()).
    """

    def __init__(
        self,
        batch_sizes: tuple[int, ...] = (128, 1024, 4096),
        device=None,
        windowed: Optional[bool] = None,
        perf=None,
        mesh: Optional[meshlib.Mesh] = None,
    ):
        if device is not None and mesh is not None:
            raise ValueError("device= and mesh= are mutually exclusive")
        self._cpu = CpuBatchVerifier()
        self.mesh = mesh
        if mesh is None:
            self.device = torch.device("cuda" if device is None else device)
            _check_device(self.device)
        else:
            self.device = None
            for dev in mesh.device_list():
                _check_device(dev)
        if not batch_sizes or min(batch_sizes) <= 0:
            raise ValueError(f"bad batch_sizes {batch_sizes!r}")
        self.batch_sizes = tuple(sorted(batch_sizes))
        if mesh is not None:
            for b in self.batch_sizes:
                meshlib.batch_sharding(mesh, 1).rows_per_device(b)
        self.windowed = windowed
        self.perf = perf
        # first-call-per-key is judged per instance, as in the reference:
        # each instance's first launch of a (scheme, batch) records as
        # the "compile" on a possibly shared ledger
        self._warm_shapes: set = set()
        self._device_id: Optional[int] = None

    def _pick_batch(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def _dispatch_device_id(self) -> int:
        if self._device_id is None:
            if self.mesh is not None:
                self._device_id = -1
            elif self.device.index is not None:
                self._device_id = self.device.index
            elif self.device.type == "cpu":
                self._device_id = 0
            else:
                self._device_id = torch.cuda.current_device()
        return self._device_id

    @staticmethod
    def _launch_on(device: torch.device, verify, arrays: tuple, span: str) -> tuple:
        """verify(*tensors) on `device` from staged numpy arrays: as torch
        tensors on a CPU device; on a card through pinned buffers and
        non-blocking copies on its current stream, with the result
        copied back behind the slice's event. A CUDA error raises
        DeviceFaultError naming the device. Returns (_Chunk fields: host
        result, started, done, pinned buffers; then put seconds, launch
        seconds and the launch's start)."""
        if device.type == "cpu":
            t_put = time.perf_counter()
            staged = tuple(torch.from_numpy(a.copy()) for a in arrays)
            put_s = time.perf_counter() - t_put
            t_call = time.perf_counter()
            with _device_faults(f"verify dispatch on {device}"), tracing.annotate(span):
                out = verify(*staged)
            return out, None, None, (), put_s, time.perf_counter() - t_call, t_call
        with _device_faults(f"verify dispatch on {device}"), torch.cuda.device(device):
            t_put = time.perf_counter()
            hosts = tuple(_pinned(a) for a in arrays)
            started = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            started.record()
            staged = tuple(h.to(device, non_blocking=True) for h in hosts)
            put_s = time.perf_counter() - t_put
            t_call = time.perf_counter()
            with tracing.annotate(span):
                res = verify(*staged)
            call_s = time.perf_counter() - t_call
            out = torch.empty(res.shape, dtype=torch.bool, pin_memory=True)
            out.copy_(res, non_blocking=True)
            done.record()
        return out, started, done, hosts, put_s, call_s, t_call

    def _run_chunk(self, scheme_id: int, batch: int, verify, arrays: tuple, idxs, n,
                   t_entry: float) -> list:
        """Run verify on one chunk's staged numpy arrays, on this
        verifier's device or slice by slice over its mesh; returns a
        _Chunk per device. The copy in (bytes and host seconds) and the
        launch wall, summed over the slices, go to the kernel and device
        ledgers."""
        acct = self.perf if self.perf is not None else perflib.get_kernel_accounting()
        devacct = devlib.get_device_accounting()
        dev_id = self._dispatch_device_id()
        first = (scheme_id, batch) not in self._warm_shapes
        span = f"corda_tpu.verify_dispatch.s{scheme_id}.b{batch}"
        if self.mesh is None:
            parts = [(self.device, 0, batch)]
        else:
            ranges = meshlib.batch_sharding(self.mesh, 1).row_ranges(batch)
            parts = [(dev, lo, hi) for dev, (lo, hi) in zip(self.mesh.device_list(), ranges)]
        chunks, nbytes, put_s, call_s, t_call = [], 0, 0.0, 0.0, None
        for dev, lo, hi in parts:
            if lo >= n:
                break           # the rest hold only padding rows: no answer to compute
            part = tuple(a[lo:hi] for a in arrays)
            out, started, done, hosts, p, c, t = self._launch_on(dev, verify, part, span)
            nbytes += sum(int(a.nbytes) for a in part)
            put_s, call_s = put_s + p, call_s + c
            t_call = t if t_call is None else t_call
            chunks.append(_Chunk(out, idxs[lo:min(hi, n)], min(hi, n) - lo, started, done,
                                 hosts))
        self._warm_shapes.add((scheme_id, batch))
        acct.record_transfer(scheme_id, batch, nbytes, put_s)
        devacct.record_transfer(dev_id, nbytes, put_s)
        acct.record_call(scheme_id, batch, call_s, first=first)
        devacct.record_dispatch(dev_id, n, call_s, queue_wait_seconds=t_call - t_entry)
        return chunks

    def _dispatch(self, scheme_id: int, items: list, idxs: list):
        """Stage + launch one scheme bucket, chunking at the largest
        batch size; returns ([_Chunk], host staging seconds) without
        waiting for the device, so staging chunk k+1 overlaps chunk k's
        device work."""
        if scheme_id == schemes.EDDSA_ED25519_SHA512:
            stage = encodings.stage_ed25519_packed
            verify = partial(ed25519_verify_packed, windowed=self.windowed)
        else:
            curve = schemes.WCURVE[scheme_id]
            stage = partial(encodings.stage_ecdsa_packed, curve)
            verify = partial(ecdsa_verify_packed, curve, windowed=self.windowed)
        max_b = self.batch_sizes[-1]
        chunks, stage_s = [], 0.0
        t_entry = time.perf_counter()
        for off in range(0, len(items), max_b):
            chunk = items[off : off + max_b]
            batch = self._pick_batch(len(chunk))
            t0 = time.perf_counter()
            arrays = stage(chunk, batch)
            stage_s += time.perf_counter() - t0
            chunks.extend(self._run_chunk(scheme_id, batch, verify, arrays,
                                          idxs[off : off + len(chunk)], len(chunk), t_entry))
        return chunks, stage_s

    # -- SPI ---------------------------------------------------------------

    def verify_batch_async(
        self, requests: Sequence[VerificationRequest]
    ) -> "PendingVerification":
        """Stage + dispatch every request without waiting for results;
        collect with `.result()` or stream with `.chunks()`. Host rows
        (HOST_SCHEMES) are verified after the device chunks are
        dispatched, while the card works, and are known on return."""
        buckets: dict[int, tuple[list, list]] = {}
        host_idx: list[int] = []
        for i, req in enumerate(requests):
            sid = req.key.scheme_id
            if sid in SCHEME_KERNELS:
                items, idxs = buckets.setdefault(sid, ([], []))
                items.append((req.key.data, req.signature, req.message))
                idxs.append(i)
            elif sid in HOST_SCHEMES:
                host_idx.append(i)
            else:
                name = schemes.CODE_NAMES.get(sid, str(sid))
                raise schemes.UnsupportedScheme(
                    f"{name} has no batch verification path"
                )
        pending, stage_s = [], 0.0
        for sid, (items, idxs) in buckets.items():
            chunks, s = self._dispatch(sid, items, idxs)
            pending.extend(chunks)
            stage_s += s
        out: list = [None] * len(requests)
        host_s = 0.0
        if host_idx:
            t0 = time.perf_counter()
            for i, ok in zip(host_idx, self._cpu.verify_batch([requests[i] for i in host_idx])):
                out[i] = ok
            host_s = time.perf_counter() - t0
        return PendingVerification(
            out, pending, streamed=True, stage_seconds=stage_s,
            host_rows=host_idx, host_seconds=host_s,
        )

    def verify_batch(self, requests: Sequence[VerificationRequest]) -> list[bool]:
        return self.verify_batch_async(requests).result()


class PendingVerification:
    """Handle for an in-flight CudaBatchVerifier dispatch."""

    def __init__(
        self, out, chunks, streamed: bool = False, stage_seconds: float = 0.0,
        host_rows: Sequence[int] = (), host_seconds: float = 0.0,
    ):
        self._out = out
        self._chunks = chunks
        self._done = False
        # True when every chunk's device->host copy was queued at
        # dispatch: per-chunk consumption then waits for compute only
        self.streamed = streamed
        self.stage_seconds = stage_seconds
        # the rows verified on the host (HOST_SCHEMES), already in `out`,
        # and the host seconds they took
        self.host_rows = list(host_rows)
        self.host_seconds = host_seconds

    def skeleton(self) -> list:
        """A copy of the result rows known without waiting on the
        device: the host rows filled, device rows None."""
        return list(self._out)

    def chunks(self):
        """Yield (request_indices, [bool]) per chunk: the host rows
        first (already known), then each device chunk in dispatch order,
        as its compute completes."""
        if self.host_rows:
            yield list(self.host_rows), [self._out[i] for i in self.host_rows]
        for ch in self._chunks:
            if ch.done is not None:
                with _device_faults("verify result"):
                    ch.done.synchronize()
            yield ch.idxs, [bool(v) for v in ch.result[: ch.n].tolist()]

    def result(self) -> list[bool]:
        if not self._done:
            out = self._out
            for chunk_idxs, vals in self.chunks():
                for j, ok in zip(chunk_idxs, vals):
                    out[j] = ok
            # only mark done once every chunk arrived: a failure must
            # surface again on retry, not hand back None rows
            self._out = [bool(v) for v in out]
            self._done = True
        return self._out

    def device_seconds(self) -> float:
        """Device time of the chunks, dispatch to result copy, summed
        (CUDA events; 0.0 on the CPU path). Call after the results."""
        total = 0.0
        for ch in self._chunks:
            if ch.done is not None:
                ch.done.synchronize()
                total += ch.started.elapsed_time(ch.done) / 1000.0
        return total


class DispatchFaultInjector(BatchSignatureVerifier):
    """Fault seam at the verify dispatch: while armed, the next
    `failures_left` dispatches raise DeviceFaultError (or
    `exc_factory()`) instead of reaching the device; after that every
    call passes through to the wrapped verifier untouched."""

    def __init__(self, inner: BatchSignatureVerifier):
        self.inner = inner
        self.failures_left = 0
        self.faults_raised = 0
        self._exc_factory = None

    def arm(self, failures: int = 1, exc_factory=None) -> None:
        self.failures_left = int(failures)
        self._exc_factory = exc_factory

    def disarm(self) -> None:
        self.failures_left = 0

    @property
    def armed(self) -> bool:
        return self.failures_left > 0

    def _maybe_fault(self) -> None:
        if self.failures_left > 0:
            self.failures_left -= 1
            self.faults_raised += 1
            raise (
                self._exc_factory()
                if self._exc_factory is not None
                else DeviceFaultError("injected device fault (dispatch seam)")
            )

    def verify_batch(self, requests: Sequence[VerificationRequest]) -> list[bool]:
        self._maybe_fault()
        return self.inner.verify_batch(requests)

    def verify_batch_async(self, requests: Sequence[VerificationRequest]):
        self._maybe_fault()
        inner_async = getattr(self.inner, "verify_batch_async", None)
        if inner_async is not None:
            return inner_async(requests)
        return PendingVerification(self.inner.verify_batch(requests), [])


def per_shard_verifiers(
    n_shards: int,
    batch_sizes: tuple[int, ...] = (128, 1024, 4096),
    devices: Optional[Sequence] = None,
) -> list:
    """One CudaBatchVerifier per commit-plane shard (notary.py
    BatchingNotaryService shard_verifiers=): shard k is pinned to
    devices[k % len(devices)], so N shard flushes drive N cards at once.
    With one device every shard shares it unpinned, as in the reference
    (shard k+1's staging still overlaps shard k's card work). `devices`
    None means every card, and raises where there is none."""
    devices = meshlib.cuda_devices() if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("no devices for per-shard verifiers")
    out = []
    for k in range(max(1, n_shards)):
        dev = devices[k % len(devices)]
        out.append(CudaBatchVerifier(
            batch_sizes=batch_sizes,
            device=dev if len(devices) > 1 else torch.device(dev.type),
        ))
    return out


_default: Optional[BatchSignatureVerifier] = None


def default_verifier() -> BatchSignatureVerifier:
    """Process-wide verifier: a CudaBatchVerifier on the default card,
    constructed on first use (raises where CUDA is not available)."""
    global _default
    if _default is None:
        _default = CudaBatchVerifier()
    return _default


def set_default_verifier(v: BatchSignatureVerifier) -> None:
    global _default
    _default = v

