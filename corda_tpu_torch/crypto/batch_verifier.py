"""BatchSignatureVerifier SPI — the verification seam, on the card.

Port of corda_tpu/crypto/batch_verifier.py for the ECDSA schemes.
Callers hand `verify_batch` a sequence of (key, signature, message)
requests and get one bool per request, in order.

Implementations:
  * CpuBatchVerifier  — pure-python reference semantics (refmath), one
    request at a time on the host: the bit-exactness anchor.
  * CudaBatchVerifier — the TpuBatchVerifier counterpart: per-scheme
    buckets, padding to the configured batch sizes, chunking at the
    largest, staging into pinned host buffers, the torch prologue and
    the CUDA ladder kernel on the card, and a non-blocking copy of each
    chunk's result back to the host behind a CUDA event, so
    PendingVerification.chunks() streams: it waits for compute only.

Schemes without a kernel in this slice (ed25519, RSA, SPHINCS,
composite) raise UnsupportedScheme; nothing is routed to the CPU. A
CUDA error or a refused launch raises DeviceFaultError, the class the
batching notary's degraded mode catches.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from . import encodings, schemes
from .cuda_ec import DeviceFaultError
from .ecdsa import ecdsa_verify_packed


@dataclass(frozen=True)
class VerificationRequest:
    """One signature check: does `signature` by `key` cover `message`?"""

    key: schemes.PublicKey
    signature: bytes
    message: bytes


SCHEME_KERNELS = frozenset(
    {schemes.ECDSA_SECP256K1_SHA256, schemes.ECDSA_SECP256R1_SHA256}
)


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


@dataclass
class _Chunk:
    result: torch.Tensor        # [batch] bool on the host
    idxs: list                  # request indices of the first n rows
    n: int
    started: Optional[torch.cuda.Event] = None   # None on the CPU path
    done: Optional[torch.cuda.Event] = None
    keep: tuple = ()            # pinned staging buffers, alive until `done`


class CudaBatchVerifier(BatchSignatureVerifier):
    """Batched verification on one CUDA device with per-scheme bucketing.

    `device` defaults to "cuda" and construction raises where CUDA is
    not available; `device="cpu"` runs the same path with the kernels'
    plain torch versions (the tests do). `windowed` forces the windowed
    (True) or plain (False) ladder for every curve; None keeps each
    curve's default (cuda_ec.use_windowed_ladder).
    """

    def __init__(
        self,
        batch_sizes: tuple[int, ...] = (128, 1024, 4096),
        device="cuda",
        windowed: Optional[bool] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available: CudaBatchVerifier runs on the "
                    "card (pass device='cpu' to run the plain torch versions)"
                )
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        if not batch_sizes or min(batch_sizes) <= 0:
            raise ValueError(f"bad batch_sizes {batch_sizes!r}")
        self.batch_sizes = tuple(sorted(batch_sizes))
        self.windowed = windowed

    def _pick_batch(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def _run_chunk(self, curve, packed: np.ndarray, valid: np.ndarray, idxs, n):
        if self.device.type == "cpu":
            res = ecdsa_verify_packed(
                curve, torch.from_numpy(packed.copy()),
                torch.from_numpy(valid.copy()), windowed=self.windowed,
            )
            return _Chunk(res, idxs, n)
        with _device_faults("verify dispatch"), torch.cuda.device(self.device):
            pk_host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
            pk_host.numpy()[:] = packed
            va_host = torch.empty(valid.shape, dtype=torch.bool, pin_memory=True)
            va_host.numpy()[:] = valid
            started = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            started.record()
            res = ecdsa_verify_packed(
                curve,
                pk_host.to(self.device, non_blocking=True),
                va_host.to(self.device, non_blocking=True),
                windowed=self.windowed,
            )
            out = torch.empty(res.shape, dtype=torch.bool, pin_memory=True)
            out.copy_(res, non_blocking=True)
            done.record()
        return _Chunk(out, idxs, n, started, done, (pk_host, va_host))

    def _dispatch(self, scheme_id: int, items: list, idxs: list):
        """Stage + launch one scheme bucket, chunking at the largest
        batch size; returns ([_Chunk], host staging seconds) without
        waiting for the device, so staging chunk k+1 overlaps chunk k's
        device work."""
        curve = schemes.WCURVE[scheme_id]
        max_b = self.batch_sizes[-1]
        chunks, stage_s = [], 0.0
        for off in range(0, len(items), max_b):
            chunk = items[off : off + max_b]
            t0 = time.perf_counter()
            packed, valid = encodings.stage_ecdsa_packed(
                curve, chunk, self._pick_batch(len(chunk))
            )
            stage_s += time.perf_counter() - t0
            chunks.append(
                self._run_chunk(curve, packed, valid, idxs[off : off + len(chunk)], len(chunk))
            )
        return chunks, stage_s

    # -- SPI ---------------------------------------------------------------

    def verify_batch_async(
        self, requests: Sequence[VerificationRequest]
    ) -> "PendingVerification":
        """Stage + dispatch every request without waiting for results;
        collect with `.result()` or stream with `.chunks()`."""
        buckets: dict[int, tuple[list, list]] = {}
        for i, req in enumerate(requests):
            sid = req.key.scheme_id
            if sid not in SCHEME_KERNELS:
                name = schemes.CODE_NAMES.get(sid, str(sid))
                raise schemes.UnsupportedScheme(
                    f"{name} has no kernel in corda_tpu_torch yet"
                )
            items, idxs = buckets.setdefault(sid, ([], []))
            items.append((req.key.data, req.signature, req.message))
            idxs.append(i)
        pending, stage_s = [], 0.0
        for sid, (items, idxs) in buckets.items():
            chunks, s = self._dispatch(sid, items, idxs)
            pending.extend(chunks)
            stage_s += s
        return PendingVerification(
            [None] * len(requests), pending, streamed=True, stage_seconds=stage_s
        )

    def verify_batch(self, requests: Sequence[VerificationRequest]) -> list[bool]:
        return self.verify_batch_async(requests).result()


class PendingVerification:
    """Handle for an in-flight CudaBatchVerifier dispatch."""

    def __init__(self, out, chunks, streamed: bool = False, stage_seconds: float = 0.0):
        self._out = out
        self._chunks = chunks
        self._done = False
        # True when every chunk's device->host copy was queued at
        # dispatch: per-chunk consumption then waits for compute only
        self.streamed = streamed
        self.stage_seconds = stage_seconds

    def skeleton(self) -> list:
        """A copy of the result rows known without waiting on the device
        (none in this slice: every supported row is a device row)."""
        return list(self._out)

    def chunks(self):
        """Yield (request_indices, [bool]) per device chunk in dispatch
        order, as each chunk's compute completes."""
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

