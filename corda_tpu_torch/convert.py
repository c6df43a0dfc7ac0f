"""State carried across from the JAX package.

The verification path has no weights; what crosses between corda_tpu
and the port is data: [22, B] int32 limb arrays, verification requests,
and ledger objects as their canonical (CTS) bytes. Requests convert by
duck typing (`.key.scheme_id`, `.key.data`, `.signature`, `.message`);
ledger objects cross as the reference's serialized bytes, which the
port's codec decodes into its own classes (equal class names give equal
wire tags). This module imports nothing of corda_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import serialization as ser
from .core.transactions import SignedTransaction
from .crypto.batch_verifier import VerificationRequest
from .crypto.limbs import NLIMB
from .finance import cash as _cash  # noqa: F401  (registers the Cash wire classes)
from .crypto.schemes import PublicKey


def limbs_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """[22, B] int32 numpy (or jax, via np.asarray) limbs -> torch tensor."""
    arr = np.ascontiguousarray(np.asarray(a), dtype=np.int32)
    if arr.ndim != 2 or arr.shape[0] != NLIMB:
        raise ValueError(f"limb array has shape {arr.shape}, need ({NLIMB}, B)")
    return torch.from_numpy(arr.copy()).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """[22, B] torch limbs -> int32 numpy array on the host."""
    return t.detach().to("cpu", torch.int32).numpy()


def requests_from_reference(reqs) -> list[VerificationRequest]:
    """The port's VerificationRequests from any objects shaped like the
    reference's (key.scheme_id, key.data, signature, message)."""
    return [
        VerificationRequest(
            PublicKey(int(r.key.scheme_id), bytes(r.key.data)),
            bytes(r.signature),
            bytes(r.message),
        )
        for r in reqs
    ]


def signed_transaction_from_reference(data: bytes) -> SignedTransaction:
    """The reference's serialized SignedTransaction bytes (its
    `corda_tpu.core.serialization.encode`) -> the port's
    SignedTransaction (same id, same signatures)."""
    stx = ser.decode(bytes(data))
    if not isinstance(stx, SignedTransaction):
        raise ser.SerializationError(
            f"expected a SignedTransaction, got {type(stx).__name__}"
        )
    return stx
