"""The system under test: corda_tpu_torch's BatchSignatureVerifier SPI.

The only module of the benchmark that imports the program. It builds
the verifier as the batching notary and the verifier pool build it, and
wraps the benchmark's rows into the SPI's requests; nothing else of the
program is used.
"""

from __future__ import annotations


def verifier(device: str, batch_sizes):
    """A CudaBatchVerifier on `device` ("cuda", or "cpu" for the plain
    torch versions) with the configuration's batch sizes."""
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier

    return CudaBatchVerifier(batch_sizes=tuple(batch_sizes), device=device)


def requests(rows) -> list:
    """One VerificationRequest per row, keys shared between rows of one
    signer as a node's key store shares them."""
    from corda_tpu_torch.crypto.batch_verifier import VerificationRequest
    from corda_tpu_torch.crypto.schemes import CODE_NAMES, PublicKey

    ids = {name: sid for sid, name in CODE_NAMES.items()}
    keys: dict = {}
    out = []
    for row in rows:
        key = keys.get((row.scheme, row.key))
        if key is None:
            key = keys[(row.scheme, row.key)] = PublicKey(ids[row.scheme], row.key)
        out.append(VerificationRequest(key, row.signature, row.message))
    return out
