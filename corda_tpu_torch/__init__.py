"""corda_tpu_torch: the PyTorch + CUDA port of corda_tpu.

The signature-verification path behind the BatchSignatureVerifier SPI
(crypto/: ed25519, ECDSA secp256r1 and secp256k1, the four ladder
kernels hand-written in CUDA for Hopper in csrc/; RSA and SPHINCS rows
on the host, as in the reference), the batching notary that drains
it (node/notary.py) with the host layers it needs (core/, including the
attachment-contract sandbox, finance/, utils/, node/services.py,
experimental/determinism.py), and the flows that drive them (flows/,
the in-memory fabric node/messaging.py, node/scheduler.py,
node/cordapp.py, testing/mock_network.py). The codec, Merkle
trees, signature staging and asset sweep run in the native host library
(native/, C++ built with g++ at first use). The package imports torch
and numpy only — never jax and never corda_tpu. Importing it has no
side effects.
"""
