"""corda_tpu_torch: the PyTorch + CUDA port of corda_tpu.

The signature-verification path behind the BatchSignatureVerifier SPI
(crypto/: ed25519, ECDSA secp256r1 and secp256k1, the four ladder
kernels hand-written in CUDA for Hopper in csrc/), and the batching
notary that drains it (node/notary.py) with the host layers it needs
(core/, finance/, utils/, flows/, node/services.py). The package
imports torch and numpy only — never jax and never corda_tpu. Importing
it has no side effects.
"""
