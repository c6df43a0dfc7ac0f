"""corda_tpu_torch: the PyTorch + CUDA port of corda_tpu's device paths.

Slice 1 holds the ECDSA (secp256r1 / secp256k1) verification path
behind the BatchSignatureVerifier SPI, with both Weierstrass ladder
kernels hand-written in CUDA for Hopper (crypto/cuda_ec.py,
csrc/wei_ladder.cu). The package imports torch and numpy only —
never jax and never corda_tpu. Importing it has no side effects.
"""
