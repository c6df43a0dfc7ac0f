"""Signature-verification crypto of the port (torch field core, EC
point arithmetic, ECDSA, host staging and the batch-verifier SPI)."""
