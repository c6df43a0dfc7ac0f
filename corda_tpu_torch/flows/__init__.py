"""The flow seam of the port (port of part of corda_tpu/flows)."""
