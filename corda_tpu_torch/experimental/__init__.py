"""Experimental subsystems of the port (port of corda_tpu/experimental):
the static determinism audit the attachment sandbox runs."""
