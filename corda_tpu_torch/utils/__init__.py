"""Host utilities of the port (port of corda_tpu/utils): the lock
factory, the metrics registry and the tracer the notary calls."""
