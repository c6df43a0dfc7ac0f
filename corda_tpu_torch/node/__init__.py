"""Node services of the port (port of corda_tpu/node): the ServiceHub
and its in-memory services, and the notaries with the batching notary's
flush over the port's batch verifier."""
