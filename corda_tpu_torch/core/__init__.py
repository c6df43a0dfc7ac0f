"""Core data model of the port: states, transactions, identities and the
canonical encoding (port of corda_tpu/core). Every class keeps the
reference's name and field order: the wire tag is the class name, so
transaction ids and signed payloads are equal across the two packages."""
