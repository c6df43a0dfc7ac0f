"""Financial contracts of the port (port of corda_tpu/finance): the
OnLedgerAsset base and Cash. The flows are not ported yet."""
