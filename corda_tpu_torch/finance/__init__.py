"""Financial contracts of the port (port of corda_tpu/finance): the
OnLedgerAsset base, Cash, CommercialPaper and Obligation. The flows are
not ported yet."""
