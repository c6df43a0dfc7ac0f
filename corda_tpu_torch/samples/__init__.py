"""Demo CorDapps (reference: samples/ — SURVEY §2.10).

Port of corda_tpu/samples: the notary, trader, bank-of-corda,
attachment, IRS (with its rate oracle) and SIMM valuation demos, the
network simulation, the SIMM analytics (simm.py, pricing.py) and the
SIMM web API. Each demo module exposes `run(...)` executing its arc
over a MockNetwork (deterministic), on the card unless the caller
passes `batch_verifier=` (e.g. `CpuBatchVerifier()`).
"""
