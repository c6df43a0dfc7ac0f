"""Operator tooling. Port of corda_tpu/tools/: so far the ledger
explorer's web UI (web_explorer.py), mounted on every node gateway."""
