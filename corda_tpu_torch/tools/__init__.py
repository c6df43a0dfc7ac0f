"""Operator tooling. Port of corda_tpu/tools/: the ledger explorer's web
UI (web_explorer.py, mounted on every node gateway), the client models
(models.py), the terminal explorer and its traffic simulation
(explorer.py), the transaction graph (graphs.py), DemoBench and its web
launcher (demobench.py, web_demobench.py), the zipapp builder
(package.py) and the API-surface scanner (api_scanner.py)."""
