"""Client-side libraries (reference: client/ + webserver/ — SURVEY §2.9).

Port of corda_tpu/client: the shared plumbing (`common.py`), the JSON
mapping (`json_support.py`), the interactive and remote shell
(`shell.py`) and the REST gateway (`webserver.py`).
"""
