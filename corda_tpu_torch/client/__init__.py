"""Client-side libraries (reference: client/ + webserver/ — SURVEY §2.9).

Port of corda_tpu/client: the shared plumbing (`common.py`) so far.
"""
