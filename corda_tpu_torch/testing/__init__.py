"""Test kit of the port: MockNetwork and MockNode (Ring 3, in-memory
fabric), the ping/pong flows (flows.py), the notary fixture and the
on-card self-check."""

from .mock_network import MockNetwork, MockNode

__all__ = ["MockNetwork", "MockNode"]
