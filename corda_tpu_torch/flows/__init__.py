"""Flow framework of the port (port of corda_tpu/flows): durable,
resumable multi-party protocols as generators driven by a
StateMachineManager, with event-sourced checkpoints. The reference's
notary-change and upgrade flows (flows/replacement.py) are not ported.
"""

from .api import (
    FlowException,
    FlowLogic,
    FlowSessionException,
    ProgressTracker,
    initiated_by,
    initiating_flow,
)
from .statemachine import StateMachineManager

__all__ = [
    "FlowException",
    "FlowLogic",
    "FlowSessionException",
    "ProgressTracker",
    "initiated_by",
    "initiating_flow",
    "StateMachineManager",
]
