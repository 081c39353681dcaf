"""Node record and its status flow: the port of ``dlrover_tpu/common/node.py``.

A node is one host running one worker process; the job manager keeps one
``Node`` per worker and moves it through the allowed status transitions.
The fields the port reads are the JAX record's, with its names; resource
accounting (``NodeResource``), slice relaunches and platform events wait
for the slices that use them.
"""

import time
from dataclasses import dataclass
from typing import Optional

from .constants import DefaultValues, NodeExitReason, NodeStatus

# Allowed node status transitions; anything else is an out-of-order event
# and ignored.
_ALLOWED_TRANSITIONS = {
    NodeStatus.INITIAL: {NodeStatus.PENDING, NodeStatus.RUNNING, NodeStatus.FAILED,
                         NodeStatus.DELETED},
    NodeStatus.PENDING: {NodeStatus.RUNNING, NodeStatus.SUCCEEDED, NodeStatus.FAILED,
                         NodeStatus.DELETED},
    NodeStatus.RUNNING: {NodeStatus.SUCCEEDED, NodeStatus.FAILED, NodeStatus.DELETED,
                         NodeStatus.BREAKDOWN},
    NodeStatus.BREAKDOWN: {NodeStatus.RUNNING, NodeStatus.FAILED, NodeStatus.DELETED},
    NodeStatus.SUCCEEDED: {NodeStatus.DELETED},
    NodeStatus.FAILED: {NodeStatus.DELETED},
    NodeStatus.DELETED: set(),
}


def is_allowed_transition(from_status: str, to_status: str) -> bool:
    if from_status == to_status:
        return False
    return to_status in _ALLOWED_TRANSITIONS.get(from_status, set())


@dataclass
class Node:
    node_type: str = ""
    node_id: int = 0
    rank_index: int = -1
    status: str = NodeStatus.INITIAL
    relaunch_count: int = 0
    max_relaunch_count: int = DefaultValues.MAX_RELAUNCH_COUNT
    relaunchable: bool = True
    is_released: bool = False
    exit_reason: str = ""
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    heartbeat_time: float = 0.0

    def inc_relaunch_count(self) -> None:
        self.relaunch_count += 1

    def update_status(self, status: str) -> bool:
        """Apply a status transition; returns True if it was legal."""
        if not is_allowed_transition(self.status, status):
            return False
        self.status = status
        now = time.time()
        if status == NodeStatus.RUNNING and self.start_time is None:
            self.start_time = now
        if status in NodeStatus.terminal():
            self.finish_time = now
        return True

    def exited(self) -> bool:
        return self.status in NodeStatus.terminal()

    def should_relaunch(self) -> bool:
        if self.is_released or not self.relaunchable:
            return False
        if self.relaunch_count >= self.max_relaunch_count:
            return False
        if self.exit_reason == NodeExitReason.FATAL_ERROR:
            return False
        return True
