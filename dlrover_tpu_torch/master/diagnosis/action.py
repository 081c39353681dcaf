"""Diagnosis actions, what the master tells the agents (and itself) to do:
the port of ``dlrover_tpu/master/diagnosis/action.py``.

Actions ride back to the agents on heartbeat responses.
"""

import threading
import time
from typing import Dict, List

from ...common import comm
from ...common.constants import DiagnosisConstants
from ...common.log import logger


class DiagnosisActionType:
    NONE = "no_action"
    EVENT = "event"
    RESTART_WORKER = "restart_worker"  # soft: restart the worker process
    RELAUNCH_WORKER = "relaunch_worker"  # hard: replace the node
    STACK_DUMP = "stack_dump"
    JOB_ABORTION = "job_abortion"


class DiagnosisAction:
    action_type = DiagnosisActionType.NONE

    def __init__(self, instance: int = DiagnosisConstants.ANY_INSTANCE,
                 expired_s: float = DiagnosisConstants.ACTION_EXPIRY_S,
                 config: Dict[str, str] = None):
        self.instance = instance
        self.timestamp = time.time()
        self.expired_s = expired_s
        self.config = config or {}

    def is_expired(self) -> bool:
        return time.time() > self.timestamp + self.expired_s

    def is_needed(self) -> bool:
        return not self.is_expired() and self.action_type != DiagnosisActionType.NONE

    def to_msg(self) -> comm.DiagnosisActionMsg:
        return comm.DiagnosisActionMsg(
            action_cls=type(self).__name__, instance=self.instance, timestamp=self.timestamp,
            expired_s=self.expired_s, config={k: str(v) for k, v in self.config.items()})


class NoAction(DiagnosisAction):
    action_type = DiagnosisActionType.NONE


class NodeAction(DiagnosisAction):
    """Restart or relaunch one node's worker process."""

    def __init__(self, node_id: int, action_type: str, reason: str = "", **kw):
        super().__init__(instance=node_id, **kw)
        self.action_type = action_type
        self.config.setdefault("reason", reason)

    @property
    def node_id(self) -> int:
        return self.instance


class JobAbortionAction(DiagnosisAction):
    action_type = DiagnosisActionType.JOB_ABORTION

    def __init__(self, reason: str = "", **kw):
        super().__init__(instance=DiagnosisConstants.MASTER_INSTANCE, **kw)
        self.config.setdefault("reason", reason)


def action_to_msg(action: DiagnosisAction) -> comm.DiagnosisActionMsg:
    msg = action.to_msg()
    msg.config["action_type"] = action.action_type
    return msg


class DiagnosisActionQueue:
    """Per-instance queues of pending actions."""

    def __init__(self):
        self._actions: Dict[int, List[DiagnosisAction]] = {}
        self._lock = threading.Lock()

    def add_action(self, action: DiagnosisAction) -> None:
        if not action.is_needed():
            return
        with self._lock:
            self._actions.setdefault(action.instance, []).append(action)
            logger.info("queued diagnosis action %s for instance %s", action.action_type,
                        action.instance)

    def next_action(self, instance: int) -> DiagnosisAction:
        with self._lock:
            for key in (instance, DiagnosisConstants.ANY_INSTANCE):
                queue = self._actions.get(key, [])
                while queue:
                    action = queue.pop(0)
                    if not action.is_expired():
                        return action
            return NoAction()

    def drain_actions(self, instance: int) -> List[DiagnosisAction]:
        actions = []
        while True:
            action = self.next_action(instance)
            if isinstance(action, NoAction):
                return actions
            actions.append(action)
