"""Agent-side failure diagnosis: the port of
``dlrover_tpu/agent/diagnosis_agent.py``.

Classifies a worker failure (restart on this host, or exit so the master
replaces the node), reports it to the master, and runs the heartbeat
thread that delivers master-issued actions to the agent. The heartbeat
thread is also the orphan guard: after the master has been unreachable
for ``master_lost_timeout_s`` it issues a job abortion to the agent
itself, so an agent never supervises a world nobody coordinates.
"""

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from ..common.config import get_context
from ..common.constants import DefaultValues
from ..common.log import logger
from ..diagnosis.diagnostician import FailureNodeDiagnostician
from ..master.diagnosis.action import DiagnosisActionType
from ..rpc.client import MasterClient


@dataclass
class WorkerFailure:
    node_rank: int
    restart_count: int
    returncode: Optional[int]
    signal: Optional[int]
    log_tail: str = ""


class DiagnosisAgent:
    """Classify failures and run the heartbeat and action channel."""

    def __init__(self, node_id: int, client: Optional[MasterClient] = None,
                 max_restarts: int = DefaultValues.MAX_RELAUNCH_COUNT,
                 heartbeat_interval: float = DefaultValues.HEARTBEAT_INTERVAL_S):
        self._node_id = node_id
        self._client = client or MasterClient.singleton()
        self._max_restarts = max_restarts
        self._heartbeat_interval = heartbeat_interval
        self._stopped = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._action_handlers: List[Callable[[str, dict], None]] = []
        self._diagnostician = FailureNodeDiagnostician(max_restarts=max_restarts)

    # -- failure classification ------------------------------------------

    def diagnose_training_failure(self, failure: WorkerFailure) -> str:
        """A DiagnosisActionType for the observed failure."""
        action = self._diagnostician.decide(log_tail=failure.log_tail,
                                            restart_count=failure.restart_count,
                                            returncode=failure.returncode, signal=failure.signal)
        if action == DiagnosisActionType.RELAUNCH_WORKER:
            logger.warning("failure diagnosis → relaunch node")
        return action

    def report_failure(self, failure: WorkerFailure, level: str = "error") -> None:
        try:
            self._client.report_failure(error_data=failure.log_tail[-4096:], level=level,
                                        restart_count=failure.restart_count)
        except Exception as e:  # noqa: BLE001 — the control plane must not kill supervision
            logger.warning("failed to report failure to master: %s", e)

    # -- heartbeat and master-action channel -----------------------------

    def register_action_handler(self, handler: Callable[[str, dict], None]) -> None:
        """``handler(action_type, config)`` runs for master-issued actions."""
        self._action_handlers.append(handler)

    def start_heartbeat(self) -> None:
        if self._hb_thread is not None:
            return
        self._hb_thread = threading.Thread(target=self._heartbeat_loop, name="agent-heartbeat",
                                           daemon=True)
        self._hb_thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stopped.set()
        thread = self._hb_thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout)

    def _heartbeat_loop(self) -> None:
        lost_timeout = get_context().master_lost_timeout_s
        down_since: Optional[float] = None
        while not self._stopped.is_set():
            try:
                actions = self._client.report_heartbeat()
                down_since = None
                for msg in actions:
                    self._dispatch(msg)
            except Exception as e:  # noqa: BLE001 — a dark master is handled below
                # monotonic: a wall-clock step must not fake an outage
                now = time.monotonic()
                down_since = down_since or now
                logger.warning("heartbeat failed: %s", e)
                if lost_timeout > 0 and now - down_since >= lost_timeout:
                    logger.error("master unreachable for %.0fs; aborting agent (orphan guard)",
                                 now - down_since)
                    for handler in self._action_handlers:
                        try:
                            handler(DiagnosisActionType.JOB_ABORTION,
                                    {"reason": "master_unreachable"})
                        except Exception as he:  # noqa: BLE001
                            logger.error("abort handler failed: %s", he)
                    return
            self._stopped.wait(self._heartbeat_interval)

    def _dispatch(self, msg) -> None:
        action_type = {"NoAction": DiagnosisActionType.NONE,
                       "EventAction": DiagnosisActionType.EVENT,
                       "JobAbortionAction": DiagnosisActionType.JOB_ABORTION}.get(msg.action_cls)
        if action_type is None:
            # a NodeAction carries its concrete type in its config
            action_type = msg.config.get("action_type", DiagnosisActionType.RESTART_WORKER)
        if action_type == DiagnosisActionType.NONE:
            return
        logger.info("master-issued diagnosis action: %s", action_type)
        for handler in self._action_handlers:
            try:
                handler(action_type, dict(msg.config))
            except Exception as e:  # noqa: BLE001
                logger.error("action handler failed: %s", e)
