"""The worker-failure diagnostician: the failure half of
``dlrover_tpu/diagnosis/diagnostician.py``.

``FailureNodeDiagnostician.decide`` is the agent's restart-or-relaunch
decision for a failed worker. The hang diagnostician and the log and
resource collectors wait for the slices that port them; a log is read
here directly from its path.
"""

import os
from typing import List, Optional

from ..common.log import logger
from ..master.diagnosis.action import DiagnosisActionType
from .inference_chain import Inference, InferenceChain, InferenceName
from .operators import CheckFailureNodeOperator, ResolveFailureNodeOperator

_LOG_TAIL_BYTES = 64 * 1024


def _read_tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - _LOG_TAIL_BYTES))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class FailureNodeDiagnostician:
    """Worker-failure classification: attribute the failure from the
    worker's log, decide restart or relaunch."""

    def __init__(self, max_restarts: int = 3):
        self._max_restarts = max_restarts
        self._chain = InferenceChain([CheckFailureNodeOperator(), ResolveFailureNodeOperator()])

    def observe(self, log_path: str = "", log_tail: str = "", restart_count: int = 0,
                returncode: Optional[int] = None, signal: Optional[int] = None,
                **_) -> List[Inference]:
        if not log_tail and log_path:
            log_tail = _read_tail(log_path)
        return [Inference(name=InferenceName.WORKER_FAILURE, data={
            "log_tail": log_tail, "restart_count": restart_count,
            "max_restarts": self._max_restarts, "returncode": returncode, "signal": signal})]

    def decide(self, **kwargs) -> str:
        """One restart-or-relaunch decision; a relaunch verdict wins.
        Logs the attribution and the pattern behind it."""
        facts = self._chain.infer(self.observe(**kwargs))
        actions = [f for f in facts if f.name == InferenceName.RESOLVED_ACTION]
        chosen = next((f for f in actions
                       if f.data.get("action_type") == DiagnosisActionType.RELAUNCH_WORKER), None)
        if chosen is None and actions:
            chosen = actions[0]
        if chosen is None:
            return DiagnosisActionType.RESTART_WORKER
        logger.info("failure diagnosis: %s (%s) → %s", chosen.attribution, chosen.description,
                    chosen.data.get("action_type"))
        return chosen.data.get("action_type", DiagnosisActionType.RESTART_WORKER)
