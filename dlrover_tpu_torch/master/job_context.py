"""Job state shared by the master's components: the port of
``dlrover_tpu/master/job_context.py``.

The node table, the job stage and exit reason, the pre-check verdict and
the two diagnosis action queues (the master's own, and the one delivered
to agents on heartbeats). Snapshot export and replay wait for the slice
that ports master persistence.
"""

import threading
from typing import Dict, Optional

from ..common.constants import JobStage, NodeType, PreCheckStatus
from ..common.node import Node
from .diagnosis.action import DiagnosisActionQueue


class JobContext:
    _instance: Optional["JobContext"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._mu = threading.RLock()
        self._nodes: Dict[str, Dict[int, Node]] = {}
        self.job_stage = JobStage.INIT
        self.job_exit_reason = ""
        self.pre_check_status = PreCheckStatus.CHECKING
        self.pre_check_reason = ""
        self.master_actions = DiagnosisActionQueue()  # consumed by the master loop
        self.node_actions = DiagnosisActionQueue()  # delivered on heartbeats
        self.elastic_run_config: Dict[str, str] = {}

    # -- nodes -------------------------------------------------------------

    def update_node(self, node: Node) -> None:
        with self._mu:
            self._nodes.setdefault(node.node_type, {})[node.node_id] = node

    def get_node(self, node_type: str, node_id: int) -> Optional[Node]:
        with self._mu:
            return self._nodes.get(node_type, {}).get(node_id)

    def get_nodes(self, node_type: str = NodeType.WORKER) -> Dict[int, Node]:
        with self._mu:
            return dict(self._nodes.get(node_type, {}))

    # -- job stage ---------------------------------------------------------

    def set_stage(self, stage: str, reason: str = "") -> None:
        with self._mu:
            self.job_stage = stage
            if reason:
                self.job_exit_reason = reason

    def is_stopped(self) -> bool:
        return self.job_stage in (JobStage.STOPPING, JobStage.STOPPED)

    # -- singleton ---------------------------------------------------------

    @classmethod
    def singleton(cls) -> "JobContext":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> "JobContext":
        with cls._lock:
            cls._instance = cls()
        return cls._instance


def get_job_context() -> JobContext:
    return JobContext.singleton()
