"""Elastic bootstrap of the training process: the port of
``dlrover_tpu/trainer/elastic.py``.

The agent hands the process its place in the world through the
``NodeEnv`` variables. The port runs one process on one GPU: a world of
several processes (``torch.distributed``) comes with a later slice and
raises "not ported" when configured. With a master
(``DLROVER_MASTER_ADDR``), step reports feed its step monitor through the
port's ``MasterClient``; without one they are no-ops.
"""

import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..common.constants import NodeEnv
from ..common.log import logger
from ..common.platform import not_ported
from ..rpc.client import MasterClient


@dataclass
class ElasticContext:
    """This process's coordinates in the elastic world."""

    node_id: int = 0
    node_rank: int = 0
    num_processes: int = 1
    process_id: int = 0
    coordinator: str = ""
    restart_count: int = 0
    master_addr: str = ""
    job_name: str = "local_job"
    auto_tunning: bool = False

    _client: Optional[MasterClient] = None
    _step_t0: float = 0.0

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @classmethod
    def from_env(cls) -> "ElasticContext":
        env = os.environ
        return cls(
            node_id=int(env.get(NodeEnv.NODE_ID, "0")),
            node_rank=int(env.get(NodeEnv.NODE_RANK, "0")),
            num_processes=int(env.get(NodeEnv.NUM_PROCESSES, "1")),
            process_id=int(env.get(NodeEnv.PROCESS_ID, "0")),
            coordinator=env.get(NodeEnv.COORDINATOR_ADDRESS, ""),
            restart_count=int(env.get(NodeEnv.RESTART_COUNT, "0")),
            master_addr=env.get(NodeEnv.MASTER_ADDR, ""),
            job_name=env.get(NodeEnv.JOB_NAME, "local_job"),
            auto_tunning=env.get(NodeEnv.AUTO_TUNNING, "") == "1",
        )

    def world_device_count(self) -> int:
        """Global device count of the current world: this process's GPUs
        (1 for a CPU process) times the number of processes."""
        local = torch.cuda.device_count() if torch.cuda.is_available() else 1
        return max(1, self.num_processes * max(1, local))

    def initialize(self) -> None:
        """Bring up the process world. A single-process world has nothing to
        start; several processes need ``torch.distributed``, which comes
        with the multi-GPU slice."""
        if self.num_processes > 1:
            raise not_ported(f"a world of {self.num_processes} processes")
        logger.info("single-process world")

    @property
    def client(self) -> Optional[MasterClient]:
        """The master's RPC client: None without a master; the process
        singleton when the master is the environment's."""
        if self._client is None and self.master_addr:
            if os.environ.get(NodeEnv.MASTER_ADDR) == self.master_addr:
                self._client = MasterClient.singleton()
            else:
                self._client = MasterClient(self.master_addr, node_id=self.node_id)
        return self._client

    def report_step(self, step: int, elapsed_s: float = 0.0, tokens_per_s: float = 0.0) -> None:
        """Feed the master's step monitor; a no-op without a master. When
        :meth:`start_step_timer` ran for this step, the elapsed time is
        filled in. A failed report is logged, never raised: the control
        plane must not stop training."""
        if elapsed_s == 0.0 and self._step_t0 > 0.0:
            elapsed_s = time.monotonic() - self._step_t0
        self._step_t0 = 0.0
        if self.client is None:
            return
        try:
            self.client.report_training_step(step=step, elapsed_s=elapsed_s,
                                             tokens_per_s=tokens_per_s)
        except Exception as e:  # noqa: BLE001
            logger.debug("step report failed: %s", e)

    def start_step_timer(self) -> None:
        self._step_t0 = time.monotonic()
