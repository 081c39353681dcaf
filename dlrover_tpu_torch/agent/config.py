"""Launch configuration of the elastic agent: the port of
``dlrover_tpu/agent/config.py``.

The same fields and defaults, with these differences: the accelerator is a
GPU (or the CPU, for tests), the transport defaults to HTTP, and soft
re-mesh defaults to off. Warm spares are on by default, as in the JAX
package; ``ElasticLaunchConfig(warm_spare=False)`` turns them off (the
JAX launcher has no flag for it, and neither has this one). Fields of
features the port does not have yet (soft re-mesh, profiling, NUMA
pinning, the compile cache, the network check, tuning) keep their JAX
defaults so a config reads the same; the agent and the launcher raise
``not_ported`` when one of them is switched on.
"""

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..common.constants import Accelerators, DefaultValues, NodeEnv


@dataclass
class ElasticLaunchConfig:
    """Everything the agent needs to launch and supervise one host."""

    min_nodes: int = 1
    max_nodes: int = 1
    # valid world sizes are multiples of node_unit; the rendezvous
    # truncates to a multiple of it
    node_unit: int = 1
    node_id: int = 0
    node_rank: int = 0
    # devices supervised by this host's worker process
    local_world_size: int = 1

    entrypoint: str = ""  # python script or module to run
    entry_args: List[str] = field(default_factory=list)
    run_module: bool = False  # entrypoint is a module (python -m style)

    master_addr: str = ""
    master_service_type: str = DefaultValues.SERVICE_TYPE
    job_name: str = "local_job"

    accelerator: str = Accelerators.GPU
    network_check: bool = False
    comm_perf_test: bool = False
    exclude_straggler: bool = False
    auto_config: bool = False
    auto_tunning: bool = False
    max_restarts: int = DefaultValues.MAX_RELAUNCH_COUNT
    monitor_interval: float = DefaultValues.MONITOR_INTERVAL_S
    rdzv_timeout: float = DefaultValues.RDZV_TIMEOUT_S
    save_at_breakpoint: bool = DefaultValues.SAVE_AT_BREAKPOINT
    training_port: int = 0  # 0 → pick a free port for the coordinator
    log_dir: Optional[str] = None
    numa_affinity: bool = False
    profile: str = "auto"
    profiler_port: int = 0
    profiler_daemon_port: int = 0
    profiler_scrape_interval_s: float = 30.0
    # a pre-imported interpreter on deck for the next worker start
    warm_spare: bool = True
    # not ported: off here (on in the JAX package), raising when switched on
    soft_remesh: bool = False
    soft_remesh_timeout_s: float = 15.0
    compile_cache_dir: str = ""
    input_prefetch: bool = True
    extra_env: Dict[str, str] = field(default_factory=dict)

    def slice_id(self) -> int:
        """The slice of this host: ranks are slice-contiguous, node_unit
        hosts per slice."""
        return self.node_rank // self.node_unit if self.node_unit > 1 else 0

    def profile_enabled(self) -> bool:
        """Native profiling is not ported: "auto" means off, "on" raises
        in the agent."""
        return self.profile == "on"

    def auto_configure_params(self) -> None:
        """Fill node counts from the scheduler's env contract (NODE_NUM,
        NODE_UNIT); ``--auto_config`` on four or more nodes turns the
        network check on, as in the JAX package."""
        node_num = int(os.environ.get(NodeEnv.NODE_NUM, "0"))
        if node_num > 0:
            self.min_nodes = node_num
            self.max_nodes = node_num
        unit = int(os.environ.get(NodeEnv.NODE_UNIT, "0"))
        if unit > 0:
            self.node_unit = unit
        if self.auto_config and self.max_nodes >= 4:
            self.network_check = True

    def worker_env(self) -> Dict[str, str]:
        """The static part of the env contract handed to the worker, equal
        to the JAX package's. The agent adds its IPC directory and
        namespace (``ElasticTrainingAgent``), so that the saver in the
        agent and the engine in the worker meet under one job name."""
        env = dict(self.extra_env)
        env[NodeEnv.MASTER_ADDR] = self.master_addr
        env[NodeEnv.MASTER_SERVICE_TYPE] = self.master_service_type
        env[NodeEnv.JOB_NAME] = self.job_name
        env[NodeEnv.NODE_ID] = str(self.node_id)
        env[NodeEnv.NODE_RANK] = str(self.node_rank)
        env[NodeEnv.NODE_NUM] = str(self.max_nodes)
        env[NodeEnv.MAX_NODES] = str(self.max_nodes)
        env[NodeEnv.NODE_UNIT] = str(self.node_unit)
        if self.auto_tunning:
            env[NodeEnv.AUTO_TUNNING] = "1"
        if self.compile_cache_dir:
            env["DLROVER_COMPILE_CACHE_DIR"] = self.compile_cache_dir
        if not self.input_prefetch:
            env["DLROVER_INPUT_PREFETCH"] = "0"
        return env
