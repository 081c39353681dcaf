"""``tpurun-torch``, the elastic launcher: the port of
``dlrover_tpu/launcher/elastic_run.py``.

    python -m dlrover_tpu_torch.launcher.elastic_run --standalone --nnodes 1 \\
        --nproc_per_node 1 -m dlrover_tpu_torch.examples.gpt_elastic

The launcher finds the job master (``DLROVER_MASTER_ADDR``) or, with
``--standalone``, spawns one (``python -m dlrover_tpu_torch.master.main``)
and learns its port through a port file; waits for the master's pre-check
verdict; and hands off to :class:`..agent.training_agent.ElasticTrainingAgent`,
which supervises one worker process. The standalone master is stopped on
every way out: a normal return, an exception, and SIGTERM (turned into
``SystemExit`` so that every ``finally`` runs).

The launcher never creates a CUDA context: the local device count comes
from ``DLROVER_LOCAL_DEVICES``, ``CUDA_VISIBLE_DEVICES`` or ``nvidia-smi -L``,
never from ``torch.cuda``. The node check (``--network-check``), NUMA
pinning, native profiling, auto-tuning and the compile cache raise
``not_ported``.
"""

import argparse
import os
import shlex
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import List, Optional, Tuple

from ..agent.config import ElasticLaunchConfig
from ..agent.training_agent import ElasticTrainingAgent
from ..common.constants import Accelerators, DefaultValues, NodeEnv, PreCheckStatus
from ..common.log import logger
from ..common.platform import not_ported
from ..rpc.client import MasterClient

# seconds the standalone master gets to write its port file
MASTER_START_TIMEOUT_S = 60.0
# seconds the master gets to see the job's end by itself before SIGTERM
MASTER_EXIT_GRACE_S = 15.0


def parse_args(args: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="tpurun-torch",
        description="Launch an elastic, fault-tolerant PyTorch training job on GPUs.")
    parser.add_argument("--standalone", action="store_true",
                        help="run a local job master in a subprocess (single machine)")
    parser.add_argument("--nnodes", default="1",
                        help="number of hosts: N or MIN:MAX for an elastic range")
    parser.add_argument("--nproc_per_node", type=int, default=0,
                        help="local device count (0 = all local GPUs)")
    parser.add_argument("--node_unit", type=int, default=1,
                        help="valid world sizes are multiples of this")
    parser.add_argument("--node_rank", type=int, default=-1, help="this host's rank")
    parser.add_argument("--precheck", type=int, default=0, choices=[0, 1, 2],
                        help="0: skip the master pre-check wait; 1: wait; 2: wait and fail fast")
    parser.add_argument("--network-check", action="store_true", dest="network_check",
                        help="run the pairwise node health check before training (not ported)")
    parser.add_argument("--comm-perf-test", action="store_true", dest="comm_perf_test",
                        help="also benchmark collectives during the node check (not ported)")
    parser.add_argument("--exclude-straggler", action="store_true", dest="exclude_straggler",
                        help="exit (for relaunch) when flagged a straggler (not ported)")
    parser.add_argument("--auto_config", action="store_true",
                        help="fill node counts from the scheduler env contract")
    parser.add_argument("--auto_tunning", action="store_true",
                        help="poll the master for tuning configs (not ported)")
    parser.add_argument("--save_at_breakpoint", action=argparse.BooleanOptionalAction,
                        default=DefaultValues.SAVE_AT_BREAKPOINT,
                        help="persist the staged shm checkpoint when the worker fails")
    parser.add_argument("--accelerator", default=Accelerators.GPU,
                        choices=[Accelerators.GPU, Accelerators.CPU])
    parser.add_argument("--numa-affinity", action="store_true", dest="numa_affinity",
                        help="pin the worker to the GPU-local NUMA node (not ported)")
    parser.add_argument("--profile", default="auto", choices=["auto", "on", "off"],
                        help="native profiling of the worker (not ported: auto means off)")
    parser.add_argument("--max_restarts", type=int, default=DefaultValues.MAX_RELAUNCH_COUNT,
                        help="in-place worker restart budget before asking for a relaunch")
    parser.add_argument("--monitor_interval", type=float,
                        default=DefaultValues.MONITOR_INTERVAL_S,
                        help="agent supervision poll seconds (worker health, membership)")
    parser.add_argument("--training_port", type=int, default=0,
                        help="coordinator port of the process group (0 = a free port)")
    parser.add_argument("--compile-cache-dir", default="", dest="compile_cache_dir",
                        help="persistent compile cache directory (not ported)")
    parser.add_argument("--sync-input", action="store_true", dest="sync_input",
                        help="turn the train loop's input prefetch off "
                             "(exports DLROVER_INPUT_PREFETCH=0)")
    parser.add_argument("--log_dir", default=None, help="worker log directory")
    parser.add_argument("-m", "--module", action="store_true",
                        help="entrypoint is a python module (python -m style)")
    parser.add_argument("entrypoint", help="training script or module")
    parser.add_argument("entry_args", nargs=argparse.REMAINDER, help="args for the entrypoint")
    return parser.parse_args(args)


def parse_nnodes(spec: str) -> Tuple[int, int]:
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return int(lo), int(hi)
    n = int(spec)
    return n, n


def check_ported(ns: argparse.Namespace) -> None:
    """Raise ``not_ported`` for a flag whose feature the port lacks."""
    for asked, what in (
        (ns.network_check, "the node network check (--network-check)"),
        (ns.comm_perf_test, "the collective benchmark (--comm-perf-test)"),
        (ns.exclude_straggler, "straggler exclusion (--exclude-straggler)"),
        (ns.numa_affinity, "NUMA affinity (--numa-affinity)"),
        (ns.profile == "on", "native profiling (--profile on)"),
        (ns.auto_tunning, "auto-tuning (--auto_tunning)"),
        (bool(ns.compile_cache_dir), "the compile cache (--compile-cache-dir)"),
    ):
        if asked:
            raise not_ported(what)


def config_from_args(ns: argparse.Namespace) -> ElasticLaunchConfig:
    check_ported(ns)
    min_nodes, max_nodes = parse_nnodes(ns.nnodes)
    nproc = ns.nproc_per_node
    if nproc <= 0:
        nproc = _local_device_count()
    node_rank = ns.node_rank
    if node_rank < 0:
        node_rank = int(os.environ.get(NodeEnv.NODE_RANK, "0"))
    node_id = int(os.environ.get(NodeEnv.NODE_ID, str(node_rank)))
    config = ElasticLaunchConfig(
        min_nodes=min_nodes, max_nodes=max_nodes, node_unit=ns.node_unit, node_id=node_id,
        node_rank=node_rank, local_world_size=nproc, entrypoint=ns.entrypoint,
        entry_args=list(ns.entry_args), run_module=ns.module,
        master_addr=os.environ.get(NodeEnv.MASTER_ADDR, ""),
        master_service_type=os.environ.get(NodeEnv.MASTER_SERVICE_TYPE,
                                           DefaultValues.SERVICE_TYPE),
        job_name=os.environ.get(NodeEnv.JOB_NAME, "local_job"), accelerator=ns.accelerator,
        network_check=ns.network_check, comm_perf_test=ns.comm_perf_test,
        exclude_straggler=ns.exclude_straggler, auto_config=ns.auto_config,
        auto_tunning=ns.auto_tunning, max_restarts=ns.max_restarts,
        save_at_breakpoint=ns.save_at_breakpoint, training_port=ns.training_port,
        log_dir=ns.log_dir, numa_affinity=ns.numa_affinity, profile=ns.profile,
        monitor_interval=ns.monitor_interval,
        compile_cache_dir=ns.compile_cache_dir or os.environ.get("DLROVER_COMPILE_CACHE_DIR", ""),
        input_prefetch=not ns.sync_input)
    config.auto_configure_params()
    return config


def _local_device_count() -> int:
    """Local GPU count without a CUDA context in the launcher (the worker
    owns the GPU): ``DLROVER_LOCAL_DEVICES``, then ``CUDA_VISIBLE_DEVICES``,
    then the lines of ``nvidia-smi -L``; 1 when none of them tells."""
    env_count = os.environ.get("DLROVER_LOCAL_DEVICES")
    if env_count:
        return int(env_count)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return max(1, len([d for d in visible.split(",") if d.strip()]))
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return 1
    gpus = [ln for ln in out.stdout.splitlines() if ln.startswith("GPU ")]
    return len(gpus) if out.returncode == 0 and gpus else 1


class LocalMasterHandle:
    """A standalone master subprocess."""

    def __init__(self, proc: subprocess.Popen, addr: str):
        self.proc = proc
        self.addr = addr

    def stop(self, grace_s: float = MASTER_EXIT_GRACE_S) -> None:
        """Give the master ``grace_s`` to see the job's end and exit by
        itself, then SIGTERM it, then SIGKILL it."""
        try:
            self.proc.wait(grace_s)
        except subprocess.TimeoutExpired:
            self.proc.terminate()
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                try:
                    self.proc.wait(10)
                except subprocess.TimeoutExpired:
                    logger.error("standalone master pid=%s survived SIGKILL", self.proc.pid)
        logger.info("standalone master pid=%s exited rc=%s", self.proc.pid, self.proc.returncode)


def launch_local_master(num_workers: int, node_unit: int = 1,
                        job_name: str = "standalone") -> LocalMasterHandle:
    port_file = os.path.join(tempfile.gettempdir(),
                             f"dlrover_torch_master_{uuid.uuid4().hex[:8]}.port")
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.master.main", "--job_name", job_name,
           "--num_workers", str(num_workers), "--node_unit", str(node_unit),
           "--port_file", port_file]
    logger.info("starting standalone master: %s", shlex.join(cmd))
    t0 = time.time()
    proc = subprocess.Popen(cmd, start_new_session=True)
    deadline = t0 + MASTER_START_TIMEOUT_S
    try:
        while time.time() < deadline:
            if os.path.exists(port_file):
                with open(port_file) as f:
                    content = f.read().strip()
                if content:
                    os.unlink(port_file)
                    addr = f"127.0.0.1:{content}"
                    logger.info("standalone master at %s up in %.3f s", addr, time.time() - t0)
                    return LocalMasterHandle(proc, addr)
            if proc.poll() is not None:
                raise RuntimeError(f"standalone master exited rc={proc.returncode} "
                                   "before serving")
            time.sleep(0.1)
        raise RuntimeError(f"standalone master did not start within {MASTER_START_TIMEOUT_S}s")
    except BaseException:
        LocalMasterHandle(proc, "").stop(grace_s=0)
        raise


def wait_pre_check(client: MasterClient, level: int, timeout: float = 600.0) -> bool:
    """Block until the master's pre-check passes. Level 1 tolerates a
    failed pre-check; level 2 fails the launch on it."""
    if level <= 0:
        return True
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            resp = client.get_pre_check_result()
        except Exception as e:  # noqa: BLE001 — retried until the deadline
            logger.warning("pre-check query failed: %s", e)
            time.sleep(2)
            continue
        if resp.status == PreCheckStatus.PASSED:
            return True
        if resp.status == PreCheckStatus.FAILED:
            if level >= 2:
                logger.error("master pre-check failed: %s", resp.reason)
                return False
            logger.warning("master pre-check failed (%s); proceeding at level 1", resp.reason)
            return True
        time.sleep(2)
    logger.error("pre-check did not pass within %.0fs", timeout)
    return level < 2


def merge_elastic_config_from_master(client: MasterClient, config: ElasticLaunchConfig) -> None:
    """The master's overrides win over the CLI defaults."""
    try:
        run_config = client.get_elastic_run_config()
    except Exception as e:  # noqa: BLE001 — the overrides are optional
        logger.debug("no master run-config overrides: %r", e)
        return
    if "network_check" in run_config:
        config.network_check = run_config["network_check"] in ("1", "true", "True")
    if "node_unit" in run_config:
        config.node_unit = int(run_config["node_unit"])
    if "save_at_breakpoint" in run_config:
        config.save_at_breakpoint = run_config["save_at_breakpoint"] in ("1", "true", "True")


class ElasticLaunch:
    """Callable launch wrapper."""

    def __init__(self, config: ElasticLaunchConfig):
        self._config = config

    def __call__(self) -> int:
        client = MasterClient.singleton()
        merge_elastic_config_from_master(client, self._config)
        if self._config.network_check:
            raise not_ported("the node network check")
        return ElasticTrainingAgent(self._config).run()


def _terminate_on_sigterm():
    """SIGTERM raises SystemExit in the main thread, so that the agent
    stops its worker and the launcher its master on the way out. Returns
    the handler it replaced (None off the main thread)."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def on_term(signum, frame):
        raise SystemExit(128 + signum)

    return signal.signal(signal.SIGTERM, on_term)


def run(ns: argparse.Namespace, config: Optional[ElasticLaunchConfig] = None) -> int:
    """Launch what ``ns`` asks for. ``config``, when given, replaces the one
    made from ``ns``: a caller's way to set what has no flag, such as
    ``ElasticLaunchConfig(warm_spare=False)``."""
    if config is None:
        config = config_from_args(ns)
    previous_handler = _terminate_on_sigterm()
    # the agent's saver and the worker's engine share the job's namespace
    os.environ[NodeEnv.JOB_NAME] = config.job_name
    master_handle: Optional[LocalMasterHandle] = None
    agent_returned = False
    if ns.standalone and not config.master_addr:
        master_handle = launch_local_master(num_workers=config.max_nodes,
                                            node_unit=config.node_unit,
                                            job_name=config.job_name)
        config.master_addr = master_handle.addr
    try:
        if not config.master_addr:
            logger.error("no master: set %s or pass --standalone", NodeEnv.MASTER_ADDR)
            return 2
        os.environ[NodeEnv.MASTER_ADDR] = config.master_addr
        os.environ.setdefault(NodeEnv.NODE_ID, str(config.node_id))
        client = MasterClient.singleton()
        if not wait_pre_check(client, ns.precheck):
            return 1
        rc = ElasticLaunch(config)()
        agent_returned = True
        return rc
    finally:
        if master_handle is not None:
            # after the agent's report the master ends the job by itself;
            # on an exception or a signal it is stopped at once
            master_handle.stop(grace_s=MASTER_EXIT_GRACE_S if agent_returned else 0.0)
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)


def main(args: Optional[List[str]] = None) -> int:
    return run(parse_args(args))


if __name__ == "__main__":
    sys.exit(main())
