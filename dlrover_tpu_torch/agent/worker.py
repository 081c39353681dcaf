"""Supervision of the worker (training) process: the port of
``dlrover_tpu/agent/worker.py``.

One host runs one worker process. Kept from the JAX module:

- the worker runs in its own session, so a stop kills the whole process
  group (dataloader children included): SIGTERM, SIGKILL after a grace,
  and a final SIGKILL of the group;
- the worker is started with ``subprocess`` (fork and exec), never a bare
  fork: an agent must not hand a CUDA state to its child;
- ``DLROVER_RESTART_COUNT`` in the worker's environment;
- a pidfile of (pid, kernel start time) per IPC namespace, and
  ``reap_stale_workers``, which kills a dead agent's orphaned worker
  before a new one is started (a leaked worker holds the GPU);
- the tail of the worker's log for the failure diagnosis.

Warm spares (pre-imported interpreters) and NUMA pinning wait for later
slices; :class:`..training_agent.ElasticTrainingAgent` raises when they are
asked for.
"""

import os
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..common.constants import NodeEnv
from ..common.log import logger
from ..common.multi_process import _ipc_namespace


class WorkerState:
    INIT = "init"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"


def pidfile_dir() -> str:
    """``DLROVER_PIDFILE_DIR``, else ``dlrover_tpu_torch/workers`` under the
    temporary directory."""
    return os.getenv("DLROVER_PIDFILE_DIR") or os.path.join(
        tempfile.gettempdir(), "dlrover_tpu_torch", "workers")


def worker_pidfile(namespace: Optional[str] = None) -> str:
    """The pidfile of this IPC namespace's worker: ``<pid> <start ticks>``."""
    os.makedirs(pidfile_dir(), exist_ok=True)
    return os.path.join(pidfile_dir(), f"{namespace or _ipc_namespace()}.pid")


def _proc_stat(pid: int):
    """(state, start ticks) of ``pid`` from /proc, or None when it is gone.
    (pid, start time) identifies one incarnation: the guard against pid
    reuse."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
    except OSError:
        return None
    try:
        # fields after the parenthesised command name: state is field 3,
        # the start time field 22
        rest = stat[stat.rindex(b")") + 2:].split()
        return rest[0].decode(), int(rest[19])
    except (ValueError, IndexError):
        return None


def _proc_starttime(pid: int) -> Optional[int]:
    info = _proc_stat(pid)
    return info[1] if info else None


def read_pidfile(namespace: Optional[str] = None):
    """(pid, start ticks) recorded for the namespace's worker, or None."""
    try:
        parts = open(worker_pidfile(namespace)).read().split()
        return int(parts[0]), int(parts[1]) if len(parts) > 1 else 0
    except (OSError, ValueError, IndexError):
        return None


def _kill_group(pid: int, sig: int) -> None:
    try:
        os.killpg(os.getpgid(pid), sig)
    except (ProcessLookupError, PermissionError):
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass


def kill_process_group(proc: subprocess.Popen, grace_s: float = 5.0) -> None:
    """SIGTERM the process group, SIGKILL it after ``grace_s``, and reap.
    Safe on processes that are already dead; bounded."""
    if proc.poll() is not None:
        return
    _kill_group(proc.pid, signal.SIGTERM)
    try:
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        logger.warning("pid=%s ignored SIGTERM; killing its group", proc.pid)
        _kill_group(proc.pid, signal.SIGKILL)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            logger.error("pid=%s survived SIGKILL for 30 s", proc.pid)


class OrphanWorkerError(RuntimeError):
    """A previous incarnation's worker could not be killed; a second
    worker would race it on the GPU and on the checkpoint shard."""


def reap_stale_workers() -> None:
    """Kill a previous agent incarnation's worker before starting ours.

    An agent that died hard (SIGKILL, OOM) leaves its worker running in
    its own session, holding the GPU and the staged shm. Its identity is
    (pid, start time) from the pidfile, so a reused pid is never killed.
    Raises :class:`OrphanWorkerError`, keeping the pidfile, if the orphan
    survives SIGKILL."""
    recorded = read_pidfile()
    if recorded is None:
        return
    pid, recorded_start = recorded

    def alive() -> bool:
        info = _proc_stat(pid)
        if info is None or info[0] == "Z":
            return False
        return not recorded_start or info[1] == recorded_start

    if alive():
        logger.warning("reaping orphan worker pid=%s of a dead agent", pid)
        _kill_group(pid, signal.SIGKILL)
        deadline = time.time() + 30
        while time.time() < deadline and alive():
            time.sleep(0.2)
        if alive():
            raise OrphanWorkerError(f"orphan worker pid={pid} survived SIGKILL; refusing to "
                                    "start a second worker on the same GPU and shm")
    try:
        os.unlink(worker_pidfile())
    except OSError:
        pass


@dataclass
class WorkerSpec:
    """What to run and how to stop it."""

    entrypoint: str
    args: List[str] = field(default_factory=list)
    run_module: bool = False
    env: Dict[str, str] = field(default_factory=dict)
    log_dir: Optional[str] = None
    kill_grace_s: float = 15.0


@dataclass
class RunResult:
    state: str = WorkerState.INIT
    returncode: Optional[int] = None
    signal: Optional[int] = None


class WorkerProcess:
    """One supervised training process."""

    def __init__(self, spec: WorkerSpec, restart_count: int = 0):
        self.spec = spec
        self.restart_count = restart_count
        self._proc: Optional[subprocess.Popen] = None
        self._log_path: Optional[str] = None
        self._log_file = None
        self.start_time: float = 0.0

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc else None

    def start(self, dynamic_env: Optional[Dict[str, str]] = None) -> str:
        """Start the worker (always a cold start: warm spares are not
        ported); returns "cold"."""
        env = dict(os.environ)
        env.update(self.spec.env)
        env.update(dynamic_env or {})
        env[NodeEnv.RESTART_COUNT] = str(self.restart_count)
        if self.spec.run_module:
            cmd = [sys.executable, "-m", self.spec.entrypoint]
        else:
            cmd = [sys.executable, self.spec.entrypoint]
        cmd += list(self.spec.args)
        stdout = None
        if self.spec.log_dir:
            os.makedirs(self.spec.log_dir, exist_ok=True)
            self._log_path = os.path.join(self.spec.log_dir, f"worker_{self.restart_count}.log")
            self._log_file = open(self._log_path, "wb")
            stdout = self._log_file
        # a new session: teardown kills the whole tree
        self._proc = subprocess.Popen(cmd, env=env, stdout=stdout,
                                      stderr=subprocess.STDOUT if stdout else None,
                                      start_new_session=True)
        self.start_time = time.time()
        try:
            start_ticks = _proc_starttime(self._proc.pid)
            with open(worker_pidfile(), "w") as f:
                f.write(f"{self._proc.pid} {start_ticks or 0}")
        except OSError:
            logger.warning("could not write the worker pidfile")
        logger.info("started worker pid=%s restart=%s (cold) entry=%s at %.6f", self._proc.pid,
                    self.restart_count, self.spec.entrypoint, self.start_time)
        return "cold"

    def poll(self) -> RunResult:
        if self._proc is None:
            return RunResult(WorkerState.INIT)
        rc = self._proc.poll()
        if rc is None:
            return RunResult(WorkerState.RUNNING)
        self._close_log()
        if rc == 0:
            return RunResult(WorkerState.SUCCEEDED, returncode=0)
        sig = -rc if rc < 0 else None
        return RunResult(WorkerState.FAILED, returncode=rc, signal=sig)

    def stop(self) -> None:
        """SIGTERM the process group, SIGKILL after the grace, then SIGKILL
        whatever is left of the group (children that outlived the
        leader)."""
        if self._proc is None:
            return
        try:
            pgid = os.getpgid(self._proc.pid)
        except (ProcessLookupError, PermissionError):
            pgid = None
        kill_process_group(self._proc, self.spec.kill_grace_s)
        if pgid is not None:
            try:
                os.killpg(pgid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        self._close_log()
        recorded = read_pidfile()
        if recorded is not None and recorded[0] == self._proc.pid:
            try:
                os.unlink(worker_pidfile())
            except OSError:
                pass

    def wait(self, timeout: Optional[float] = None) -> RunResult:
        if self._proc is not None:
            try:
                self._proc.wait(timeout)
            except subprocess.TimeoutExpired:
                pass
        return self.poll()

    def tail_log(self, max_bytes: int = 64 * 1024) -> str:
        if not self._log_path or not os.path.exists(self._log_path):
            return ""
        with open(self._log_path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            return f.read().decode(errors="replace")

    def _close_log(self) -> None:
        if self._log_file is not None:
            try:
                self._log_file.close()
            finally:
                self._log_file = None
