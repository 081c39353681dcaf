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
- the tail of the worker's log for the failure diagnosis;
- :class:`WarmSpare`, a pre-imported interpreter (``warm_worker``) that
  :meth:`WorkerProcess.start` adopts as the worker when it is ready, with a
  cold start when it is not or when it dies during the hand-off.

Three things differ from the JAX module. The spare has a pidfile of its
own beside the worker's, so that ``reap_stale_workers`` also kills a dead
agent's spare; an adopted spare's log takes the name a cold worker's log
would have (``worker_<restart>.log``); and without a log directory the
spare writes to the agent's stdout and stderr, as a cold worker does.

NUMA pinning waits for a later slice; :class:`..training_agent.
ElasticTrainingAgent` raises when it is asked for.
"""

import json
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


def spare_pidfile(namespace: Optional[str] = None) -> str:
    """The pidfile of this IPC namespace's warm spare."""
    os.makedirs(pidfile_dir(), exist_ok=True)
    return os.path.join(pidfile_dir(), f"{namespace or _ipc_namespace()}.spare.pid")


def _read_pid(path: str):
    try:
        parts = open(path).read().split()
        return int(parts[0]), int(parts[1]) if len(parts) > 1 else 0
    except (OSError, ValueError, IndexError):
        return None


def _write_pid(path: str, pid: int) -> None:
    try:
        with open(path, "w") as f:
            f.write(f"{pid} {_proc_starttime(pid) or 0}")
    except OSError:
        logger.warning("could not write the pidfile %s", path)


def _unlink_pid(path: str, pid: int) -> None:
    """Remove ``path`` if it still names ``pid``."""
    recorded = _read_pid(path)
    if recorded is not None and recorded[0] == pid:
        try:
            os.unlink(path)
        except OSError:
            pass


def read_pidfile(namespace: Optional[str] = None):
    """(pid, start ticks) recorded for the namespace's worker, or None."""
    return _read_pid(worker_pidfile(namespace))


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
    """Kill a previous agent incarnation's worker and warm spare before
    starting ours.

    An agent that died hard (SIGKILL, OOM) leaves its worker running in
    its own session, holding the GPU and the staged shm, and its spare
    waiting on a pipe nobody writes to. Their identity is (pid, start time)
    from the pidfiles, so a reused pid is never killed. Raises
    :class:`OrphanWorkerError`, keeping the pidfile, if an orphan survives
    SIGKILL."""
    for path in (spare_pidfile(), worker_pidfile()):
        _reap_recorded(path)


def _reap_recorded(path: str) -> None:
    recorded = _read_pid(path)
    if recorded is None:
        return
    pid, recorded_start = recorded

    def alive() -> bool:
        info = _proc_stat(pid)
        if info is None or info[0] == "Z":
            return False
        return not recorded_start or info[1] == recorded_start

    if alive():
        logger.warning("reaping orphan process pid=%s of a dead agent (%s)", pid,
                       os.path.basename(path))
        _kill_group(pid, signal.SIGKILL)
        deadline = time.time() + 30
        while time.time() < deadline and alive():
            time.sleep(0.2)
        if alive():
            raise OrphanWorkerError(f"orphan worker pid={pid} survived SIGKILL; refusing to "
                                    "start a second worker on the same GPU and shm")
    try:
        os.unlink(path)
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


class WarmSpare:
    """A pre-imported interpreter waiting to become the next worker
    (:mod:`.warm_worker`), in a session of its own like the worker.

    The spare pays the interpreter start and the imports ahead of need,
    while the current worker trains, and turns into the worker when
    :meth:`hand_off` writes the env contract to its stdin. It holds no
    CUDA context until then. When the agent dies, the spare reads EOF on
    its stdin and exits.
    """

    def __init__(self, spec: "WorkerSpec", tag: str = "spare"):
        self.spec = spec
        self._ready_file = os.path.join(tempfile.gettempdir(),
                                        f"dlrover_warm_{os.getpid()}_{tag}_{time.time_ns()}")
        env = dict(os.environ)
        env.update(spec.env)
        env["DLROVER_WARM_READY_FILE"] = self._ready_file
        self.log_path: Optional[str] = None
        self._log_file = None
        if spec.log_dir:
            os.makedirs(spec.log_dir, exist_ok=True)
            self.log_path = os.path.join(spec.log_dir, f"worker_{tag}_{time.time_ns()}.log")
            self._log_file = open(self.log_path, "wb")
        self.spawned = time.time()
        # Without a log directory the spare writes where a cold worker would:
        # to the agent's own stdout and stderr (the JAX spare's go nowhere,
        # and so would the adopted worker's output). It prints nothing there
        # before the hand-off.
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.agent.warm_worker"], env=env,
            stdin=subprocess.PIPE, stdout=self._log_file,
            stderr=subprocess.STDOUT if self._log_file else None, start_new_session=True)
        _write_pid(spare_pidfile(), self.proc.pid)
        logger.info("spawned warm spare pid=%s at %.6f", self.proc.pid, self.spawned)

    def ready(self) -> bool:
        return os.path.exists(self._ready_file) and self.proc.poll() is None

    def wait_ready(self, timeout: float = 0.0) -> bool:
        deadline = time.time() + timeout
        while not self.ready():
            if self.proc.poll() is not None or time.time() >= deadline:
                return self.ready()
            time.sleep(0.05)
        return True

    def hand_off(self, dynamic_env: Dict[str, str]) -> None:
        """Turn the spare into the worker (irreversible). Raises OSError if
        the spare died: the pipe is closed or broken. The write is one line
        of a few kilobytes, within the pipe's buffer, so it does not wait on
        the spare."""
        contract = {"env": dynamic_env, "entrypoint": self.spec.entrypoint,
                    "args": list(self.spec.args), "run_module": self.spec.run_module}
        self.proc.stdin.write((json.dumps(contract) + "\n").encode())
        self.proc.stdin.flush()
        self.proc.stdin.close()
        self._cleanup_marker()
        _unlink_pid(spare_pidfile(), self.proc.pid)

    def kill(self) -> None:
        """SIGKILL the spare's group and reap it, so that no zombie is left;
        bounded."""
        if self.proc.poll() is None:
            _kill_group(self.proc.pid, signal.SIGKILL)
        try:
            # killpg alone leaves a zombie holding its slot in the pid table
            self.proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            logger.warning("warm spare pid=%s survived SIGKILL for 5 s", self.proc.pid)
        if self.proc.stdin is not None and not self.proc.stdin.closed:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
        if self._log_file is not None:
            try:
                self._log_file.close()
            finally:
                self._log_file = None
        self._cleanup_marker()
        _unlink_pid(spare_pidfile(), self.proc.pid)

    def detach_log(self):
        """(path, file) handed to the adopting WorkerProcess."""
        log_file, self._log_file = self._log_file, None
        return self.log_path, log_file

    def _cleanup_marker(self) -> None:
        try:
            os.unlink(self._ready_file)
        except OSError:
            pass


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

    def start(self, dynamic_env: Optional[Dict[str, str]] = None,
              spare: Optional[WarmSpare] = None, spare_wait_s: float = 2.0) -> str:
        """Start the worker, or adopt the warm ``spare`` as the worker when it
        is ready within ``spare_wait_s``; returns "warm" or "cold". A spare
        that dies during the hand-off leads to a cold start. The pidfile
        and the "started worker" line come before the worker runs its
        script."""
        contract_env = dict(dynamic_env or {})
        contract_env[NodeEnv.RESTART_COUNT] = str(self.restart_count)
        if spare is not None and not spare.wait_ready(timeout=spare_wait_s):
            logger.warning("warm spare pid=%s not ready; cold-starting", spare.proc.pid)
        elif spare is not None:
            self._log_path, self._log_file = spare.detach_log()
            if self._log_path:
                # the log of the worker of this restart, whichever way it started
                path = os.path.join(self.spec.log_dir, f"worker_{self.restart_count}.log")
                try:
                    os.replace(self._log_path, path)
                    self._log_path = path
                except OSError:
                    logger.warning("could not rename the adopted spare's log %s", self._log_path)
            self._proc = spare.proc
            self._announce("warm")
            try:
                spare.hand_off(contract_env)
                return "warm"
            except OSError as e:
                logger.warning("warm spare died during the hand-off (%s); cold-starting", e)
                spare.kill()
                self._close_log()
                self._log_path = self._proc = None
        env = dict(os.environ)
        env.update(self.spec.env)
        env.update(contract_env)
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
        self._announce("cold")
        return "cold"

    def _announce(self, how: str) -> None:
        """Record the worker: the pidfile (an adopted spare is named with its
        own pid and start ticks) and the "started worker" line."""
        self.start_time = time.time()
        _write_pid(worker_pidfile(), self._proc.pid)
        logger.info("started worker pid=%s restart=%s (%s) entry=%s at %.6f", self._proc.pid,
                    self.restart_count, how, self.spec.entrypoint, self.start_time)

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
        _unlink_pid(worker_pidfile(), self._proc.pid)

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
