"""The port's warm spare (``dlrover_tpu_torch/agent/warm_worker.py``,
``WarmSpare`` in ``agent/worker.py`` and the agent's spare pool) on the CPU:
the spare itself (the JAX package's ``TestWarmSpare`` ported), the env
contract held against the JAX spare's on the same contract line, and the
agent that adopts a spare after a worker SIGKILL and cleans up after itself.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from dlrover_tpu.agent.config import ElasticLaunchConfig as JConfig
from dlrover_tpu_torch.agent import worker as tworker
from dlrover_tpu_torch.agent.config import ElasticLaunchConfig
from dlrover_tpu_torch.agent.training_agent import (AGENT_EXIT_FATAL, AGENT_EXIT_OK,
                                                    ElasticTrainingAgent)
from dlrover_tpu_torch.agent.worker import WarmSpare, WorkerProcess, WorkerSpec, WorkerState
from dlrover_tpu_torch.common import multi_process
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.master.local_master import LocalJobMaster
from dlrover_tpu_torch.rpc.client import MasterClient

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A job of its own: pidfiles, sockets and the namespace under tmp_path;
    the spares find the repository's packages."""
    monkeypatch.setenv("DLROVER_JOB_NAME", f"tws_{os.getpid()}_{tmp_path.name}")
    monkeypatch.setenv("DLROVER_PIDFILE_DIR", str(tmp_path / "pids"))
    monkeypatch.setenv("PYTHONPATH", _REPO)
    monkeypatch.delenv("DLROVER_IPC_NAMESPACE", raising=False)
    monkeypatch.setattr(multi_process, "SOCKET_TMP_DIR", str(tmp_path / "sockets"))


@pytest.fixture()
def master1():
    m = LocalJobMaster(num_workers=1, fresh_context=True)
    m.prepare()
    yield m
    m.stop()


def _dead(pid):
    info = tworker._proc_stat(pid)
    return info is None or info[0] == "Z"


def _wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


# -- the spare --------------------------------------------------------------


def test_spare_adopted_and_env_contract_applied(tmp_path):
    out = tmp_path / "out.txt"
    script = tmp_path / "train.py"
    script.write_text(
        "import os, pathlib, sys\n"
        f"pathlib.Path(r'{out}').write_text(\n"
        "    os.environ['DLROVER_COORDINATOR_ADDRESS'] + ' '\n"
        "    + os.environ['DLROVER_RESTART_COUNT'] + ' ' + sys.argv[1])\n"
        "print('trained')\n")
    spec = WorkerSpec(entrypoint=str(script), args=["argA"], log_dir=str(tmp_path / "logs"))
    spare = WarmSpare(spec, tag="t")
    assert spare.wait_ready(timeout=60), "spare never became ready"
    assert tworker._read_pid(tworker.spare_pidfile())[0] == spare.proc.pid
    worker = WorkerProcess(spec, restart_count=3)
    t0 = time.time()
    how = worker.start(dynamic_env={"DLROVER_COORDINATOR_ADDRESS": "1.2.3.4:5"}, spare=spare)
    assert how == "warm" and worker.pid == spare.proc.pid
    # the pidfile names the adopted spare with its own start ticks
    assert tworker.read_pidfile() == (spare.proc.pid, tworker._proc_starttime(spare.proc.pid))
    assert tworker._read_pid(tworker.spare_pidfile()) is None
    result = worker.wait(timeout=30)
    assert result.state == WorkerState.SUCCEEDED, worker.tail_log()
    assert time.time() - t0 < 10.0  # the imports were paid before the hand-off
    assert out.read_text() == "1.2.3.4:5 3 argA"
    # the adopted spare's log has the name a cold worker's would have
    assert "trained" in (tmp_path / "logs" / "worker_3.log").read_text()


def test_kill_reaps_the_spare_no_zombie(tmp_path):
    script = tmp_path / "train.py"
    script.write_text("print('ok')\n")
    spare = WarmSpare(WorkerSpec(entrypoint=str(script)), tag="z")
    assert spare.wait_ready(timeout=60), "spare never became ready"
    spare.kill()
    assert spare.proc.returncode is not None
    assert _dead(spare.proc.pid), "the killed spare left a zombie"
    assert tworker._read_pid(tworker.spare_pidfile()) is None


def test_eof_on_stdin_ends_the_spare_with_0(tmp_path):
    """The agent's end closes the spare's stdin: the spare exits 0."""
    spare = WarmSpare(WorkerSpec(entrypoint=str(tmp_path / "never.py")), tag="e")
    try:
        assert spare.wait_ready(timeout=60)
        spare.proc.stdin.close()
        assert spare.proc.wait(timeout=30) == 0
    finally:
        spare.kill()


def test_unready_spare_falls_back_cold(tmp_path):
    script = tmp_path / "ok.py"
    script.write_text("print('ran')\n")
    spec = WorkerSpec(entrypoint=str(script))

    class NeverReady(WarmSpare):
        def wait_ready(self, timeout=0.0):
            return False

    spare = NeverReady(spec, tag="n")
    try:
        worker = WorkerProcess(spec)
        assert worker.start(spare=spare) == "cold"
        assert worker.pid != spare.proc.pid
        assert worker.wait(timeout=30).state == WorkerState.SUCCEEDED
        assert spare.proc.poll() is None  # untouched, still a spare
    finally:
        spare.kill()


@pytest.mark.parametrize("when", ["before_the_ready_check", "during_the_hand_off"])
def test_a_spare_that_dies_gives_a_cold_start(tmp_path, when):
    out = tmp_path / "out.txt"
    script = tmp_path / "ok.py"
    script.write_text("import os\n"
                      f"open(r'{out}', 'w').write(os.environ['DLROVER_RESTART_COUNT'])\n")
    spec = WorkerSpec(entrypoint=str(script), log_dir=str(tmp_path / "logs"))

    class DiesAfterTheCheck(WarmSpare):
        def wait_ready(self, timeout=0.0):
            ready = super().wait_ready(timeout=60)
            os.kill(self.proc.pid, signal.SIGKILL)
            self.proc.wait(30)
            return ready

    spare = (WarmSpare if when == "before_the_ready_check" else DiesAfterTheCheck)(spec, tag="d")
    try:
        if when == "before_the_ready_check":
            assert spare.wait_ready(timeout=60)
            os.kill(spare.proc.pid, signal.SIGKILL)
            spare.proc.wait(30)
        worker = WorkerProcess(spec, restart_count=2)
        assert worker.start(spare=spare) == "cold"
        assert worker.pid != spare.proc.pid
        assert worker.wait(timeout=30).state == WorkerState.SUCCEEDED
        assert out.read_text() == "2"
        assert tworker.read_pidfile()[0] == worker.pid
    finally:
        spare.kill()


def test_a_script_run_through_a_spare_has_no_cuda_context(tmp_path):
    """The spare imports torch and the port, and never initialises CUDA;
    the script it becomes sees the contract's env."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import json, os, sys, torch\n"
        "print('PROBE ' + json.dumps({'cuda_initialized': torch.cuda.is_initialized(),\n"
        "    'preloaded': 'dlrover_tpu_torch.models.gpt' in sys.modules,\n"
        "    'rank': os.environ['DLROVER_PROCESS_ID']}), flush=True)\n")
    spec = WorkerSpec(entrypoint=str(script), log_dir=str(tmp_path / "logs"))
    spare = WarmSpare(spec, tag="c")
    try:
        assert spare.wait_ready(timeout=60)
        fds = [os.readlink(f"/proc/{spare.proc.pid}/fd/{fd}")
               for fd in os.listdir(f"/proc/{spare.proc.pid}/fd")]
        assert not [f for f in fds if f.startswith("/dev/nvidia")]
        worker = WorkerProcess(spec, restart_count=1)
        assert worker.start(dynamic_env={"DLROVER_PROCESS_ID": "0"}, spare=spare) == "warm"
        assert worker.wait(timeout=30).state == WorkerState.SUCCEEDED
    finally:
        spare.kill()
    (line,) = [ln for ln in worker.tail_log().splitlines() if ln.startswith("PROBE ")]
    assert json.loads(line[len("PROBE "):]) == {"cuda_initialized": False, "preloaded": True,
                                                "rank": "0"}


def test_the_contract_gives_what_the_jax_spare_gives(tmp_path):
    """The same contract line, fed to the JAX package's warm worker and to
    the port's, gives the script the same os.environ and the same
    sys.argv."""
    script = tmp_path / "dump.py"
    script.write_text(
        "import json, os, sys\n"
        "env = {k: v for k, v in os.environ.items() if k != 'DLROVER_WARM_READY_FILE'}\n"
        "open(sys.argv[1], 'w').write(json.dumps({'env': env, 'argv': sys.argv}))\n")
    dumps = {}
    dump = tmp_path / "dump.json"
    for pkg in ("dlrover_tpu", "dlrover_tpu_torch"):
        contract = {"env": {"DLROVER_COORDINATOR_ADDRESS": "10.0.0.1:7", "DLROVER_PROCESS_ID": 1,
                            "DLROVER_RESTART_COUNT": "4"},
                    "entrypoint": str(script), "args": [str(dump), "--lr", "3e-4"],
                    "run_module": False}
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.agent.warm_worker"], cwd=_REPO,
                              input=json.dumps(contract) + "\n", capture_output=True, text=True,
                              timeout=180, env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        dumps[pkg] = json.loads(dump.read_text())
    jax_dump, port_dump = dumps["dlrover_tpu"], dumps["dlrover_tpu_torch"]
    assert port_dump["argv"] == jax_dump["argv"] == [str(script), str(dump), "--lr", "3e-4"]
    assert port_dump["env"] == jax_dump["env"]
    assert port_dump["env"]["DLROVER_PROCESS_ID"] == "1"


# -- the agent's spare pool -------------------------------------------------


def _agent(master, tmp_path, script, **kw):
    cfg = ElasticLaunchConfig(min_nodes=1, max_nodes=1, entrypoint=str(script),
                              master_addr=master.addr, monitor_interval=0.2, rdzv_timeout=30,
                              save_at_breakpoint=False, log_dir=str(tmp_path / "logs"), **kw)
    return ElasticTrainingAgent(cfg, client=MasterClient(master.addr, node_id=0),
                                start_ckpt_saver=False)


def test_the_port_defaults_to_a_warm_spare_as_the_jax_package_does():
    assert ElasticLaunchConfig().warm_spare is JConfig().warm_spare is True


def test_a_sigkilled_worker_is_replaced_by_the_spare_and_a_new_spare_follows(master1, tmp_path,
                                                                              monkeypatch):
    seen = tmp_path / "seen"
    script = tmp_path / "train.py"
    script.write_text(
        "import os, time\n"
        f"open(r'{seen}', 'a').write(os.environ['DLROVER_RESTART_COUNT'] + ' %d\\n' % os.getpid())\n"
        "time.sleep(300 if os.environ['DLROVER_RESTART_COUNT'] == '0' else 3)\n")
    monkeypatch.setattr(ElasticTrainingAgent, "SPARE_SPAWN_DELAY_S", 0.5)
    agent = _agent(master1, tmp_path, script)
    rc = {}
    t = threading.Thread(target=lambda: rc.update(v=agent.run()), daemon=True)
    t.start()
    spares = []
    try:
        assert _wait_for(lambda: agent._worker is not None and agent._spare is not None
                         and agent._spare.ready(), 60), "no ready spare"
        spare_pid = agent._spare.proc.pid
        spares.append(spare_pid)
        first = agent._worker.pid
        assert first != spare_pid
        os.kill(first, signal.SIGKILL)
        # the agent records the recovery once the new worker has started
        assert _wait_for(lambda: agent.last_recovery.get("new_pid"), 30)
        assert agent._restart_count == 1 and agent._worker.pid == spare_pid
        assert agent.last_recovery["new_pid"] == spare_pid and agent.last_recovery["how"] == "warm"
        assert _wait_for(lambda: seen.exists() and f"1 {spare_pid}" in seen.read_text(), 30)
        # the next spare, SPARE_SPAWN_DELAY_S after the adoption
        assert _wait_for(lambda: agent._spare is not None, 10), "no spare after the adoption"
        spares.append(agent._spare.proc.pid)
        assert spares[1] != spare_pid
        t.join(60)
        assert rc.get("v") == AGENT_EXIT_OK
    finally:
        agent.stop()
        t.join(30)
    assert agent._spare is None
    assert _wait_for(lambda: all(_dead(p) for p in spares + [first]), 10), "a process leaked"


def test_stopping_the_agent_leaves_no_process(master1, tmp_path):
    script = tmp_path / "sleep.py"
    script.write_text("import time\ntime.sleep(300)\n")
    agent = _agent(master1, tmp_path, script)
    t = threading.Thread(target=agent.run, daemon=True)
    t.start()
    try:
        assert _wait_for(lambda: agent._worker is not None and agent._spare is not None, 30)
        pids = [agent._worker.pid, agent._spare.proc.pid]
    finally:
        agent.stop()
        t.join(60)
    assert not t.is_alive()
    assert _wait_for(lambda: all(_dead(p) for p in pids), 10), "a process leaked"


def test_the_orphan_guard_kills_the_spare_too(master1, tmp_path, monkeypatch):
    monkeypatch.setattr(get_context(), "master_lost_timeout_s", 1.0)
    monkeypatch.setattr(get_context(), "heartbeat_interval_s", 0.1)
    monkeypatch.setattr(get_context(), "rpc_retries", 1)
    script = tmp_path / "sleep.py"
    script.write_text("import time\ntime.sleep(300)\n")
    agent = _agent(master1, tmp_path, script)
    rc = {}
    t = threading.Thread(target=lambda: rc.update(v=agent.run()), daemon=True)
    t.start()
    try:
        assert _wait_for(lambda: agent._worker is not None and agent._spare is not None, 30)
        pids = [agent._worker.pid, agent._spare.proc.pid]
        master1.stop()
        t.join(30)
        assert rc.get("v") == AGENT_EXIT_FATAL
    finally:
        agent.stop()
        t.join(30)
    assert _wait_for(lambda: all(_dead(p) for p in pids), 10), "a process leaked"


def test_reap_stale_workers_kills_a_dead_agents_spare(tmp_path):
    """An agent that died hard leaves its spare behind; the next agent of
    the job reaps it through the spare's pidfile."""
    spare = WarmSpare(WorkerSpec(entrypoint=str(tmp_path / "x.py")), tag="o")
    try:
        assert spare.wait_ready(timeout=60)
        tworker.reap_stale_workers()
        assert _wait_for(lambda: spare.proc.poll() is not None, 30)
        assert not os.path.exists(tworker.spare_pidfile())
    finally:
        spare.kill()
