"""The port's agent (rendezvous handler, worker supervision, diagnosis, the
training agent) on the CPU, against the port's own live master, with real
worker subprocesses (small scripts under ``tmp_path``), and its decisions
held against the JAX package's on the same inputs.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from dlrover_tpu.agent import rendezvous as jrendezvous
from dlrover_tpu.agent.config import ElasticLaunchConfig as JConfig
from dlrover_tpu.common import comm as jcomm
from dlrover_tpu.diagnosis.diagnostician import FailureNodeDiagnostician as JDiagnostician
from dlrover_tpu_torch.agent import worker as tworker
from dlrover_tpu_torch.agent.config import ElasticLaunchConfig
from dlrover_tpu_torch.agent.diagnosis_agent import DiagnosisAgent, WorkerFailure
from dlrover_tpu_torch.agent.rendezvous import (MasterRendezvousHandler, RendezvousTimeoutError,
                                                RendezvousWorld)
from dlrover_tpu_torch.agent.training_agent import (AGENT_EXIT_FATAL, AGENT_EXIT_OK,
                                                    AGENT_EXIT_RELAUNCH, ElasticTrainingAgent)
from dlrover_tpu_torch.agent.worker import WorkerProcess, WorkerSpec, WorkerState
from dlrover_tpu_torch.common import comm as tcomm
from dlrover_tpu_torch.common import multi_process
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.diagnosis.diagnostician import FailureNodeDiagnostician
from dlrover_tpu_torch.master.diagnosis.action import DiagnosisActionType
from dlrover_tpu_torch.master.local_master import LocalJobMaster
from dlrover_tpu_torch.rpc.client import MasterClient


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A job of its own: pidfiles, sockets and the namespace under tmp_path."""
    monkeypatch.setenv("DLROVER_JOB_NAME", f"tag_{os.getpid()}_{tmp_path.name}")
    monkeypatch.setenv("DLROVER_PIDFILE_DIR", str(tmp_path / "pids"))
    monkeypatch.delenv("DLROVER_IPC_NAMESPACE", raising=False)
    monkeypatch.setattr(multi_process, "SOCKET_TMP_DIR", str(tmp_path / "sockets"))


@pytest.fixture()
def master1():
    m = LocalJobMaster(num_workers=1, fresh_context=True)
    m.prepare()
    yield m
    m.stop()


@pytest.fixture()
def master2():
    m = LocalJobMaster(num_workers=2, fresh_context=True)
    m.prepare()
    yield m
    m.stop()


def _client(master, node_id):
    return MasterClient(master.addr, node_id=node_id)


def _write_script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(body)
    return str(path)


def _wait_for(cond, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


class TestRendezvousHandler:
    def test_two_nodes_assemble_world(self, master2):
        results = {}

        def join(rank):
            handler = MasterRendezvousHandler(RendezvousName.TRAINING, node_rank=rank,
                                              client=_client(master2, rank), rdzv_timeout=30)
            results[rank] = handler.next_rendezvous()

        threads = [threading.Thread(target=join, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        w0, w1 = results[0], results[1]
        assert w0.world_size == w1.world_size == 2 and {w0.rank, w1.rank} == {0, 1}
        assert w0.coordinator == w1.coordinator and ":" in w0.coordinator

    def test_rank_is_topology_position(self, master1):
        handler = MasterRendezvousHandler(RendezvousName.TRAINING, node_rank=7,
                                          client=_client(master1, 7), rdzv_timeout=30)
        world = handler.next_rendezvous()
        assert (world.rank, world.world_size, world.world[0].node_rank) == (0, 1, 7)

    def test_rendezvous_times_out_when_the_world_never_completes(self, master2):
        handler = MasterRendezvousHandler(RendezvousName.TRAINING, node_rank=0,
                                          client=_client(master2, 0), rdzv_timeout=0.5)
        t0 = time.monotonic()
        with pytest.raises(RendezvousTimeoutError):
            handler.next_rendezvous()
        assert time.monotonic() - t0 < 5

    def test_coordinator_wait_is_bounded(self, master1):
        handler = MasterRendezvousHandler(RendezvousName.TRAINING, node_rank=1,
                                          client=_client(master1, 1), rdzv_timeout=0.3)
        world = RendezvousWorld(round=9, rank=1, world_size=2)
        with pytest.raises(RendezvousTimeoutError, match="never published"):
            handler._elect_coordinator(world)


class TestWorkerProcess:
    def test_success_lifecycle(self, tmp_path):
        script = _write_script(tmp_path, "ok.py", "print('hello')\n")
        w = WorkerProcess(WorkerSpec(entrypoint=script, log_dir=str(tmp_path)))
        w.start()
        assert w.wait(timeout=30).state == WorkerState.SUCCEEDED
        assert "hello" in w.tail_log()

    def test_failure_captures_log(self, tmp_path):
        script = _write_script(tmp_path, "bad.py", "raise RuntimeError('boom-xyz')\n")
        w = WorkerProcess(WorkerSpec(entrypoint=script, log_dir=str(tmp_path)))
        w.start()
        result = w.wait(timeout=30)
        assert (result.state, result.returncode) == (WorkerState.FAILED, 1)
        assert "boom-xyz" in w.tail_log()

    def test_stop_kills_process_group(self, tmp_path):
        script = _write_script(tmp_path, "tree.py", (
            "import subprocess, sys, time\n"
            "child = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(600)'])\n"
            "print('up', child.pid, flush=True)\n"
            "time.sleep(600)\n"))
        w = WorkerProcess(WorkerSpec(entrypoint=script, log_dir=str(tmp_path), kill_grace_s=2))
        w.start()
        assert _wait_for(lambda: "up" in w.tail_log(), 20)
        child = int(w.tail_log().split()[1])
        pid = w.pid
        assert tworker.read_pidfile()[0] == pid
        w.stop()
        assert w.poll().state in (WorkerState.FAILED, WorkerState.SUCCEEDED)
        for p in (pid, child):
            assert _wait_for(lambda p=p: tworker._proc_stat(p) is None
                             or tworker._proc_stat(p)[0] == "Z", 10)
        assert tworker.read_pidfile() is None

    def test_env_contract_passed(self, tmp_path):
        script = _write_script(tmp_path, "env.py", (
            "import os\nprint('PID=' + os.environ['DLROVER_PROCESS_ID'], "
            "'RC=' + os.environ['DLROVER_RESTART_COUNT'])\n"))
        w = WorkerProcess(WorkerSpec(entrypoint=script, log_dir=str(tmp_path)), restart_count=2)
        w.start(dynamic_env={"DLROVER_PROCESS_ID": "3"})
        w.wait(timeout=30)
        assert "PID=3 RC=2" in w.tail_log()

    def test_reap_stale_workers_kills_a_dead_agents_worker(self, tmp_path):
        """A worker whose agent died stays in its own session; the next
        agent reaps it through the pidfile before starting its own."""
        script = _write_script(tmp_path, "sleep.py", "import time\ntime.sleep(600)\n")
        orphan = subprocess.Popen([sys.executable, "-c", (
            "import sys; sys.path.insert(0, %r)\n"
            "from dlrover_tpu_torch.agent.worker import WorkerProcess, WorkerSpec\n"
            "w = WorkerProcess(WorkerSpec(entrypoint=%r)); w.start(); print(w.pid, flush=True)\n"
        ) % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))), script)],
            stdout=subprocess.PIPE, text=True, env=dict(os.environ))
        pid = int(orphan.stdout.readline())
        orphan.wait(30)  # the "agent" is gone; its worker lives on
        assert tworker._proc_stat(pid) is not None
        tworker.reap_stale_workers()
        assert _wait_for(lambda: tworker._proc_stat(pid) is None
                         or tworker._proc_stat(pid)[0] == "Z", 10)
        assert tworker.read_pidfile() is None
        tworker.reap_stale_workers()  # nothing recorded: a no-op


# -- diagnosis ---------------------------------------------------------------

# (TPU-worded tail of the JAX patterns, the CUDA tail that stands for it)
_DEVICE_TAILS = [
    ("Failed to initialize TPU system", "RuntimeError: No CUDA GPUs are available"),
    ("TPU platform 'tpu' not found", "RuntimeError: Found no NVIDIA driver on your system."),
    ("failed to initialize tpu: init error",
     "RuntimeError: CUDA driver initialization failed, you might not have a CUDA gpu."),
    ("PJRT internal error: device lost",
     "NVRM: Xid (PCI:0000:04:00): 79, pid=1234, GPU has fallen off the bus."),
    ("uncorrectable ECC error on HBM", "RuntimeError: CUDA error: uncorrectable ECC error "
                                       "encountered"),
    ("RESOURCE_EXHAUSTED: exceeded HBM capacity by 2.1G",
     "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB"),
]
# tails that name no device: the same in both packages
_NEUTRAL_TAILS = ["Connection refused by peer", "whatever", "", "Traceback: KeyError: 'x'",
                  "DEADLINE EXCEEDED while waiting", "barrier timed out after 300s",
                  "Device or resource busy", "Fatal Python error: SIGBUS",
                  "killed by the oom-killer", "RendezvousOutSyncError"]


def _cases():
    for restart_count in (0, 1, 3):
        for rc, sig in ((1, None), (-9, 9)):
            yield restart_count, rc, sig


@pytest.mark.parametrize("tpu_tail,cuda_tail", _DEVICE_TAILS)
def test_cuda_tails_get_the_decision_of_the_tpu_tails_they_stand_for(tpu_tail, cuda_tail):
    for restart_count, rc, sig in _cases():
        kw = dict(restart_count=restart_count, returncode=rc, signal=sig)
        jax_action = JDiagnostician(max_restarts=3).decide(log_tail=tpu_tail, **kw)
        assert FailureNodeDiagnostician(max_restarts=3).decide(log_tail=cuda_tail, **kw) == \
            jax_action, (cuda_tail, kw)
        # and the attribution class is the same, not only the action
        jfact = JDiagnostician()._chain.infer(JDiagnostician().observe(log_tail=tpu_tail, **kw))
        tfact = FailureNodeDiagnostician()._chain.infer(
            FailureNodeDiagnostician().observe(log_tail=cuda_tail, **kw))
        assert jfact[0].attribution == tfact[0].attribution


@pytest.mark.parametrize("tail", _NEUTRAL_TAILS)
def test_device_neutral_tails_decide_as_in_the_jax_package(tail, tmp_path):
    for restart_count, rc, sig in _cases():
        kw = dict(restart_count=restart_count, returncode=rc, signal=sig)
        assert FailureNodeDiagnostician(2).decide(log_tail=tail, **kw) == \
            JDiagnostician(2).decide(log_tail=tail, **kw)
    log = tmp_path / "worker.log"
    log.write_text("noise\n" * 100 + tail)
    assert FailureNodeDiagnostician(2).decide(log_path=str(log)) == \
        JDiagnostician(2).decide(log_path=str(log))


class TestDiagnosisClassification:
    def _agent(self, master, max_restarts=3):
        return DiagnosisAgent(0, client=_client(master, 0), max_restarts=max_restarts)

    def test_retryable_restarts(self, master1):
        f = WorkerFailure(0, 0, 1, None, log_tail="Connection refused by peer")
        assert self._agent(master1).diagnose_training_failure(f) == \
            DiagnosisActionType.RESTART_WORKER

    def test_node_fatal_relaunches(self, master1):
        f = WorkerFailure(0, 0, 1, None, log_tail="RuntimeError: No CUDA GPUs are available")
        assert self._agent(master1).diagnose_training_failure(f) == \
            DiagnosisActionType.RELAUNCH_WORKER

    def test_budget_exhaustion_relaunches(self, master1):
        f = WorkerFailure(0, 2, 1, None, log_tail="whatever")
        assert self._agent(master1, max_restarts=2).diagnose_training_failure(f) == \
            DiagnosisActionType.RELAUNCH_WORKER

    def test_failure_report_reaches_the_master(self, master1):
        self._agent(master1).report_failure(WorkerFailure(0, 2, 1, None, log_tail="x" * 9000))
        assert master1._job_ctx.get_node("worker", 0).relaunch_count == 2

    def test_orphan_guard_aborts_when_master_lost(self, monkeypatch):
        class DeadClient:
            def report_heartbeat(self):
                raise ConnectionError("master gone")

        monkeypatch.setattr(get_context(), "master_lost_timeout_s", 0.3)
        d = DiagnosisAgent(0, client=DeadClient(), heartbeat_interval=0.05)
        aborted = threading.Event()

        def on_action(action_type, config):
            if action_type == DiagnosisActionType.JOB_ABORTION:
                assert config.get("reason") == "master_unreachable"
                aborted.set()

        d.register_action_handler(on_action)
        d.start_heartbeat()
        assert aborted.wait(5.0), "orphan guard never fired"
        d._hb_thread.join(5.0)
        assert not d._hb_thread.is_alive()
        d.stop()

    def test_heartbeat_delivers_master_actions(self, master1):
        from dlrover_tpu_torch.master.diagnosis.action import NodeAction

        master1._job_ctx.node_actions.add_action(
            NodeAction(node_id=0, action_type=DiagnosisActionType.RESTART_WORKER, reason="hang"))
        d = DiagnosisAgent(0, client=_client(master1, 0), heartbeat_interval=0.05)
        got = []
        d.register_action_handler(lambda action_type, config: got.append((action_type,
                                                                          config["reason"])))
        d.start_heartbeat()
        assert _wait_for(lambda: got, 10)
        d.stop()
        assert got == [(DiagnosisActionType.RESTART_WORKER, "hang")]


# -- the training agent ------------------------------------------------------


def _make_agent(master, tmp_path, script, node_rank=0, **cfg_kw):
    cfg = ElasticLaunchConfig(
        min_nodes=1, max_nodes=cfg_kw.pop("max_nodes", 1), node_id=node_rank,
        node_rank=node_rank, entrypoint=script, master_addr=master.addr, monitor_interval=0.2,
        rdzv_timeout=30, save_at_breakpoint=False, log_dir=str(tmp_path / f"logs{node_rank}"),
        **cfg_kw)
    return ElasticTrainingAgent(cfg, client=_client(master, node_rank), start_ckpt_saver=False)


def test_world_env_matches_the_jax_agent(tmp_path, monkeypatch):
    """The same world gives the same per-round env contract (the JAX
    agent's trace keys aside: no incident is open)."""
    from dlrover_tpu.agent.training_agent import ElasticTrainingAgent as JAgent

    class NoClient:
        pass

    metas = {0: dict(node_id=4, node_rank=4, addr="10.0.0.4"), 1: dict(node_id=2, node_rank=2)}
    jworld = jrendezvous.RendezvousWorld(round=3, rank=1, world_size=2, coordinator="10.0.0.4:99",
                                         world={k: jcomm.NodeMeta(**v) for k, v in metas.items()})
    tworld = RendezvousWorld(round=3, rank=1, world_size=2, coordinator="10.0.0.4:99",
                             world={k: tcomm.NodeMeta(**v) for k, v in metas.items()})
    kw = dict(node_id=2, node_rank=2, max_nodes=2, entrypoint="train.py", soft_remesh=False,
              warm_spare=False, profile="off")
    monkeypatch.setenv("DLROVER_REMESH_DIR", str(tmp_path / "remesh"))
    jagent = JAgent(JConfig(**kw), client=NoClient(), start_ckpt_saver=False)
    tagent = ElasticTrainingAgent(ElasticLaunchConfig(**kw), client=NoClient(),
                                  start_ckpt_saver=False)
    jenv = {k: v for k, v in jagent._world_env(jworld).items() if "TRACE" not in k}
    assert tagent._world_env(tworld) == jenv


def test_agent_hands_the_worker_its_ipc_namespace(master1, tmp_path):
    agent = _make_agent(master1, tmp_path, "x.py")
    env = agent._spec.env
    assert env["DLROVER_IPC_DIR"] == multi_process.SOCKET_TMP_DIR
    assert env["DLROVER_IPC_NAMESPACE"] == os.environ["DLROVER_JOB_NAME"]


@pytest.mark.parametrize("field,value", [("soft_remesh", True),
                                         ("profile", "on"), ("numa_affinity", True),
                                         ("compile_cache_dir", "/x"), ("network_check", True),
                                         ("auto_tunning", True), ("exclude_straggler", True)])
def test_agent_features_not_ported_raise(master1, tmp_path, field, value):
    with pytest.raises(NotImplementedError, match="not ported"):
        _make_agent(master1, tmp_path, "x.py", **{field: value})


class TestElasticTrainingAgent:
    def test_successful_run(self, master1, tmp_path):
        script = _write_script(tmp_path, "ok.py", "print('done')\n")
        agent = _make_agent(master1, tmp_path, script)
        assert agent.run() == AGENT_EXIT_OK
        assert master1._job_ctx.get_node("worker", 0).status == "succeeded"

    def test_restart_then_success(self, master1, tmp_path):
        marker = tmp_path / "marker"
        script = _write_script(tmp_path, "flaky.py", (
            "import os, sys\n"
            f"marker = {str(marker)!r}\n"
            "if not os.path.exists(marker):\n"
            "    open(marker, 'w').close()\n"
            "    sys.exit(3)\n"
            "print('recovered with RESTART_COUNT=' + os.environ['DLROVER_RESTART_COUNT'])\n"))
        agent = _make_agent(master1, tmp_path, script, max_restarts=2)
        assert agent.run() == AGENT_EXIT_OK
        assert agent._restart_count == 1
        assert "RESTART_COUNT=1" in (tmp_path / "logs0" / "worker_1.log").read_text()
        rec = agent.last_recovery
        assert rec["returncode"] == 3 and rec["action"] == DiagnosisActionType.RESTART_WORKER
        assert rec["detected"] <= rec["persisted"] <= rec["respawned"]

    def test_relaunch_when_budget_exhausted(self, master1, tmp_path):
        script = _write_script(tmp_path, "bad.py", "import sys\nsys.exit(5)\n")
        agent = _make_agent(master1, tmp_path, script, max_restarts=0)
        assert agent.run() == AGENT_EXIT_RELAUNCH
        node = master1._job_ctx.get_node("worker", 0)
        assert (node.status, node.exit_reason) == ("failed", "relaunch_requested")

    def test_agent_exits_when_master_dies_mid_training(self, master1, tmp_path, monkeypatch):
        """The orphan guard end to end: the agent whose master disappears
        stops its worker and exits instead of supervising forever."""
        monkeypatch.setattr(get_context(), "master_lost_timeout_s", 1.0)
        monkeypatch.setattr(get_context(), "heartbeat_interval_s", 0.1)
        monkeypatch.setattr(get_context(), "rpc_retries", 1)
        script = _write_script(tmp_path, "sleep.py",
                               "import time\nprint('up', flush=True)\ntime.sleep(300)\n")
        agent = _make_agent(master1, tmp_path, script)
        rc = {}
        t = threading.Thread(target=lambda: rc.update(v=agent.run()), daemon=True)
        t.start()
        try:
            assert _wait_for(lambda: agent._worker is not None)
            pid = agent._worker.pid
            master1.stop()
            t.join(30)
            assert not t.is_alive(), "agent kept supervising a masterless world"
            assert rc.get("v") == AGENT_EXIT_FATAL
        finally:
            agent.stop()
        assert agent._worker._proc.poll() is not None
        assert tworker._proc_stat(pid) is None or tworker._proc_stat(pid)[0] == "Z"

    def test_master_actions_restart_and_abort(self, master1, tmp_path):
        script = _write_script(tmp_path, "sleep.py", "import time\ntime.sleep(300)\n")
        agent = _make_agent(master1, tmp_path, script)
        rc = {}
        t = threading.Thread(target=lambda: rc.update(v=agent.run()), daemon=True)
        t.start()
        try:
            assert _wait_for(lambda: agent._worker is not None)
            first = agent._worker.pid
            agent._on_master_action(DiagnosisActionType.RESTART_WORKER, {})
            assert _wait_for(lambda: agent._worker.pid != first and agent._restart_count == 1)
            agent._on_master_action(DiagnosisActionType.JOB_ABORTION, {})
            t.join(30)
            assert rc.get("v") == AGENT_EXIT_FATAL
        finally:
            agent.stop()

    def test_two_agents_and_a_membership_change_re_rendezvous_both(self, master2, tmp_path):
        """Two agents form a world of 2; a worker killed on one host makes
        both re-rendezvous into round 1."""
        script = _write_script(tmp_path, "sleep.py",
                               "import time\nprint('up', flush=True)\ntime.sleep(120)\n")
        agents = [_make_agent(master2, tmp_path, script, node_rank=r, max_nodes=2) for r in (0, 1)]
        codes = {}
        threads = [threading.Thread(target=lambda r=r: codes.update({r: agents[r].run()}),
                                    daemon=True) for r in (0, 1)]
        for t in threads:
            t.start()
        try:
            assert _wait_for(lambda: all(a._worker is not None and a._worker.poll().state ==
                                         WorkerState.RUNNING for a in agents))
            assert agents[0]._world.round == agents[1]._world.round == 0
            assert agents[0]._world.world_size == 2
            assert agents[0]._world.coordinator == agents[1]._world.coordinator
            os.kill(agents[1]._worker.pid, signal.SIGKILL)
            assert _wait_for(lambda: all(
                a._world is not None and a._world.round == 1
                and a._worker.poll().state == WorkerState.RUNNING for a in agents), 60), \
                f"worlds: {[a._world and a._world.round for a in agents]}"
            assert agents[0]._world.world_size == 2
        finally:
            for a in agents:
                a.stop()
            for t in threads:
                t.join(timeout=30)


def test_exit_barrier_is_bounded(master2, tmp_path):
    agent = _make_agent(master2, tmp_path, "x.py", max_nodes=2)
    agent._world = RendezvousWorld(round=0, rank=0, world_size=2)
    t0 = time.monotonic()
    agent._exit_barrier(timeout=0.5)  # the peer never arrives
    assert time.monotonic() - t0 < 5
    assert _client(master2, 1).kv_store_add("exit_barrier/0", 0) == 1


def test_config_worker_env_and_slice_match_the_jax_config():
    kw = dict(min_nodes=2, max_nodes=4, node_unit=2, node_id=3, node_rank=3,
              master_addr="10.0.0.1:5", master_service_type="http", job_name="j",
              compile_cache_dir="", input_prefetch=False)
    tcfg, jcfg = ElasticLaunchConfig(**kw), JConfig(**kw)
    assert tcfg.worker_env() == jcfg.worker_env()
    assert tcfg.slice_id() == jcfg.slice_id() == 1
    jfields = {f.name for f in dataclasses.fields(JConfig)}
    assert {f.name for f in dataclasses.fields(ElasticLaunchConfig)} == jfields
