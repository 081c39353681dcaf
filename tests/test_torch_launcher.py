"""The port's launcher (``tpurun-torch``) on the CPU: argument parsing held
against the JAX launcher's, the flags of features not ported, the local
device count without a CUDA context, real standalone launches of small
workers, and the CPU twin of ``chip_smoke.py``'s phase 6: the flagship
command with a worker SIGKILLed and resumed from shm under its own agent.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from dlrover_tpu.launcher import elastic_run as jelastic_run
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import multi_process
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.launcher import elastic_run
from dlrover_tpu_torch.launcher.elastic_run import config_from_args, parse_args, parse_nnodes
from dlrover_tpu_torch.master.local_master import LocalJobMaster
from dlrover_tpu_torch.rpc.client import MasterClient

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fields whose defaults differ on purpose: the device, and a feature the
# port does not have (off here, on in the JAX package)
_DIFFERENT = {"accelerator", "soft_remesh"}


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A fresh client singleton and job; the launcher's environment
    writes are undone (it sets DLROVER_MASTER_ADDR, DLROVER_NODE_ID and
    DLROVER_JOB_NAME, and the JAX package's tests that run later in the
    same worker read them); no SIGTERM hook left in the test process."""
    saved_env = dict(os.environ)
    MasterClient.reset_singleton()
    for name in (NodeEnv.MASTER_ADDR, NodeEnv.NODE_ID, NodeEnv.NODE_RANK, NodeEnv.NODE_NUM,
                 NodeEnv.NODE_UNIT, "DLROVER_IPC_NAMESPACE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(NodeEnv.JOB_NAME, f"tl_{os.getpid()}_{tmp_path.name}")
    monkeypatch.setenv(NodeEnv.MASTER_SERVICE_TYPE, "http")
    monkeypatch.setenv("DLROVER_PIDFILE_DIR", str(tmp_path / "pids"))
    monkeypatch.setenv("DLROVER_IPC_DIR", str(tmp_path / "sockets"))
    monkeypatch.setattr(multi_process, "SOCKET_TMP_DIR", str(tmp_path / "sockets"))
    monkeypatch.setattr(AsyncCheckpointSaver, "_signals_installed", True)
    monkeypatch.setenv("DLROVER_LOCAL_DEVICES", "1")
    yield
    MasterClient.reset_singleton()
    AsyncCheckpointSaver.shutdown()
    job = os.environ[NodeEnv.JOB_NAME]
    for name in os.listdir("/dev/shm"):
        if name.startswith(f"dlrover_{job}"):
            os.unlink(os.path.join("/dev/shm", name))
    monkeypatch.undo()
    os.environ.clear()
    os.environ.update(saved_env)


def test_parse_nnodes():
    assert parse_nnodes("4") == (4, 4) == jelastic_run.parse_nnodes("4")
    assert parse_nnodes("2:8") == (2, 8) == jelastic_run.parse_nnodes("2:8")


@pytest.mark.parametrize("argv", [
    ["train.py"],
    ["--standalone", "--nnodes", "2:4", "--nproc_per_node", "8", "--node_unit", "2",
     "--precheck", "2", "--max_restarts", "5", "train.py", "--lr", "3e-4"],
    ["-m", "my.pkg.train", "--foo"],
    ["--node_rank", "3", "--monitor_interval", "0.5", "--training_port", "7000",
     "--no-save_at_breakpoint", "--sync-input", "--log_dir", "/tmp/x", "t.py"],
    ["--profile", "off", "--auto_config", "--nnodes", "2", "t.py"],
])
def test_the_same_argv_gives_the_jax_config_and_worker_env(argv, monkeypatch):
    ns, jns = parse_args(argv), jelastic_run.parse_args(argv)
    assert (ns.standalone, ns.precheck, ns.entrypoint, ns.entry_args, ns.module) == \
        (jns.standalone, jns.precheck, jns.entrypoint, jns.entry_args, jns.module)
    config, jconfig = config_from_args(ns), jelastic_run.config_from_args(jns)
    got, want = dataclasses.asdict(config), dataclasses.asdict(jconfig)
    for name in _DIFFERENT:
        got.pop(name), want.pop(name)
    assert got == want
    assert config.worker_env() == jconfig.worker_env()


def test_auto_config_from_env_matches_the_jax_launcher(monkeypatch):
    monkeypatch.setenv(NodeEnv.NODE_NUM, "6")
    monkeypatch.setenv(NodeEnv.NODE_UNIT, "3")
    config = config_from_args(parse_args(["--auto_config", "train.py"]))
    jconfig = jelastic_run.config_from_args(jelastic_run.parse_args(["--auto_config", "train.py"]))
    assert (config.min_nodes, config.max_nodes, config.node_unit, config.network_check) == \
        (jconfig.min_nodes, jconfig.max_nodes, jconfig.node_unit, jconfig.network_check) == \
        (6, 6, 3, True)


@pytest.mark.parametrize("flags", [["--network-check"], ["--numa-affinity"], ["--profile", "on"],
                                   ["--auto_tunning"], ["--compile-cache-dir", "/tmp/cc"],
                                   ["--comm-perf-test"], ["--exclude-straggler"]])
def test_flags_of_features_not_ported_raise(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        config_from_args(parse_args(flags + ["train.py"]))
    with pytest.raises(NotImplementedError, match="not ported"):
        elastic_run.main(["--standalone"] + flags + ["train.py"])


def test_local_device_count_never_touches_cuda(monkeypatch, tmp_path):
    def boom(*a, **k):
        raise AssertionError("the launcher touched torch.cuda")

    monkeypatch.setattr(torch.cuda, "is_available", boom)
    monkeypatch.setattr(torch.cuda, "device_count", boom)
    monkeypatch.delenv("DLROVER_LOCAL_DEVICES")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,3")
    assert elastic_run._local_device_count() == 2
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    fake = tmp_path / "bin" / "nvidia-smi"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\nfor i in 0 1 2 3; do echo \"GPU $i: NVIDIA H100 (UUID: x)\"; done\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    assert elastic_run._local_device_count() == 4
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert elastic_run._local_device_count() == 1
    monkeypatch.setenv("DLROVER_LOCAL_DEVICES", "8")
    assert elastic_run._local_device_count() == 8


def test_wait_pre_check_passes(monkeypatch):
    master = LocalJobMaster(num_workers=1, fresh_context=True)
    master.prepare()
    try:
        monkeypatch.setenv(NodeEnv.MASTER_ADDR, master.addr)
        assert elastic_run.wait_pre_check(MasterClient.singleton(), level=2, timeout=10)
        assert elastic_run.wait_pre_check(MasterClient.singleton(), level=0)
    finally:
        master.stop()


def _launch(monkeypatch, argv):
    """main() in this process, recording the standalone master it spawns."""
    handles = []
    real = elastic_run.launch_local_master

    def spy(*a, **k):
        handles.append(real(*a, **k))
        return handles[-1]

    monkeypatch.setattr(elastic_run, "launch_local_master", spy)
    try:
        return elastic_run.main(argv), handles
    except BaseException as e:  # noqa: BLE001 — the caller checks the master either way
        return e, handles


def test_standalone_end_to_end(tmp_path, monkeypatch):
    """A real standalone launch: a master subprocess and a worker
    subprocess with the env contract, to success; the master exits 0."""
    script = tmp_path / "train_ok.py"
    script.write_text(
        "import os\n"
        "assert os.environ['DLROVER_COORDINATOR_ADDRESS']\n"
        "assert os.environ['DLROVER_NUM_PROCESSES'] == '1'\n"
        "assert os.environ['DLROVER_PROCESS_ID'] == '0'\n"
        "assert os.environ['DLROVER_RESTART_COUNT'] == '0'\n"
        "assert os.environ['DLROVER_IPC_NAMESPACE'] == os.environ['DLROVER_JOB_NAME']\n"
        "print('worker ran fine')\n")
    rc, (handle,) = _launch(monkeypatch, ["--standalone", "--nnodes", "1", "--monitor_interval",
                                          "0.2", str(script)])
    assert rc == 0
    assert handle.proc.returncode == 0  # the master saw the job succeed
    assert os.environ[NodeEnv.MASTER_ADDR] == handle.addr


def test_standalone_worker_failure_relaunch_path(tmp_path, monkeypatch):
    """A permanently failing worker exhausts its restarts: the launcher
    exits nonzero, and its master is stopped all the same."""
    script = tmp_path / "train_bad.py"
    script.write_text("raise SystemExit(3)\n")
    rc, (handle,) = _launch(monkeypatch, ["--standalone", "--nnodes", "1", "--max_restarts", "0",
                                          "--monitor_interval", "0.2", str(script)])
    assert rc != 0
    assert handle.proc.poll() is not None


def test_master_is_stopped_when_the_launch_raises(tmp_path, monkeypatch):
    def explode(self):
        raise RuntimeError("agent blew up")

    monkeypatch.setattr(elastic_run.ElasticLaunch, "__call__", explode)
    err, (handle,) = _launch(monkeypatch, ["--standalone", str(tmp_path / "x.py")])
    assert isinstance(err, RuntimeError)
    assert handle.proc.poll() is not None  # stopped, not leaked


def test_no_master_and_not_standalone_exits_2(tmp_path):
    assert elastic_run.main([str(tmp_path / "x.py")]) == 2


def test_sigterm_stops_launcher_master_and_worker(tmp_path):
    """SIGTERM to the launcher: the agent stops its worker, the launcher
    its master; nothing of the job is left."""
    import signal
    import time

    script = tmp_path / "sleep.py"
    script.write_text("import time\nprint('up', flush=True)\ntime.sleep(300)\n")
    env = {**os.environ, "PYTHONPATH": _REPO}
    proc = subprocess.Popen([sys.executable, "-m", "dlrover_tpu_torch.launcher.elastic_run",
                             "--standalone", "--monitor_interval", "0.2", str(script)], cwd=_REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("up"):
            break
    worker = next(int(ln.split("pid=")[1].split()[0]) for ln in lines if "started worker" in ln)
    master = next(p for p in os.listdir("/proc") if p.isdigit() and "master.main" in
                  open(f"/proc/{p}/cmdline", "rb").read().decode(errors="replace")
                  and open(f"/proc/{p}/stat").read().split(") ")[1].split()[1] == str(proc.pid))
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(60) != 0
    proc.stdout.read()
    for pid in (worker, int(master)):
        deadline = time.time() + 10
        while os.path.exists(f"/proc/{pid}") and time.time() < deadline:
            if open(f"/proc/{pid}/stat").read().split(") ")[1].split()[0] == "Z":
                break
            time.sleep(0.1)
        assert not os.path.exists(f"/proc/{pid}") or \
            open(f"/proc/{pid}/stat").read().split(") ")[1].split()[0] == "Z"


def test_example_without_cpu_flag_fails_without_a_gpu(tmp_path):
    assert not torch.cuda.is_available()
    env = {**os.environ, "PYTHONPATH": _REPO, "CKPT_DIR": str(tmp_path / "ckpt"),
           "TOTAL_STEPS": "2"}
    proc = subprocess.run([sys.executable, "-m", "dlrover_tpu_torch.examples.gpt_elastic"],
                          cwd=_REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"event": "step"' not in proc.stdout


def test_flagship_command_survives_a_worker_sigkill_on_the_cpu(tmp_path, monkeypatch):
    """The CPU twin of chip_smoke.py's phase 6, run A: the real tpurun
    --standalone job of the example at the small size, with the warm spare
    on (the default); the worker is SIGKILLed once it has staged step 10
    and a spare is ready, its agent persists the staged step and adopts the
    spare as the new worker, which resumes from shm; the launcher exits 0
    and leaves no process behind."""
    sys.path.insert(0, _REPO)
    import chip_smoke
    from dlrover_tpu_torch.examples import gpt_elastic

    steps = chip_smoke.TPURUN_STEPS
    # the uninterrupted run of the same steps, in this process
    _, state, step_fn, batches = gpt_elastic.build(small=True, device=torch.device("cpu"))
    reference = {}
    for s, (x, y) in zip(range(steps), batches(0, steps)):
        state, loss = step_fn(state, x, y)
        reference[str(s)] = float(loss)
    monkeypatch.delenv("DLROVER_IPC_DIR")
    facts, timings = chip_smoke.tpurun_phase(str(tmp_path / "work"), os.environ[NodeEnv.JOB_NAME],
                                             device="cpu", small=True, total_steps=steps,
                                             reference=reference, timeout=120)
    assert facts["restored_step"] >= chip_smoke.TPURUN_KILL_AFTER
    assert facts["restored_from"] in ("prefetch", "memory")
    assert facts["max_loss_diff"] <= chip_smoke.TPURUN_LOSS_TOL
    assert set(facts["redone_steps"]) <= {facts["restored_step"] + 1}
    rec = timings["recovery"]
    assert rec["total_s"] == pytest.approx(rec["detect_s"] + rec["breakpoint_persist_s"]
                                           + rec["respawn_s"] + rec["restore_s"]
                                           + rec["first_step_s"])
    assert 0 <= rec["detect_s"] < 10
    assert facts["how"] == rec["how"] == "warm" and timings["warm_spare"]
    assert facts["pids"]["worker1"] in facts["spares"]  # the adopted spare
    assert all(not s["nvidia_fds"] and s["samples"] > 0 for s in timings["spares"])
    assert set(rec["first_step_split"]) >= {"forward_s", "backward_s", "optimizer_s",
                                            "loss_fetch_s", "stage_s"}
    assert 0 <= rec["spare"]["contract_to_script_s"] < rec["spare"]["spare_age_s"]
