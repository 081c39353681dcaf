"""The port's control plane against the JAX package's, on the CPU.

The same seeded scripts of rendezvous joins, dead-node removals and clock
advances, of node reports, KV operations and step reports, go through
``dlrover_tpu`` and ``dlrover_tpu_torch``; their state must be equal after
every event (exact equality: this is control-plane state). The wire codec
of each ported message must give the JAX msgpack round trip's fields, and
every RPC of the port's client must work against a live port master.
"""

import dataclasses
import os
import random
import socket
import subprocess
import sys
import time

import pytest

from dlrover_tpu.common import comm as jcomm
from dlrover_tpu.common import serialize as jserialize
from dlrover_tpu.master import job_context as jjob_context
from dlrover_tpu.master.kv_store import KVStoreService as JKVStore
from dlrover_tpu.master.monitor.perf_monitor import PerfMonitor as JPerfMonitor
from dlrover_tpu.master.node.job_manager import JobManager as JJobManager
from dlrover_tpu.master.rdzv.manager import ElasticTrainingRendezvousManager as JRdzv
from dlrover_tpu_torch.common import comm as tcomm
from dlrover_tpu_torch.common import serialize as tserialize
from dlrover_tpu_torch.common.constants import JobExitReason, JobStage, PreCheckStatus
from dlrover_tpu_torch.master import job_context as tjob_context
from dlrover_tpu_torch.master import main as tmaster_main
from dlrover_tpu_torch.master.args import parse_master_args
from dlrover_tpu_torch.master.kv_store import KVStoreService as TKVStore
from dlrover_tpu_torch.master.local_master import LocalJobMaster
from dlrover_tpu_torch.master.monitor.perf_monitor import PerfMonitor as TPerfMonitor
from dlrover_tpu_torch.master.node.job_manager import JobManager as TJobManager
from dlrover_tpu_torch.master.rdzv.manager import ElasticTrainingRendezvousManager as TRdzv
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.rpc.client import MasterClient

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t0=1_000_000.0):
        self.t = t0

    def __call__(self):
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    """One ``time.time`` for both packages: each reads the clock as
    ``time.time()``."""
    c = FakeClock()
    monkeypatch.setattr(time, "time", c)
    return c


def _meta(pkg, rank, slice_id=0, addr=""):
    return pkg.NodeMeta(node_id=rank, node_rank=rank, process_unit=1, slice_id=slice_id, addr=addr)


def _world(result):
    round_, group, world = result
    return round_, group, [(pid, dataclasses.asdict(m)) for pid, m in sorted(world.items())]


# -- rendezvous ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_rendezvous_scripts_match_the_jax_manager(seed, clock):
    rng = random.Random(seed)
    lo = rng.randint(1, 3)
    params = dict(min_nodes=lo, max_nodes=rng.randint(lo, 6), waiting_timeout=60.0,
                  node_unit=rng.randint(1, 3))
    managers = []
    for cls in (JRdzv, TRdzv):
        m = cls()
        m.update_rdzv_params(**params)
        m._lastcall_timeout = 1.0
        managers.append(m)
    (jm, tm), pkgs = managers, (jcomm, tcomm)
    for event in range(60):
        kind = rng.choice(["join", "join", "join", "remove", "tick", "world"])
        rank = rng.randrange(8)
        if kind == "join":
            slice_id = rng.randrange(2)
            got = [m.join_rendezvous(_meta(p, rank, slice_id, f"10.0.0.{rank}"))
                   for m, p in zip(managers, pkgs)]
        elif kind == "remove":
            got = [m.remove_alive_node(rank) for m in managers]
        elif kind == "tick":
            clock.t += rng.choice([0.3, 0.6, 1.2, 2.5])
            got = [None, None]
        else:
            got = [_world(m.get_comm_world(rank)) for m in managers]
        assert got[0] == got[1], (seed, event, kind)
        for m in managers:  # a poll can complete a round: poll both alike
            m.get_comm_world(0)
        assert _world(jm.get_comm_world(0)) == _world(tm.get_comm_world(0)), (seed, event)
        assert jm.num_nodes_waiting() == tm.num_nodes_waiting(), (seed, event)
        assert jm._rdzv_round == tm._rdzv_round and jm.world_size() == tm.world_size()


@pytest.fixture(params=["jax", "torch"])
def rdzv(request):
    return (JRdzv, jcomm) if request.param == "jax" else (TRdzv, tcomm)


class TestElasticTrainingRendezvous:
    """The named cases of tests/test_rdzv_manager.py, for both packages."""

    def _m(self, rdzv, lo, hi, unit=1):
        cls, pkg = rdzv
        m = cls()
        m.update_rdzv_params(min_nodes=lo, max_nodes=hi, waiting_timeout=60, node_unit=unit)
        return m, pkg

    def test_completes_at_max_nodes(self, rdzv):
        m, pkg = self._m(rdzv, 2, 3)
        for r in range(3):
            m.join_rendezvous(_meta(pkg, r, addr=f"10.0.0.{r}"))
        _, group, world = m.get_comm_world(0)
        assert len(world) == 3 and group == 0 and sorted(world) == [0, 1, 2]
        assert world[0].addr == "10.0.0.0"

    def test_incomplete_below_min(self, rdzv):
        m, pkg = self._m(rdzv, 2, 4)
        m.join_rendezvous(_meta(pkg, 0))
        assert m.get_comm_world(0)[2] == {}

    def test_lastcall_timeout_completes_at_min(self, rdzv, clock):
        m, pkg = self._m(rdzv, 2, 4)
        m._lastcall_timeout = 0.2
        for r in range(3):
            m.join_rendezvous(_meta(pkg, r))
        assert m.get_comm_world(0)[2] == {}
        clock.t += 0.3
        assert len(m.get_comm_world(0)[2]) == 3

    def test_node_unit_truncation(self, rdzv, clock):
        m, pkg = self._m(rdzv, 2, 8, unit=2)
        m._lastcall_timeout = 0.1
        for r in range(5):
            m.join_rendezvous(_meta(pkg, r))
        clock.t += 0.2
        assert len(m.get_comm_world(0)[2]) == 4
        assert m.num_nodes_waiting() == 0  # 1 < node_unit and not a member

    def test_waiting_triggers_on_rejoin(self, rdzv):
        m, pkg = self._m(rdzv, 1, 2, unit=2)
        m.join_rendezvous(_meta(pkg, 0))
        m.join_rendezvous(_meta(pkg, 1))
        assert len(m.get_comm_world(0)[2]) == 2
        m.join_rendezvous(_meta(pkg, 1))
        assert m.num_nodes_waiting() == 1

    def test_waiting_requires_node_unit_for_new_nodes(self, rdzv, clock):
        m, pkg = self._m(rdzv, 1, 8, unit=4)
        m._lastcall_timeout = 0.1
        for r in range(4):
            m.join_rendezvous(_meta(pkg, r))
        clock.t += 0.2
        assert len(m.get_comm_world(0)[2]) == 4
        m.join_rendezvous(_meta(pkg, 4))
        m.join_rendezvous(_meta(pkg, 5))
        assert m.num_nodes_waiting() == 0
        m.join_rendezvous(_meta(pkg, 6))
        m.join_rendezvous(_meta(pkg, 7))
        assert m.num_nodes_waiting() == 4

    def test_dead_node_removed_from_waiting(self, rdzv):
        m, pkg = self._m(rdzv, 3, 3)
        m.join_rendezvous(_meta(pkg, 0))
        m.join_rendezvous(_meta(pkg, 1))
        m.remove_alive_node(1)
        m.join_rendezvous(_meta(pkg, 2))
        assert m.get_comm_world(0)[2] == {}

    def test_topology_sort_groups_slices(self, rdzv):
        m, pkg = self._m(rdzv, 4, 4)
        for r, s in ((0, 1), (1, 0), (2, 1), (3, 0)):
            m.join_rendezvous(_meta(pkg, r, slice_id=s))
        world = m.get_comm_world(0)[2]
        assert [world[i].slice_id for i in range(4)] == [0, 0, 1, 1]

    def test_ckpt_sync(self, rdzv):
        m, pkg = self._m(rdzv, 2, 2)
        m.join_rendezvous(_meta(pkg, 0))
        m.join_rendezvous(_meta(pkg, 1))
        m.get_comm_world(0)
        assert not m.sync_ckpt_nodes(0, step=100)
        assert m.sync_ckpt_nodes(1, step=100)
        assert not m.sync_ckpt_nodes(0, step=200)
        assert not m.sync_ckpt_nodes(1, step=100)


# -- job manager, KV store, step monitor --------------------------------------


def _nodes(job_ctx):
    return {i: (n.status, n.exit_reason, n.relaunch_count, n.heartbeat_time)
            for i, n in sorted(job_ctx.get_nodes("worker").items())}


def _drain(job_ctx, n_nodes):
    out = [[(a.action_type, a.instance, a.config.get("reason")) for a in
            job_ctx.node_actions.drain_actions(i)] for i in range(n_nodes)]
    out.append(job_ctx.master_actions.next_action(-1).action_type)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_job_manager_reports_match_the_jax_job_manager(seed, clock):
    rng = random.Random(seed)
    n = rng.randint(1, 3)
    ctxs = [jjob_context.JobContext.reset(), tjob_context.JobContext.reset()]
    managers = [JJobManager(num_workers=n), TJobManager(num_workers=n)]
    for m in managers:
        m.start()
        m.stop()
    statuses = ["running", "running", "succeeded", "failed", "deleted", "breakdown", "pending"]
    reasons = ["", "", "relaunch_requested", "fatal_error", "oom", "killed"]
    try:
        for event in range(50):
            kind = rng.choice(["status", "status", "heartbeat", "failure", "check"])
            node = rng.randrange(n)
            status, reason = rng.choice(statuses), rng.choice(reasons)
            for m in managers:
                if kind == "status":
                    m.update_node_status(node, "worker", status, reason)
                elif kind == "heartbeat":
                    m.record_heartbeat(node, clock.t)
                elif kind == "failure":
                    m.handle_failure_report(node, "Traceback: boom", event % 4)
                else:
                    m._check_dead_nodes()
            if kind == "check":
                clock.t += 400.0  # two checks in a row pass the 600 s deadline
            assert _nodes(ctxs[0]) == _nodes(ctxs[1]), (seed, event, kind)
            assert managers[0].all_workers_exited() == managers[1].all_workers_exited()
            assert managers[0].all_workers_succeeded() == managers[1].all_workers_succeeded()
            assert _drain(ctxs[0], n) == _drain(ctxs[1], n), (seed, event, kind)
            assert [x.node_id for x in managers[0].alive_workers()] == \
                [x.node_id for x in managers[1].alive_workers()]
    finally:
        jjob_context.JobContext.reset()
        tjob_context.JobContext.reset()


@pytest.mark.parametrize("seed", range(4))
def test_kv_store_matches_the_jax_kv_store(seed):
    rng = random.Random(seed)
    stores = [JKVStore(), TKVStore()]
    keys = [f"k{i}" for i in range(5)]
    for event in range(80):
        kind = rng.choice(["set", "get", "add", "multi_get", "multi_set", "delete", "clear"])
        key, value, amount = rng.choice(keys), bytes([rng.randrange(256)] * 3), rng.randint(-2, 5)
        sub = rng.sample(keys, 3)
        clear = rng.random() < 0.3
        got = []
        for s in stores:
            if kind == "set":
                got.append(s.set(key, value))
            elif kind == "get":
                got.append(s.get(key))
            elif kind == "add":
                if s.get(key) and not s.get(key).lstrip(b"-").isdigit():
                    s.set(key, b"0")
                got.append(s.add(key, amount))
            elif kind == "multi_get":
                got.append(s.multi_get(sub))
            elif kind == "multi_set":
                got.append(s.multi_set({k: value for k in sub}))
            elif kind == "delete":
                got.append(s.delete(key))
            else:
                got.append(s.clear() if clear else None)
        assert got[0] == got[1], (seed, event, kind)
        assert stores[0].multi_get(keys) == stores[1].multi_get(keys)


@pytest.fixture(params=["jax", "torch"])
def perf_monitor(request):
    return JPerfMonitor if request.param == "jax" else TPerfMonitor


class TestGoodput:
    """The goodput cases of tests/test_master.py, for both packages."""

    def test_goodput_accounting(self, perf_monitor):
        mon = perf_monitor()
        t0 = mon._start_time
        for i in range(11):
            mon.collect_global_step(i, timestamp=t0 + i)
        assert mon._productive_s == pytest.approx(10.0)
        mon.collect_global_step(11, timestamp=t0 + 40)
        assert mon._productive_s == pytest.approx(11.0)
        for i in range(12, 15):
            mon.collect_global_step(i, timestamp=t0 + 40 + (i - 11))
        assert 0.2 < mon.goodput() < 0.5

    def test_goodput_first_interval_stall_capped(self, perf_monitor):
        import statistics

        mon = perf_monitor()
        t0 = mon._start_time
        mon.collect_global_step(1, timestamp=t0)
        mon.collect_global_step(2, timestamp=t0 + 3600)
        assert mon._productive_s <= 120.0
        for i in range(3, 10):
            mon.collect_global_step(i, timestamp=t0 + 3600 + (i - 2))
        assert statistics.median(mon._step_dts) < 5.0

    def test_goodput_backward_timestamp_clamped(self, perf_monitor):
        mon = perf_monitor()
        t0 = mon._start_time
        for i in range(5):
            mon.collect_global_step(i, timestamp=t0 + i)
        before = mon._productive_s
        mon.collect_global_step(5, timestamp=t0 - 50)
        mon.collect_global_step(6, timestamp=t0 + 5)
        assert mon._productive_s == pytest.approx(before + 1.0)


@pytest.mark.parametrize("seed", range(4))
def test_perf_monitor_matches_the_jax_perf_monitor(seed, clock):
    rng = random.Random(seed)
    mons = [JPerfMonitor(), TPerfMonitor()]
    step, ts = 0, clock.t
    for event in range(60):
        step += rng.choice([1, 1, 1, 2, 0, -1])
        ts += rng.choice([0.1, 0.1, 0.12, 0.5, 30.0, -5.0])
        clock.t = max(clock.t, ts) + 0.01
        for m in mons:
            m.collect_global_step(step, timestamp=ts)
        views = [(m._productive_s, m.goodput(), m.training_goodput(), m.steps_per_second(),
                  m.last_step()) for m in mons]
        assert views[0] == views[1], (seed, event)


# -- the wire ------------------------------------------------------------------

_PORTED = [name for name, cls in vars(tcomm).items()
           if dataclasses.is_dataclass(cls) and isinstance(cls, type)]


def _value(rng, typ, pkg):
    s = str(typ)
    if typ is int or s == "int":
        return rng.randint(-5, 1 << 40)
    if typ is float or s == "float":
        return rng.random() * 1e6
    if typ is bool or s == "bool":
        return rng.random() < 0.5
    if typ is bytes or s == "bytes":
        return bytes(rng.randrange(256) for _ in range(rng.randint(0, 40)))
    if typ is str or s == "str":
        return "".join(rng.choice("ab_ü{}\"\\:") for _ in range(rng.randint(0, 12)))
    if "Dict[int" in s and "NodeMeta" in s:
        return {rng.randint(0, 9): _instance(rng, pkg.NodeMeta, pkg) for _ in range(3)}
    if "List" in s and "DiagnosisActionMsg" in s:
        return [_instance(rng, pkg.DiagnosisActionMsg, pkg) for _ in range(2)]
    if "Dict[str, bytes]" in s:
        return {f"k{i}": bytes([i] * i) for i in range(3)}
    if "Dict[str, str]" in s:
        return {"_t": "spoof", "reason": "x"} if rng.random() < 0.5 else {"a": "b"}
    if "List[str]" in s:
        return ["x", "y", "_t"]
    raise AssertionError(f"no generator for {s}")


def _instance(rng, cls, pkg):
    return cls(**{f.name: _value(rng, f.type, pkg) for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("name", _PORTED)
def test_every_ported_message_round_trips_like_the_jax_codec(name):
    tcls, jcls = getattr(tcomm, name), getattr(jcomm, name)
    assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())  # same defaults
    for seed in range(5):
        jmsg = _instance(random.Random(seed), jcls, jcomm)
        tmsg = _instance(random.Random(seed), tcls, tcomm)
        jback = jserialize.loads(jserialize.dumps(jmsg))
        tback = tserialize.loads(tserialize.dumps(tmsg))
        assert type(tback) is tcls
        assert dataclasses.asdict(tback) == dataclasses.asdict(jback)
        # the wire is JSON text, not msgpack
        assert tserialize.dumps(tmsg).decode().startswith('{"_t":')


def test_codec_rejects_what_it_cannot_carry():
    with pytest.raises(TypeError):
        tserialize.dumps(object())
    with pytest.raises(TypeError):
        tserialize.dumps({(1, 2): "tuple key"})
    with pytest.raises(TypeError):
        tserialize.loads(b'{"_t": "NoSuchMessage"}')
    assert tserialize.loads(b"") is None
    assert tserialize.loads(tserialize.dumps((1, [2, b"3"]))) == [1, [2, b"3"]]


def test_servicer_answers_unknown_and_broken_messages_with_an_error():
    tjob_context.JobContext.reset()
    servicer = MasterServicer(job_manager=TJobManager(1), rdzv_managers={})
    for verb in (servicer.get, servicer.report):
        for body in (b"not json", tserialize.dumps(tcomm.BaseRequest(data=b"{}")),
                     tserialize.dumps(tcomm.BaseRequest(data=tserialize.dumps(
                         tcomm.NodeMeta())))):
            resp = tserialize.loads(verb(body))
            assert isinstance(resp, tcomm.BaseResponse) and not resp.success


# -- a live master ---------------------------------------------------------------


@pytest.fixture()
def live_master():
    m = LocalJobMaster(num_workers=2, fresh_context=True)
    m.prepare()
    yield m
    m.stop()


def test_every_rpc_works_over_a_live_port_master(live_master, monkeypatch):
    c0 = MasterClient(live_master.addr, node_id=0)
    c1 = MasterClient(live_master.addr, node_id=1)
    c0.kv_store_set("a", b"\x00\xff")
    assert c1.kv_store_get("a") == b"\x00\xff" and c1.kv_store_get("missing") == b""
    assert c0.kv_store_add("n", 2) == 2 and c1.kv_store_add("n", 3) == 5
    c0.kv_store_multi_set({"x": b"1", "y": b"2"})
    assert c1.kv_store_multi_get(["x", "y", "z"]) == {"x": b"1", "y": b"2"}
    assert c0.join_rendezvous(0, 1, "training") == 0
    assert c0.num_nodes_waiting("training") == 1
    assert c0.get_comm_world("training", 0).world == {}
    c1.join_rendezvous(1, 1, "training", node_ip="10.0.0.1")
    world = c1.get_comm_world("training", 1)
    assert world.round == 0 and sorted(world.world) == [0, 1]
    assert world.world[1].addr == "10.0.0.1"
    c0.report_node_status("running")
    c0.report_failure("Traceback: boom", restart_count=1)
    assert live_master._job_ctx.get_node("worker", 0).relaunch_count == 1
    assert c0.report_heartbeat() == []
    c0.report_node_status("failed", exit_reason="relaunch_requested")
    actions = c0.report_heartbeat()
    assert [a.config["action_type"] for a in actions] == ["relaunch_worker"]
    c1.report_training_step(10)
    c1.report_training_step(20)
    status = c1.get_job_status()
    assert (status.stage, status.last_step) == (JobStage.RUNNING, 20)
    assert status.steps_per_second > 0
    assert c0.get_pre_check_result().status == PreCheckStatus.PASSED
    live_master._job_ctx.elastic_run_config["node_unit"] = "2"
    assert c0.get_elastic_run_config() == {"node_unit": "2"}
    monkeypatch.setenv("DLROVER_MASTER_ADDR", live_master.addr)
    monkeypatch.setenv("DLROVER_NODE_ID", "1")
    MasterClient.reset_singleton()
    try:
        single = MasterClient.singleton()
        assert single is MasterClient.singleton() and single.node_id == 1
        assert single.kv_store_get("a") == b"\x00\xff"
    finally:
        MasterClient.reset_singleton()


def test_client_raises_within_its_deadline_when_the_server_never_answers():
    with socket.socket() as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(8)  # accepts connections in the kernel, never answers
        client = MasterClient(f"127.0.0.1:{srv.getsockname()[1]}", retries=2, deadline_s=0.3)
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="after 2 tries"):
            client.get_job_status()
        # two deadlines and one backoff of at most rpc_backoff_base_s
        assert time.monotonic() - t0 < 0.3 * 2 + 0.5 + 1.0


def test_grpc_transport_raises_not_ported():
    with pytest.raises(NotImplementedError, match="not ported"):
        MasterClient("127.0.0.1:1", service_type="grpc")
    with pytest.raises(NotImplementedError, match="not ported"):
        LocalJobMaster(service_type="grpc")


def test_master_main_writes_its_port_file_and_ends_with_the_job(tmp_path):
    port_file = tmp_path / "port"
    proc = subprocess.Popen([sys.executable, "-m", "dlrover_tpu_torch.master.main",
                             "--num_workers", "1", "--port_file", str(port_file)],
                            cwd=_REPO, env={**os.environ, "PYTHONPATH": _REPO},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 30
        while not (port_file.exists() and port_file.read_text()):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        client = MasterClient(f"127.0.0.1:{port_file.read_text()}", node_id=0)
        assert client.get_job_status().stage == JobStage.RUNNING
        client.report_node_status("running")
        client.report_node_status("succeeded")
        assert proc.wait(30) == 0  # the job ended: the master exits SUCCEEDED
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert "job master exiting: succeeded" in proc.stdout.read()


def test_master_exit_verdict_is_fatal_when_a_worker_fails_for_good():
    m = LocalJobMaster(num_workers=1, fresh_context=True)
    m.prepare()
    m.run_in_background()
    try:
        c = MasterClient(m.addr, node_id=0)
        c.report_node_status("running")
        c.report_node_status("failed", exit_reason="fatal_error")
        m._run_thread.join(10)
        assert m.exit_reason in (JobExitReason.FATAL_ERROR, JobExitReason.MAX_RELAUNCH)
    finally:
        m.stop()


def test_master_process_imports_no_torch():
    """The standalone master starts without torch (its import costs
    seconds of every job's cold start) and holds no CUDA context."""
    code = ("import sys, dlrover_tpu_torch.master.main\n"
            "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": _REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("argv", [["--platform", "k8s"], ["--max_workers", "4"],
                                  ["--pending_timeout", "5"], ["--brain_addr", "x:1"]])
def test_master_options_of_features_not_ported_raise(argv):
    with pytest.raises(NotImplementedError, match="not ported"):
        tmaster_main.run(parse_master_args(argv))
