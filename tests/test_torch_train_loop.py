"""The port's elastic train loop (dlrover_tpu_torch/trainer/) on the CPU,
against the JAX package on the same numpy inputs.

The slice as a whole: the port's ``ElasticTrainLoop`` drives the 2-layer
flash GPT (weights carried across from the JAX init with ``params_from_flax``)
and must give the per-step losses of the JAX ``build_train_step`` driven for
the same steps on the same batches, to 1e-5 relative as in
``tests/test_torch_train_step.py``. The JAX reference is the bare step, not
the JAX ``ElasticTrainLoop``, which adds no arithmetic (and whose thread mix
crashes this container's jaxlib with the compile cache warm, see
``tests/conftest.py``). A restart in the middle, from shm or from storage,
continues the same losses.
"""

import os
import threading
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.parallel import train_step as jts
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu.trainer.dataloader import ElasticDistributedSampler as JaxSampler
from dlrover_tpu.trainer.loop import gradient_accumulation_steps as jax_accum
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import multi_process as tmp
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models.params import params_from_flax
from dlrover_tpu_torch.parallel import train_step as tts
from dlrover_tpu_torch.trainer import elastic
from dlrover_tpu_torch.trainer.dataloader import ElasticDistributedSampler, PrefetchIterator, to_device
from dlrover_tpu_torch.trainer.loop import ElasticTrainLoop, gradient_accumulation_steps

torch.set_num_threads(2)

SMALL = dict(vocab_size=256, max_seq_len=32, num_layers=2, num_heads=4, head_dim=16,
             embed_dim=64, use_remat=False, attention_impl="flash")
STEPS = 6
LOSS_RTOL = 1e-5  # as tests/test_torch_train_step.py


@pytest.fixture(autouse=True)
def port_ipc(tmp_path, monkeypatch):
    """A unique job, the port's sockets under ``tmp_path``, no SIGTERM hook in
    the test process, and the job's shm segments unlinked afterwards."""
    job = f"tlp_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_JOB_NAME", job)
    monkeypatch.delenv("DLROVER_IPC_NAMESPACE", raising=False)
    monkeypatch.setattr(tmp, "SOCKET_TMP_DIR", str(tmp_path / "sockets"))
    monkeypatch.setattr(AsyncCheckpointSaver, "_signals_installed", True)
    AsyncCheckpointSaver.reset()
    yield job
    AsyncCheckpointSaver.shutdown()
    for name in os.listdir("/dev/shm"):
        if name.startswith(f"dlrover_{job}"):
            os.unlink(os.path.join("/dev/shm", name))


def _numpy_batches(start, stop):
    for s in range(start, stop):
        t = np.random.default_rng(100 + s).integers(0, SMALL["vocab_size"], (4, 33)).astype(np.int32)
        yield t[:, :-1], t[:, 1:]


def _torch_batches(start, stop=STEPS):
    for x, y in _numpy_batches(start, stop):
        yield torch.from_numpy(x).long(), torch.from_numpy(y).long()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's initial parameters and per-step losses."""
    model = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **SMALL))
    tx = jts.default_optimizer(learning_rate=1e-2, warmup_steps=2)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    x0, _ = next(_numpy_batches(0, 1))
    state, shardings = jts.init_train_state(model, jnp.asarray(x0), mesh, tx)
    params0 = params_from_flax(jax.tree.map(np.asarray, state.params))
    step = jts.build_train_step(model, tx, jgpt.cross_entropy_loss, mesh, shardings, donate=False)
    losses = []
    for x, y in _numpy_batches(0, STEPS):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return params0, losses


def _port_loop(tmp_path, max_steps, params0=None, seed=0, storage_every=2, **kw):
    model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **SMALL), device="cpu")
    tx = tts.default_optimizer(learning_rate=1e-2, warmup_steps=2)
    state = tts.init_train_state(model, torch.zeros((4, 32), dtype=torch.long), tx,
                                 device="cpu", seed=seed)
    if params0 is not None:
        model.load_state_dict(params0)
    engine = CheckpointEngine(str(tmp_path / "ckpt"), standalone=True)
    losses = {}
    loop = ElasticTrainLoop(engine, tts.build_train_step(model, tx, tgpt.cross_entropy_loss),
                            max_steps=max_steps, memory_every=1, storage_every=storage_every,
                            on_step=lambda s, loss: losses.__setitem__(s, float(loss)), **kw)
    return loop, engine, state, losses


def test_elastic_loop_matches_the_jax_step(tmp_path, jax_run):
    params0, jax_losses = jax_run
    loop, engine, state, losses = _port_loop(tmp_path, STEPS, params0)
    try:
        state = loop.run(state, data_factory=_torch_batches)
        assert sorted(losses) == list(range(STEPS))
        np.testing.assert_allclose([losses[s] for s in range(STEPS)], jax_losses, rtol=LOSS_RTOL)
        assert state.step == STEPS and state.opt_state.count == STEPS
        assert engine.shm.read_meta().step == STEPS - 1  # the final state is staged
        assert engine.storage.latest_step() == 4
        assert loop.last_first_step_s > 0 and loop.last_compile_s is not None
    finally:
        engine.close()


@pytest.mark.parametrize("rung", ["memory", "storage"])
def test_restart_in_the_middle_continues_the_same_losses(tmp_path, jax_run, rung):
    params0, jax_losses = jax_run
    loop, engine, state, _ = _port_loop(tmp_path, 3, params0)
    # step 2 persists only if step 1's stage and step 0's persist are done
    # (a busy persister skips the save); on a loaded box they may not be
    loop.on_step = lambda s, loss: s != 1 or (engine.wait_staged(60) and engine.wait_saving(60))
    loop.run(state, data_factory=_torch_batches)
    assert engine.storage.latest_step() == 2
    engine.close()
    if rung == "storage":
        from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

        SharedMemoryHandler(0).unlink()  # the host lost its memory: storage step 2
    # a new process: other initial weights, restored in place
    loop, engine, state, losses = _port_loop(tmp_path, STEPS, seed=7)
    try:
        loop.run(state, data_factory=_torch_batches)
        assert loop.start_step == 3
        assert engine.restored_from == ("storage" if rung == "storage" else "prefetch")
        assert sorted(losses) == [3, 4, 5]
        np.testing.assert_allclose([losses[s] for s in (3, 4, 5)], jax_losses[3:], rtol=LOSS_RTOL)
    finally:
        engine.close()


def test_request_stop_stages_the_last_step(tmp_path):
    holder = {}

    def on_step(step, loss):
        if step == 1:
            holder["loop"].request_stop()

    loop, engine, state, _ = _port_loop(tmp_path, STEPS, storage_every=0)
    loop.on_step = on_step
    holder["loop"] = loop
    try:
        state = loop.run(state, data_factory=_torch_batches)
        assert loop.stop_requested and state.step == 2
        assert engine.shm.read_meta().step == 1
        assert engine.storage.latest_step() is None  # storage_every=0: no persist
    finally:
        engine.close()


def test_resume_at_max_steps_draws_nothing(tmp_path):
    loop, engine, state, _ = _port_loop(tmp_path, 2)
    loop.run(state, data_factory=_torch_batches)
    engine.close()
    draws = []

    def counted(start):
        for batch in _torch_batches(start):
            draws.append(start)
            yield batch

    loop, engine, state, losses = _port_loop(tmp_path, 2)
    try:
        loop.run(state, data_factory=counted)
        assert loop.start_step == 2 and not draws and not losses
    finally:
        engine.close()


@pytest.mark.parametrize("option", ["device_monitor", "trace_host", "soft_remesh", "compile_ahead",
                                    "replanner", "native_step_marks"])
def test_loop_options_not_ported_yet_raise(option, monkeypatch):
    kwargs = {"device_monitor": {"device_monitor": True}, "trace_host": {"trace_host": True},
              "soft_remesh": {"soft_remesh": True}, "compile_ahead": {"compile_ahead": object()},
              "replanner": {"replanner": object()}}.get(option, {})
    if option == "native_step_marks":
        monkeypatch.setenv("DLROVER_TT_PORT", "1234")
    with pytest.raises(NotImplementedError, match="not ported"):
        ElasticTrainLoop(engine=None, step_fn=None, **kwargs)


@pytest.mark.parametrize("max_workers,current", [
    (8, 8), (8, 4), (8, 2), (8, 3), (8, 0), (4, 8), (6, 4), (1, 1), (16, 5), (12, 7),
])
def test_gradient_accumulation_steps_matches_jax(max_workers, current):
    assert gradient_accumulation_steps(max_workers, current) == jax_accum(max_workers, current)


@pytest.mark.parametrize("size,replicas,rank,shuffle,seed,epoch,consumed,drop_last", [
    (10, 1, 0, True, 0, 0, 0, False),
    (10, 3, 1, True, 7, 2, 0, False),
    (10, 3, 2, False, 0, 0, 3, False),
    (11, 4, 3, True, 1, 1, 4, True),
    (17, 5, 0, True, 3, 0, 10, False),
    (17, 5, 4, False, 0, 0, 0, True),
    (100, 8, 5, True, 42, 3, 16, False),
    (7, 8, 7, True, 0, 0, 0, False),
    (64, 2, 1, True, 5, 9, 33, True),
    (1, 1, 0, False, 0, 0, 0, False),
])
def test_sampler_matches_jax(size, replicas, rank, shuffle, seed, epoch, consumed, drop_last):
    ours = ElasticDistributedSampler(size, replicas, rank, shuffle=shuffle, seed=seed, drop_last=drop_last)
    theirs = JaxSampler(size, replicas, rank, shuffle=shuffle, seed=seed, drop_last=drop_last)
    for s in (ours, theirs):
        s.set_epoch(epoch)
        s.load_state_dict({"epoch": epoch, "completed_num": consumed})
    assert len(ours) == len(theirs)
    assert list(ours) == list(theirs)
    assert ours.state_dict() == theirs.state_dict()
    # a re-meshed world resumes at the same position in both
    ours2 = ElasticDistributedSampler(size, max(1, replicas - 1), 0, shuffle=shuffle, seed=seed)
    theirs2 = JaxSampler(size, max(1, replicas - 1), 0, shuffle=shuffle, seed=seed)
    ours2.load_state_dict(ours.state_dict())
    theirs2.load_state_dict(theirs.state_dict())
    assert list(ours2) == list(theirs2)


def test_prefetch_keeps_order_and_starts_lazily():
    drawn = []

    def source():
        for i in range(5):
            drawn.append(i)
            yield (torch.full((2,), i),)

    it = PrefetchIterator(source(), stage_fn=to_device("cpu"))
    time.sleep(0.05)
    assert drawn == []  # nothing drawn before the first next()
    assert [int(b[0][0]) for b in it] == [0, 1, 2, 3, 4]
    it.close()


def test_prefetch_reraises_the_sources_error():
    def source():
        yield (torch.zeros(1),)
        raise ValueError("broken shard")

    it = PrefetchIterator(source())
    next(it)
    with pytest.raises(ValueError, match="broken shard"):
        next(it)
    it.close()


def test_prefetch_draw_is_bounded():
    release = threading.Event()

    def source():
        release.wait(10.0)
        yield (torch.zeros(1),)

    it = PrefetchIterator(source(), timeout=0.3)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        next(it)
    assert time.monotonic() - t0 < 5
    release.set()
    it.close()


def test_elastic_context_from_env(monkeypatch):
    monkeypatch.setenv("DLROVER_NODE_RANK", "3")
    monkeypatch.setenv("DLROVER_RESTART_COUNT", "2")
    monkeypatch.setenv("DLROVER_JOB_NAME", "job_x")
    monkeypatch.delenv("DLROVER_MASTER_ADDR", raising=False)
    ctx = elastic.ElasticContext.from_env()
    assert (ctx.node_rank, ctx.restart_count, ctx.job_name) == (3, 2, "job_x")
    assert ctx.is_coordinator and ctx.client is None and ctx.world_device_count() >= 1
    ctx.start_step_timer()
    ctx.report_step(5)  # no master: a no-op that drops the timer
    assert ctx._step_t0 == 0.0
    ctx.initialize()


def test_elastic_context_features_not_ported_yet_raise(monkeypatch):
    from dlrover_tpu_torch.rpc.client import MasterClient

    with pytest.raises(NotImplementedError, match="not ported"):
        elastic.ElasticContext(num_processes=2).initialize()
    # the master client is ported over HTTP; the gRPC transport is not
    monkeypatch.setenv("DLROVER_MASTER_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("DLROVER_MASTER_SERVICE_TYPE", "grpc")
    MasterClient.reset_singleton()
    try:
        ctx = elastic.ElasticContext(master_addr="127.0.0.1:1")
        with pytest.raises(NotImplementedError, match="not ported"):
            ctx.client  # noqa: B018
        with pytest.raises(NotImplementedError, match="not ported"):
            ctx.report_step(1)
    finally:
        MasterClient.reset_singleton()
