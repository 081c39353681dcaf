"""The port's flash checkpoint (dlrover_tpu_torch/checkpoint/ and
common/multi_process.py) on the CPU: its images and storage layout against
the JAX package's readers and writers, the engine's behaviour against the
JAX package's own checkpoint tests, restore into the model's own tensors,
bounded IPC waits, and two real trainer processes, one SIGKILLed after
staging and one resuming from shared memory.

Byte comparisons are exact: both packages move the same bytes.
"""

import collections
import os
import queue
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.checkpoint import shm_handler as tshm
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.meta import CheckpointMeta
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint.storage import PosixCheckpointStorage
from dlrover_tpu_torch.common import multi_process as tmp
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.models import gpt
from dlrover_tpu_torch.parallel import train_step as tts

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=256, max_seq_len=32, num_layers=2, num_heads=4, head_dim=16,
             embed_dim=64, use_remat=False, attention_impl="flash")


@pytest.fixture(autouse=True)
def port_ipc(tmp_path, monkeypatch):
    """A unique job, the port's sockets under ``tmp_path``, no SIGTERM hook in
    the test process, and the job's shm segments unlinked afterwards."""
    job = f"tck_{os.getpid()}_{uuid.uuid4().hex[:8]}"
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


def _engine(tmp_path, **kw):
    return CheckpointEngine(str(tmp_path / "ckpt"), standalone=True, **kw)


def _small_state(seed=0):
    model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **SMALL), device="cpu")
    tx = tts.default_optimizer(learning_rate=1e-2, warmup_steps=2)
    state = tts.init_train_state(model, torch.zeros((2, 32), dtype=torch.long), tx,
                                 device="cpu", seed=seed)
    return model, tx, state


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _tree_equal(a, b):
    fa, fb = tshm.flatten_with_path(a), tshm.flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and _bytes(x) == _bytes(y), path
        else:
            assert x == y and type(x) is type(y), path


def _w(value, n=4):
    return {"w": torch.full((n,), float(value))}


def _zeros(n=4):
    return {"w": torch.zeros(n)}


# -- format parity with the JAX package ----------------------------------------

Pair = collections.namedtuple("Pair", ["first", "second"])


def test_paths_match_jax_tree_flatten_with_path():
    import jax

    from dlrover_tpu.checkpoint.shm_handler import _path_str

    tree = {"z": Pair(first=np.ones(2), second=[np.zeros(1), (np.ones(3), None)]),
            "a": {"k2": np.ones(1), "k1": 5}, "step": 3}
    ours = [p for p, _ in tshm.flatten_with_path(tree)]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert ours == [_path_str(path) for path, _ in flat]
    _, _, state = _small_state()
    paths = [p for p, _ in tshm.flatten_with_path(state)]
    assert paths[0] == "step" and "params/wte" in paths
    assert "opt_state/mu/blocks.0.attn.wqkv" in paths and "opt_state/count" in paths


def _mixed_tree():
    g = torch.Generator().manual_seed(1)
    return {"h": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "f": torch.randn(7, generator=g), "i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": torch.tensor([True, False, True]), "n": 11, "x": 2.5}


@pytest.mark.parametrize("which", ["train_state", "mixed_dtypes"])
def test_jax_reads_the_ports_shm_image(which):
    from dlrover_tpu.checkpoint.meta import CheckpointMeta as JaxMeta
    from dlrover_tpu.checkpoint.shm_handler import SharedMemoryHandler as JaxShm

    tree = _small_state()[2] if which == "train_state" else _mixed_tree()
    ours = tshm.SharedMemoryHandler(0)
    meta = ours.save_pytree(4, tree, extra={"note": "port"})
    got_meta, arrays = JaxShm(0).load_pytree_host()
    assert got_meta.step == 4 and got_meta.extra == {"note": "port"}
    assert JaxMeta.from_json(meta.to_json()).to_json() == meta.to_json()
    leaves = dict(tshm.flatten_with_path(tree))
    assert set(arrays) == set(leaves)
    for path, leaf in leaves.items():
        expect = tshm.leaf_tensor(leaf)
        assert str(arrays[path].dtype) == tshm.dtype_name(expect.dtype), path
        assert list(arrays[path].shape) == list(expect.shape), path
        assert arrays[path].tobytes() == _bytes(expect), path


def test_port_reads_a_jax_shm_image():
    import ml_dtypes

    from dlrover_tpu.checkpoint.shm_handler import SharedMemoryHandler as JaxShm

    r = np.random.default_rng(2)
    tree = {"a": r.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": np.int64(7), "h": r.standard_normal(5).astype(ml_dtypes.bfloat16)},
            "l": [np.arange(3, dtype=np.int32), np.float64(1.5)]}
    JaxShm(0, name="from_jax").save_pytree(step=9, pytree=tree)
    meta, arrays = tshm.SharedMemoryHandler(0, name="from_jax").load_pytree_host()
    assert meta.step == 9
    assert arrays["b/h"].dtype == torch.bfloat16
    for path, leaf in (("a", tree["a"]), ("b/c", tree["b"]["c"]), ("b/h", tree["b"]["h"]),
                       ("l/0", tree["l"][0]), ("l/1", tree["l"][1])):
        assert _bytes(arrays[path]) == np.asarray(leaf).tobytes(), path
        assert list(arrays[path].shape) == list(np.shape(leaf)), path


def test_jax_storage_reads_a_step_the_port_persisted(tmp_path):
    from dlrover_tpu.checkpoint.storage import PosixCheckpointStorage as JaxStorage

    _, _, state = _small_state()
    engine = _engine(tmp_path)
    try:
        assert engine.save_to_storage(6, state)
        assert engine.wait_saving(timeout=30)
    finally:
        engine.close()
    jax_storage = JaxStorage(str(tmp_path / "ckpt"))
    assert jax_storage.latest_step() == 6
    arrays = jax_storage.load_step_host(6)
    for path, leaf in tshm.flatten_with_path(state):
        assert arrays[path].tobytes() == _bytes(tshm.leaf_tensor(leaf)), path


def test_port_storage_reads_a_step_jax_persisted(tmp_path):
    from dlrover_tpu.checkpoint.shm_handler import SharedMemoryHandler as JaxShm
    from dlrover_tpu.checkpoint.storage import PosixCheckpointStorage as JaxStorage

    tree = {"w": np.arange(10, dtype=np.float32), "step": np.int64(3)}
    jax_shm = JaxShm(0, name="jax_persist")
    meta = jax_shm.save_pytree(step=3, pytree=tree)
    jax_storage = JaxStorage(str(tmp_path / "jx"))
    jax_storage.write_shard(meta, jax_shm.payload_reader())
    assert jax_storage.commit(3, 1)
    jax_shm.unlink()
    ours = PosixCheckpointStorage(str(tmp_path / "jx"))
    assert ours.latest_step() == 3
    arrays = ours.load_step_host(3)
    assert _bytes(arrays["w"]) == tree["w"].tobytes() and int(arrays["step"]) == 3


# -- storage ------------------------------------------------------------------


def test_done_protocol_and_tracker(tmp_path):
    storage = PosixCheckpointStorage(str(tmp_path))
    storage.write_shard(CheckpointMeta(step=5, host_rank=0, num_hosts=2), b"payload0")
    assert not storage.commit(5, num_shards=2)  # shard 1 missing
    assert storage.latest_step() is None
    storage.write_shard(CheckpointMeta(step=5, host_rank=1, num_hosts=2), b"payload1")
    assert storage.commit(5, num_shards=2)
    assert storage.latest_step() == 5 and storage.committed(5)


def test_retention_by_commit_recency_and_stale_partials(tmp_path):
    storage = PosixCheckpointStorage(str(tmp_path / "ckpt"))

    def commit(step):
        storage.write_shard(CheckpointMeta(step=step), b"x")
        assert storage.commit(step, 1)

    for step in (1, 2, 3):
        commit(step)
    storage.keep_latest(2)
    assert storage.list_steps() == [2, 3]
    for old in (500, 501):
        commit(old)
    time.sleep(0.05)
    commit(4)  # a new run's low step, committed last, survives
    storage.keep_latest(2)
    assert 4 in storage.list_steps() and 500 not in storage.list_steps()
    os.makedirs(storage.step_dir(77))
    old_time = time.time() - storage.STALE_PARTIAL_GRACE_S - 10
    os.utime(storage.step_dir(77), (old_time, old_time))
    os.makedirs(storage.step_dir(78))  # fresh: may be in flight
    storage.keep_latest(2)
    assert not os.path.isdir(storage.step_dir(77)) and os.path.isdir(storage.step_dir(78))


# -- engine (mirrors tests/test_checkpoint.py) -------------------------------------


def test_save_load_memory_and_storage(tmp_path):
    engine = _engine(tmp_path)
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4), "step": 3}
    try:
        assert engine.save_to_storage(3, tree)
        assert engine.wait_saving(timeout=30)
        template = {"w": torch.zeros(4, 4), "step": 0}
        step, restored = engine.load(template)
        assert step == 3 and engine.restored_from in ("prefetch", "memory")
        _tree_equal(tree, restored)
        engine.shm.unlink()  # storage fallback
        template = {"w": torch.zeros(4, 4), "step": 0}
        step, restored = engine.load(template)
        assert step == 3 and engine.restored_from == "storage"
        _tree_equal(tree, restored)
    finally:
        engine.close()


def test_async_stage_save_and_load(tmp_path):
    engine = _engine(tmp_path)
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    try:
        assert engine.save_to_memory(5, tree, block=False)
        assert engine.wait_staged(timeout=30)
        step, restored = engine.load({"w": torch.zeros(8, 8)})
        assert step == 5
        _tree_equal(tree, restored)
    finally:
        engine.close()


def test_async_stage_survives_an_in_place_update(tmp_path, monkeypatch):
    """The snapshot is taken when the save is queued: the train step's
    in-place update right after must not reach the staged image (the
    donation hazard of the JAX engine)."""
    engine = _engine(tmp_path)
    release = threading.Event()
    real_save = engine.shm.write_image

    def slow_save(*a, **kw):
        release.wait(30.0)
        return real_save(*a, **kw)

    monkeypatch.setattr(engine.shm, "write_image", slow_save)
    w = torch.arange(1024, dtype=torch.float32)
    expect = w.clone()
    try:
        assert engine.save_to_memory(1, {"w": w}, block=False)
        w.mul_(-3.0)  # the next step's update, while staging waits
        release.set()
        assert engine.wait_staged(timeout=30)
        step, restored = engine.load({"w": torch.zeros(1024)})
        assert step == 1 and torch.equal(restored["w"], expect)
    finally:
        release.set()
        engine.close()


def test_async_stage_of_a_train_state_restores_every_leaf(tmp_path):
    """The staging thread writes the tensors and the step counters of the
    state as it was when the save was queued."""
    _, _, state = _small_state(seed=4)
    state = state._replace(step=11, opt_state=state.opt_state._replace(count=11))
    expect = tshm.map_with_path(state, lambda p, x: x.clone() if isinstance(x, torch.Tensor) else x)
    engine = _engine(tmp_path, prefetch_restore=False)
    try:
        assert engine.save_to_memory(11, state, block=False)
        with torch.no_grad():
            for t in state.params.values():
                t.add_(1.0)  # the next step's update
        assert engine.wait_staged(timeout=30)
        _, _, template = _small_state(seed=5)
        step, restored = engine.load(template)
        assert step == 11 and engine.restored_from == "memory"
        _tree_equal(expect, restored)
    finally:
        engine.close()


def test_async_stage_keeps_its_buffers_while_the_structure_holds(tmp_path):
    engine = _engine(tmp_path, prefetch_restore=False)
    try:
        for step in (1, 2):
            assert engine.save_to_memory(step, {"w": torch.full((8,), float(step)), "n": step}, block=False)
            assert engine.wait_staged(timeout=30)
            if step == 1:
                bufs, views = engine._snap_bufs, engine._snap_host[2]
        assert engine._snap_bufs is bufs and engine._snap_host[2] is views
        step, restored = engine.load({"w": torch.zeros(8), "n": 0})
        assert step == 2 and restored["n"] == 2 and torch.equal(restored["w"], torch.full((8,), 2.0))
        # another structure: new buffers, and the image is still right
        tree = {"w": torch.arange(5, dtype=torch.float64), "v": torch.ones(2, dtype=torch.bfloat16)}
        assert engine.save_to_memory(3, tree, block=False) and engine.wait_staged(timeout=30)
        assert engine._snap_bufs is not bufs
        step, restored = engine.load({"w": torch.zeros(5, dtype=torch.float64),
                                      "v": torch.zeros(2, dtype=torch.bfloat16)})
        assert step == 3
        _tree_equal(tree, restored)
    finally:
        engine.close()


def test_async_stage_in_flight_skips_next_save(tmp_path, monkeypatch):
    engine = _engine(tmp_path)
    release = threading.Event()
    real_save = engine.shm.write_image

    def slow_save(*a, **kw):
        release.wait(30.0)
        return real_save(*a, **kw)

    monkeypatch.setattr(engine.shm, "write_image", slow_save)
    tree = {"w": torch.ones(64)}
    try:
        assert engine.save_to_memory(1, tree, block=False)
        assert engine.staging_in_flight
        assert not engine.save_to_memory(2, tree, block=False)
        assert not engine.save_to_memory(2, tree, block=True)
        release.set()
        assert engine.wait_staged(timeout=30)
        assert engine.load({"w": torch.zeros(64)})[0] == 1
        monkeypatch.setattr(engine.shm, "write_image", real_save)
        assert engine.save_to_memory(3, tree, block=True)
    finally:
        release.set()
        engine.close()


def test_async_stage_failure_is_sticky_and_recovers(tmp_path, monkeypatch):
    engine = _engine(tmp_path)
    tree = {"w": torch.ones(64)}

    def boom(*a, **kw):
        raise RuntimeError("stage boom")

    real_save = engine.shm.write_image
    monkeypatch.setattr(engine.shm, "write_image", boom)
    # the SAVE events the saver has handled: its copy out of shm holds the
    # shard lock, and a stage that meets it is skipped by design
    saver, handled = _saver(), []
    real_snapshot = saver._snapshot_or_record
    monkeypatch.setattr(saver, "_snapshot_or_record",
                        lambda step: (real_snapshot(step), handled.append(step))[0])
    try:
        assert engine.save_to_storage(5, tree, block=False)
        assert not engine.wait_staged(timeout=30)
        assert engine.stage_failures == 1
        t0 = time.monotonic()
        assert not engine.wait_saving(timeout=30)  # fails fast on the marker
        assert time.monotonic() - t0 < 20
        assert _wait(lambda: handled == [5])
        monkeypatch.setattr(engine.shm, "write_image", real_save)
        engine.storage.clear_persist_error(engine.host_rank)
        assert engine.save_to_memory(6, tree, block=False)
        assert engine.wait_staged(timeout=30)
    finally:
        engine.close()


def test_async_snapshot_out_of_memory_degrades_to_blocking(tmp_path, monkeypatch):
    engine = _engine(tmp_path)

    def oom(pytree):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (induced)")

    monkeypatch.setattr(engine, "_snapshot", oom)
    try:
        assert engine.save_to_memory(2, _w(2.0), block=False)  # staged blocking
        assert engine.shm.read_meta().step == 2 and not engine.staging_in_flight
        assert engine.save_to_memory(3, _w(3.0), block=False)
        assert engine.load(_zeros())[0] == 3
    finally:
        engine.close()


def test_async_stage_storage_persists_behind_lock(tmp_path):
    engine = _engine(tmp_path)
    tree = {"w": torch.full((32, 32), 7.0)}
    try:
        assert engine.save_to_storage(9, tree, block=False)
        assert engine.wait_staged(timeout=30)
        assert engine.wait_saving(timeout=30)
        engine.shm.unlink()
        step, restored = engine.load({"w": torch.zeros(32, 32)})
        assert step == 9 and engine.restored_from == "storage"
        _tree_equal(tree, restored)
    finally:
        engine.close()


def test_wait_saving_fails_fast_on_persist_error(tmp_path):
    engine = _engine(tmp_path)
    saver = AsyncCheckpointSaver.get_or_create(storage_root=str(tmp_path / "ckpt"))

    def broken_write(meta, payload):
        raise OSError("disk full (induced)")

    real_write = saver.storage.write_shard
    saver.storage.write_shard = broken_write
    try:
        t0 = time.monotonic()
        assert engine.save_to_storage(1, _w(1.0))
        assert not engine.wait_saving(timeout=60)
        assert time.monotonic() - t0 < 30
        err = engine.storage.persist_error(0)
        assert err is not None and "disk full" in err[1]
    finally:
        saver.storage.write_shard = real_write
        engine.shm.unlink()
        engine.close()
    engine2 = _engine(tmp_path)  # a later successful persist clears the marker
    try:
        assert engine2.save_to_storage(2, _w(2.0))
        assert engine2.wait_saving(timeout=30)
        assert engine2.storage.persist_error(0) is None
    finally:
        engine2.close()


def test_wait_saving_step_zero(tmp_path):
    engine = _engine(tmp_path)
    try:
        assert engine.save_to_storage(0, _w(0.0))
        t0 = time.monotonic()
        assert engine.wait_saving(timeout=30)
        assert time.monotonic() - t0 < 20
    finally:
        engine.close()


def test_stale_persist_error_cleared_on_new_engine(tmp_path):
    PosixCheckpointStorage(str(tmp_path / "ckpt")).record_persist_error(0, 100, "disk full (old run)")
    engine = _engine(tmp_path)
    try:
        assert engine.storage.persist_error(0) is None
        assert engine.save_to_storage(60, _w(60.0))
        assert engine.wait_saving(timeout=30)
    finally:
        engine.close()


def test_storage_retention_prunes_old_steps(tmp_path, monkeypatch):
    monkeypatch.setattr(get_context(), "ckpt_keep_latest", 2)
    engine = _engine(tmp_path)
    try:
        for step in (1, 2, 3, 4):
            assert engine.save_to_storage(step, _w(step))
            assert engine.wait_saving(timeout=30)
        deadline = time.monotonic() + 15  # the saver prunes right after the commit
        while engine.storage.list_steps() != [3, 4] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert engine.storage.list_steps() == [3, 4]
        assert engine.storage.latest_step() == 4
    finally:
        engine.close()


def test_load_consistent_reloads_common_storage_step(tmp_path, monkeypatch):
    engine = _engine(tmp_path)
    try:
        assert engine.save_to_storage(3, _w(3.0))
        assert engine.wait_saving(timeout=30)
        assert engine.save_to_memory(5, _w(5.0))
        # "another process" staged only step 3; both committed step 3
        monkeypatch.setattr(engine, "_gather_restore_meta",
                            lambda m, s, c: ([m, 3], [s, 3], [set(c), {3}]))
        step, restored = engine.load_consistent(_zeros())
        assert step == 3 and torch.equal(restored["w"], torch.full((4,), 3.0))
    finally:
        engine.close()


def test_load_consistent_survives_pruned_tracker_step(tmp_path, monkeypatch):
    engine = _engine(tmp_path)
    try:
        for s in (4, 6, 8):
            assert engine.save_to_storage(s, _w(s))
            assert engine.wait_saving(timeout=30)
        monkeypatch.setattr(engine, "_gather_restore_meta",
                            lambda m, s, c: ([-1, -1], [s, 4], [set(c), {2, 4}]))
        step, restored = engine.load_consistent(_zeros())
        assert step == 4 and torch.equal(restored["w"], torch.full((4,), 4.0))
        # disjoint histories: a consistent fresh start
        monkeypatch.setattr(engine, "_gather_restore_meta",
                            lambda m, s, c: ([-1, -1], [s, 3], [set(c), {1, 3}]))
        assert engine.load_consistent(_zeros()) == (-1, None)
    finally:
        engine.close()


def test_load_consistent_stale_high_step_capped_by_tracker(tmp_path, monkeypatch):
    engine = _engine(tmp_path)
    try:
        assert engine.save_to_storage(900, _w(900.0))
        assert engine.wait_saving(timeout=30)
        assert engine.save_to_storage(7, _w(7.0))
        deadline = time.monotonic() + 30
        while not (engine.storage.committed(7) and engine.storage.latest_step() == 7):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        monkeypatch.setattr(engine, "_gather_restore_meta", lambda m, s, c: ([-1], [s], [set(c)]))
        step, restored = engine.load_consistent(_zeros())
        assert step == 7 and torch.equal(restored["w"], torch.full((4,), 7.0))
    finally:
        engine.close()


def test_load_consistent_agreement_keeps_memory_restore(tmp_path):
    engine = _engine(tmp_path, prefetch_restore=False)
    try:
        assert engine.save_to_memory(8, _w(8.0))
        step, restored = engine.load_consistent(_zeros())
        assert step == 8 and engine.restored_from == "memory"
        assert torch.equal(restored["w"], torch.full((4,), 8.0))
    finally:
        engine.close()


def test_prefetch_restores_what_a_previous_engine_staged(tmp_path):
    first = _engine(tmp_path)
    assert first.save_to_memory(12, _w(12.0))
    first.close()
    second = _engine(tmp_path)
    try:
        step, restored = second.load_consistent(_zeros())
        assert step == 12 and second.prefetch_used and second.restored_from == "prefetch"
        assert torch.equal(restored["w"], torch.full((4,), 12.0))
    finally:
        second.close()


def test_breakpoint_save(tmp_path):
    engine = _engine(tmp_path)
    try:
        assert engine.save_to_memory(21, {"w": torch.ones(8, 8)})
        saver = AsyncCheckpointSaver._instance
        assert saver is not None and saver.save_shm_to_storage()
        assert engine.storage.latest_step() == 21
    finally:
        engine.close()


# -- the persist off the shard lock -----------------------------------------


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _saver():
    """The in-process saver, once its runner has built it (the engine's
    shard lock can come up a moment before the instance is published)."""
    deadline = time.monotonic() + 30
    while AsyncCheckpointSaver._instance is None and time.monotonic() < deadline:
        time.sleep(0.01)
    return AsyncCheckpointSaver._instance


def _blocking_writes(saver):
    """Make the saver's ``write_shard`` record each step it writes and wait
    for ``release`` first; returns (release, entered, written)."""
    release, entered, written = threading.Event(), threading.Event(), []
    real = saver.storage.write_shard

    def write_shard(meta, payload):
        written.append(meta.step)
        entered.set()
        assert release.wait(30.0), "the test never released the write"
        return real(meta, payload)

    saver.storage.write_shard = write_shard
    return release, entered, written


def test_a_stage_lands_while_a_persist_writes(tmp_path):
    """The shard lock covers the copy out of shm, not the write: while the
    write of step N blocks, a blocking stage of N + 1 lands; storage then
    holds step N, hash-equal to the state staged at N, and shm N + 1."""
    _, _, state = _small_state()
    engine = _engine(tmp_path)
    saver = _saver()
    release, entered, written = _blocking_writes(saver)
    try:
        assert engine.save_to_storage(4, state)
        assert entered.wait(30.0)
        staged_at_4 = [(p, _bytes(tshm.leaf_tensor(x))) for p, x in tshm.flatten_with_path(state)]
        with torch.no_grad():
            for p in state.params.values():
                p.add_(1.0)
        t0 = time.monotonic()
        assert engine.save_to_memory(5, state, block=True)
        assert time.monotonic() - t0 < 10
        assert engine.skipped_stages == {"in_flight": 0, "persister_busy": 0}
        release.set()
        assert engine.wait_saving(timeout=30)
        assert written == [4] and engine.storage.latest_step() == 4
        arrays = engine.storage.load_step_host(4)
        assert [(p, _bytes(arrays[p])) for p, _ in staged_at_4] == staged_at_4
        assert engine.shm.read_meta().step == 5
        assert _wait(lambda: saver.persist_stats)  # recorded just after the commit
        (stat,) = saver.persist_stats
        assert stat["step"] == 4 and 0 <= stat["hold_s"] < stat["write_s"]
    finally:
        release.set()
        engine.close()


def test_a_stage_waits_for_the_persist_to_claim_a_storage_step(tmp_path):
    """A storage stage hands the shard lock on to the saver: while the
    saver prepares its copy (a new mapping's pages, its buffer) outside the
    lock, the next stage is skipped as ``persister_busy`` rather than
    landing over the step its SAVE asked for; storage gets that step."""
    _, _, state = _small_state()
    engine = _engine(tmp_path)
    saver = _saver()
    prepared, go = threading.Event(), threading.Event()
    real = saver._prepare_copy

    def slow_prepare():
        real()
        prepared.set()
        assert go.wait(30.0), "the test never let the copy go on"

    saver._prepare_copy = slow_prepare
    try:
        assert engine.save_to_storage(4, state)
        assert prepared.wait(30.0)
        with torch.no_grad():
            for p in state.params.values():
                p.add_(1.0)
        assert not engine.save_to_memory(5, state, block=True)
        assert engine.skipped_stages["persister_busy"] == 1
        assert engine.shm.read_meta().step == 4
        go.set()
        assert engine.wait_saving(timeout=30)
        assert engine.storage.latest_step() == 4
        # claimed: the next stage lands
        assert _wait(lambda: engine.save_to_memory(5, state, block=True), timeout=10)
        assert engine.shm.read_meta().step == 5
    finally:
        go.set()
        engine.close()


def test_a_persist_makes_its_buffer_before_it_takes_the_lock(tmp_path):
    """The SAVE of a first async stage arrives while the stage still
    writes a new segment: the saver waits for the image, then makes its
    buffer with the lock free, so the hold is the copy alone."""
    _, _, state = _small_state()
    engine = _engine(tmp_path)
    saver = _saver()
    real_write, real_buffer = engine.shm.write_image, saver._buffer
    made = []  # whether the shard lock was held as each buffer was made

    def slow_write(*args, **kwargs):
        time.sleep(0.5)
        return real_write(*args, **kwargs)

    def buffer(idx, nbytes):
        if saver._bufs[idx] is None or saver._bufs[idx].nbytes < nbytes:
            made.append(saver._shard_lock.locked())
        return real_buffer(idx, nbytes)

    engine.shm.write_image = slow_write
    saver._buffer = buffer
    try:
        assert engine.save_to_storage(0, state, block=False)
        assert engine.wait_saving(timeout=30)
        assert made == [False]
    finally:
        engine.close()


def test_a_breakpoint_save_racing_the_persist_writes_the_step_once(tmp_path):
    engine = _engine(tmp_path)
    saver = _saver()
    release, entered, written = _blocking_writes(saver)
    try:
        assert engine.save_to_storage(7, _w(7.0))
        assert entered.wait(30.0)  # the event loop's persist of 7 is writing
        done = threading.Event()
        racer = threading.Thread(target=lambda: (saver.save_shm_to_storage(), done.set()),
                                 daemon=True)
        racer.start()
        time.sleep(0.2)
        assert not done.is_set()  # the breakpoint save waits for the write
        release.set()
        racer.join(30.0)
        assert done.is_set() and engine.wait_saving(timeout=30)
        assert written == [7] and engine.storage.latest_step() == 7
    finally:
        release.set()
        engine.close()


def test_save_events_behind_a_blocked_persist_collapse_to_the_newest(tmp_path):
    """Latest wins: five storage saves queued behind a blocked write lead to
    one more write, of the newest step, and ``wait_saving`` then holds."""
    engine = _engine(tmp_path)
    saver = _saver()
    release, entered, written = _blocking_writes(saver)
    try:
        assert engine.save_to_storage(10, _w(10.0))
        assert entered.wait(30.0)
        for step in range(11, 16):
            assert engine.save_to_storage(step, _w(float(step)))
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                saver._pending is not None and saver._pending[0].step == 15):
            time.sleep(0.01)
        assert saver._pending[0].step == 15  # the newest snapshot waits for the writer
        release.set()
        assert engine.wait_saving(timeout=30)
        assert written == [10, 15] and engine.storage.latest_step() == 15
        engine.shm.unlink()
        assert engine.load(_zeros())[0] == 15 and engine.restored_from == "storage"
    finally:
        release.set()
        engine.close()


def test_save_events_drain_to_the_newest_before_the_snapshot(tmp_path):
    """The SAVE events that queued up while the event loop was busy are
    drained at once, and only the newest step is copied out."""
    engine = _engine(tmp_path)
    saver = _saver()
    snapshots = []
    real = saver._snapshot
    saver._snapshot = lambda step: (snapshots.append(step), real(step))[1]
    try:
        assert engine.save_to_memory(1, _w(1.0))
        assert engine._shard_lock.acquire(timeout=30)  # the loop's first snapshot waits
        engine._event_q.put({"type": "save", "step": 1})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not snapshots:
            time.sleep(0.01)
        for step in (2, 3, 4):
            engine._event_q.put({"type": "save", "step": step})
        assert engine.save_to_memory(4, _w(4.0))  # reentrant: this engine holds the lock
        engine._shard_lock.release()
        engine._latest_storage_step = 4
        assert engine.wait_saving(timeout=30)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and len(snapshots) < 2:
            time.sleep(0.01)
        assert snapshots == [1, 4] and engine.storage.latest_step() == 4
    finally:
        engine.close()


def test_racing_persists_write_each_step_once_under_a_short_switch_interval(tmp_path):
    """The event loop, the writer and several breakpoint savers share the
    saver's slot and buffers: with the interpreter switching threads every
    10 us, storage saves of 12 steps raced by 4 breakpoint threads write no
    step twice, and the newest step is committed with its own bytes."""
    engine = _engine(tmp_path)
    saver = _saver()
    written, lock = collections.Counter(), threading.Lock()
    real = saver.storage.write_shard

    def counting_write(meta, payload):
        with lock:
            written[meta.step] += 1
        return real(meta, payload)

    saver.storage.write_shard = counting_write
    stop = threading.Event()

    def racer():
        while not stop.is_set():
            saver.save_shm_to_storage()

    racers = [threading.Thread(target=racer, daemon=True) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in racers:
            t.start()
        for step in range(1, 13):
            assert engine.save_to_storage(step, _w(float(step), n=1 << 16))
        assert engine.wait_saving(timeout=60)
    finally:
        stop.set()
        for t in racers:
            t.join(30)
        sys.setswitchinterval(interval)
        engine.close()
    assert not any(t.is_alive() for t in racers)
    assert written and max(written.values()) == 1, written
    assert engine.storage.latest_step() == 12
    arrays = engine.storage.load_step_host(12)
    assert torch.equal(arrays["w"], torch.full((1 << 16,), 12.0))


def test_a_storage_save_waits_out_a_stage_in_flight(tmp_path, monkeypatch):
    """A memory save skips while the previous async stage runs; a storage
    save waits for it instead of dropping its step."""
    engine = _engine(tmp_path)
    release, entered = threading.Event(), threading.Event()
    real_write = engine.shm.write_image

    def slow_write(*a, **kw):
        entered.set()
        release.wait(30.0)
        return real_write(*a, **kw)

    monkeypatch.setattr(engine.shm, "write_image", slow_write)
    try:
        assert engine.save_to_memory(1, _w(1.0), block=False)
        assert entered.wait(30.0)  # the stage of step 1 is in flight
        assert not engine.save_to_memory(2, _w(2.0), block=False)
        assert engine.skipped_stages["in_flight"] == 1
        threading.Timer(0.3, release.set).start()
        monkeypatch.setattr(engine.shm, "write_image", real_write)
        assert engine.save_to_storage(3, _w(3.0), block=False)
        assert engine.storage_wait_s >= 0.2
        assert engine.wait_staged(30) and engine.wait_saving(30)
        assert engine.storage.latest_step() == 3
    finally:
        release.set()
        engine.close()


def test_checkpointer_api(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ckpt"), standalone=True)
    tree = {"a": torch.ones(2, 2)}
    try:
        assert ckpt.save_checkpoint(1, tree, StorageType.MEMORY)
        step, restored = ckpt.load_checkpoint({"a": torch.zeros(2, 2)})
        assert step == 1
        _tree_equal(tree, restored)
        assert ckpt.save_checkpoint(2, tree, StorageType.DISK)
        assert ckpt.wait_latest_checkpoint(timeout=30)
    finally:
        ckpt.close()


def test_saver_restarts_on_namespace_change(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_JOB_NAME", f"nsA_{os.getpid()}_{uuid.uuid4().hex[:6]}")
    assert AsyncCheckpointSaver.start_async_saving_ckpt().is_alive()
    monkeypatch.setenv("DLROVER_JOB_NAME", f"nsB_{os.getpid()}_{uuid.uuid4().hex[:6]}")
    engine = _engine(tmp_path)
    try:
        assert engine.save_to_memory(1, {"w": torch.ones(2)})
        assert engine.load({"w": torch.zeros(2)})[0] == 1
    finally:
        engine.shm.unlink()
        engine.close()


# -- restore into the template's own tensors -----------------------------------


def test_restore_in_place_feeds_the_models_forward(tmp_path):
    """After ``load``, the model's own parameters hold the restored weights:
    its forward gives the loss of the saved model, and the optimizer state
    and step counters come back too."""
    model_a, _, state_a = _small_state(seed=1)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 33)))
    with torch.no_grad():
        loss_a = gpt.cross_entropy_loss(model_a(tokens[:, :-1]), tokens[:, 1:])
    state_a.opt_state.mu["wte"].fill_(0.25)
    state_a = state_a._replace(step=7, opt_state=state_a.opt_state._replace(count=7))
    engine = _engine(tmp_path)
    try:
        assert engine.save_to_memory(7, state_a)
        model_b, _, state_b = _small_state(seed=2)
        params_before = {n: p for n, p in model_b.named_parameters()}
        step, restored = engine.load(state_b)
        assert step == 7 and restored.step == 7 and restored.opt_state.count == 7
        for n, p in model_b.named_parameters():
            assert p is params_before[n] and restored.params[n] is p
        assert torch.equal(restored.opt_state.mu["wte"], torch.full_like(state_a.params["wte"], 0.25))
        with torch.no_grad():
            loss_b = gpt.cross_entropy_loss(model_b(tokens[:, :-1]), tokens[:, 1:])
        assert float(loss_b) == float(loss_a)
    finally:
        engine.close()


def test_restore_leaves_the_template_untouched_on_a_mismatch(tmp_path):
    engine = _engine(tmp_path, prefetch_restore=False)
    try:
        assert engine.save_to_memory(1, {"a": torch.ones(3), "b": torch.ones(4)})
        template = {"a": torch.zeros(3), "b": torch.zeros(5)}  # b's shape differs
        assert engine._load_from_memory(template) is None
        assert torch.equal(template["a"], torch.zeros(3))
        assert engine.load({"a": torch.zeros(3), "c": torch.zeros(1)}) == (-1, None)
    finally:
        engine.close()


@pytest.mark.parametrize("option", ["place_with_rules", "warm_start", "load_resharded"])
def test_features_not_ported_yet_raise(tmp_path, option):
    """Reshard on read under a mesh needs the port's parallel layouts: the
    durable tier's templateless placement and warm start, and the engine's
    templateless restore, raise until then."""
    from dlrover_tpu_torch.checkpoint import durable

    if option == "place_with_rules":
        with pytest.raises(NotImplementedError, match="not ported"):
            durable.place_with_rules(durable.GenerationManifest(), {}, mesh=None)
        return
    if option == "warm_start":
        with pytest.raises(NotImplementedError, match="not ported"):
            durable.warm_start(str(tmp_path / "d"), "lineage", mesh=None)
        return
    engine = _engine(tmp_path)
    try:
        with pytest.raises(NotImplementedError, match="not ported"):
            engine.load_resharded(mesh=None)
    finally:
        engine.close()


def test_one_host_of_several_stages_under_its_own_rank(tmp_path):
    """``num_hosts=2`` builds an engine (peer replicas on by default, as in
    JAX, with no peer registered here) that stages into its host rank's own
    segment, stamped with both counts, and restores from it. Agreement
    across real processes: tests/test_torch_multihost.py."""
    engine = _engine(tmp_path, num_hosts=2, host_rank=1)
    try:
        assert (engine.num_hosts, engine.host_rank, engine.shm.host_rank) == (2, 1, 1)
        assert engine.save_to_memory(3, _w(3.0))
        meta = engine.shm.read_meta()
        assert (meta.step, meta.host_rank, meta.num_hosts) == (3, 1, 2)
        assert os.path.exists(os.path.join("/dev/shm", tmp.SharedMemorySegment("ckpt_shard_1").name))
        step, tree = engine.load(_zeros())
        assert step == 3 and torch.equal(tree["w"], torch.full((4,), 3.0))
    finally:
        engine.close()


# -- IPC ----------------------------------------------------------------------


def test_attach_keeps_no_mapping_of_a_segment_not_sized_yet(monkeypatch):
    """A creator opens a segment before it sizes it. An attach in that
    window keeps nothing and raises nothing, also when the size lands
    between SharedMemory's fstat and its mmap (a mapping whose size reads
    0, which would leave every staged image unreadable to the saver); the
    next attach maps the sized segment."""
    reader = tmp.SharedMemorySegment(f"attach_{uuid.uuid4().hex[:8]}")
    path = os.path.join("/dev/shm", reader.name)
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    real_fstat = os.fstat
    seen = []

    def fstat_before_the_size(f):
        st = real_fstat(f)
        if seen:
            return st
        seen.append(f)
        return os.stat_result((st.st_mode, st.st_ino, st.st_dev, st.st_nlink, st.st_uid,
                               st.st_gid, 0, st.st_atime, st.st_mtime, st.st_ctime))

    try:
        assert not reader.attach()  # opened, not sized: nothing to map yet
        os.ftruncate(fd, 4096)
        monkeypatch.setattr(os, "fstat", fstat_before_the_size)
        assert not reader.attach()
        assert seen and reader.size == 0
        monkeypatch.setattr(os, "fstat", real_fstat)
        assert reader.attach() and reader.size == 4096
    finally:
        monkeypatch.setattr(os, "fstat", real_fstat)
        reader.close()
        os.close(fd)
        os.unlink(path)


def test_ipc_frames_are_json_and_waits_are_bounded():
    q = tmp.SharedQueue("bounded", create=True)
    lock = tmp.SharedLock("bounded", create=True)
    other = tmp.SharedLock("bounded")
    try:
        q.put({"step": 3, "tags": ["a", 1]})
        assert q.get(timeout=5) == {"step": 3, "tags": ["a", 1]}
        t0 = time.monotonic()
        with pytest.raises(queue.Empty):
            q.get(timeout=0.3)
        assert lock.acquire(timeout=5)
        assert not other.acquire(timeout=0.3)  # bounded, no hang
        assert lock.acquire(timeout=5)  # reentrant for its owner
        assert lock.release() and lock.locked() and lock.release() and not lock.locked()
        assert time.monotonic() - t0 < 10
        with pytest.raises(TypeError):
            q.put({"not_json": object()})
    finally:
        other.close()
        lock.close()
        q.close()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        tmp.LocalSocketClient("queue_nobody", timeout=0.5).call("get")
    assert time.monotonic() - t0 < 5


def test_a_release_hands_the_lock_on_until_another_owner_claims_it():
    """``release(hold_off_s)``: the releasing owner cannot take the lock
    back until another owner acquires it with ``claim`` (an acquire
    without it leaves the hand-on standing), or ``hold_off_s`` passes."""
    stager = tmp.SharedLock("handon", create=True)
    saver = tmp.SharedLock("handon")
    try:
        assert stager.acquire(timeout=5) and stager.release(hold_off_s=30)
        assert not stager.acquire(blocking=False)
        assert saver.acquire(timeout=5) and saver.release()  # no claim
        assert not stager.acquire(blocking=False)
        assert saver.acquire(timeout=5, claim=True) and saver.release()
        assert stager.acquire(blocking=False) and stager.release(hold_off_s=0.3)
        t0 = time.monotonic()
        assert stager.acquire(timeout=5)  # the hand-on expires
        assert 0.2 < time.monotonic() - t0 < 5
        assert stager.release()
        assert stager.acquire(blocking=False) and stager.release()
    finally:
        saver.close()
        stager.close()


def test_shared_lock_frees_a_dead_holder(tmp_path):
    lock = tmp.SharedLock("dead_holder", create=True)
    code = (
        "import os, signal, sys\n"
        f"sys.path.insert(0, {_REPO!r})\n"
        "from dlrover_tpu_torch.common import multi_process as mp\n"
        f"mp.SOCKET_TMP_DIR = {tmp.SOCKET_TMP_DIR!r}\n"
        "assert mp.SharedLock('dead_holder').acquire(timeout=10)\n"
        "print('held', flush=True)\n"
        "os.kill(os.getpid(), signal.SIGKILL)\n"
    )
    try:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, env=dict(os.environ))
        assert proc.returncode == -9 and "held" in proc.stdout, proc.stderr
        deadline = time.monotonic() + 10
        while lock.locked() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not lock.locked()
        assert lock.acquire(timeout=5) and lock.release()
    finally:
        lock.close()


def test_two_trainer_processes_sigkill_and_resume(tmp_path, port_ipc):
    """This process plays the agent (the saver); trainer children on the CPU
    run the elastic loop: one stages step 7 and is SIGKILLed holding the
    shard lock, the next restores step 7 from shm bit-exactly (same SHA-256)
    and continues with the uninterrupted run's losses, and with shm gone a
    third restores the last storage step, hash-equal to what was staged."""
    sys.path.insert(0, _REPO)
    import chip_smoke

    facts, numbers = chip_smoke.checkpoint_phase(
        str(tmp_path / "work"), port_ipc, device="cpu", small=True, timeout=240, run_bench=False)
    assert numbers is None
    assert facts["resume_max_loss_diff"] == 0.0 and facts["resume_bit_equal"]
    assert facts["restored_from"] in ("prefetch", "memory")
    assert facts["storage_rung_step"] == chip_smoke.HASH_AT


def test_socket_paths_fit_af_unix_under_a_long_directory(tmp_path, monkeypatch):
    deep = tmp_path / ("d" * 60) / ("e" * 60)
    monkeypatch.setattr(tmp, "SOCKET_TMP_DIR", str(deep))
    path = tmp._socket_path("queue_ckpt_factory")
    assert len(path) <= 100
    q = tmp.SharedQueue("long_dir", create=True)
    try:
        q.put(1)
        assert q.get(timeout=5) == 1
    finally:
        q.close()
    monkeypatch.setattr(tmp, "SOCKET_TMP_DIR", str(deep / "other"))
    assert tmp._socket_path("queue_ckpt_factory") != path
