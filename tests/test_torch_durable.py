"""The port's durable checkpoint tier (``dlrover_tpu_torch/checkpoint/
durable/``) against the JAX package's ``dlrover_tpu/checkpoint/durable/``:
a generation written by either package is listed, verified and read by the
other with equal arrays; shards, done files and manifests are byte-equal;
the GC keeps the same set; a flipped byte fails both; the engine's durable
rung restores a world-of-two lineage in a world of one as the JAX engine
does; and the saver drains from its own persist buffer."""

import json
import os
import shutil
import time
import uuid

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint import durable as jdurable
from dlrover_tpu.checkpoint import meta as jmeta
from dlrover_tpu.checkpoint.engine import CheckpointEngine as JaxEngine
from dlrover_tpu.checkpoint.shm_handler import SharedMemoryHandler as JaxShm
from dlrover_tpu_torch.checkpoint import durable as tdurable
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.meta import CheckpointMeta, ShardRecord
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.common import multi_process as tmp


@pytest.fixture(autouse=True)
def job(tmp_path, monkeypatch):
    """A unique job (the shm namespace), the port's sockets under
    ``tmp_path``, no SIGTERM hook, the job's segments unlinked
    afterwards."""
    name = f"tdu_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_JOB_NAME", name)
    for var in ("DLROVER_IPC_NAMESPACE", "DLROVER_MASTER_ADDR", "DLROVER_DURABLE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tmp, "SOCKET_TMP_DIR", str(tmp_path / "port_sockets"))
    monkeypatch.setattr(AsyncCheckpointSaver, "_signals_installed", True)
    AsyncCheckpointSaver.reset()
    yield name
    AsyncCheckpointSaver.shutdown()
    for seg in os.listdir("/dev/shm"):
        if seg.startswith(f"dlrover_{name}"):
            os.unlink(os.path.join("/dev/shm", seg))


def _state(seed=0):
    """A train-state-like tree: fp32 and bf16 leaves under the categories
    the manifest groups by, and a step counter."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                       "e": rng.standard_normal((16,)).astype(ml_dtypes.bfloat16)},
            "opt_state": {"mu": {"w": rng.standard_normal((4, 8)).astype(np.float32)}},
            "step": np.int64(seed + 3)}


def _torch_tree(state):
    def leaf(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(x))

    return {"params": {k: leaf(v) for k, v in state["params"].items()},
            "opt_state": {"mu": {k: leaf(v) for k, v in state["opt_state"]["mu"].items()}},
            "step": int(state["step"])}


def _template():
    return {"params": {"w": torch.zeros(4, 8), "e": torch.zeros(16, dtype=torch.bfloat16)},
            "opt_state": {"mu": {"w": torch.zeros(4, 8)}}, "step": 0}


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _port_generation(root, lineage, step, state, num_hosts=2):
    """``step`` written by the port: every rank of a data-parallel world
    stages the whole state into its own segment and its writer drains it;
    rank 0 commits after the done-file barrier."""
    shms = [SharedMemoryHandler(r, name=f"durable_src_{r}") for r in range(num_hosts)]
    try:
        writers = []
        for r, shm in enumerate(shms):
            shm.save_pytree(step, _torch_tree(state), num_hosts=num_hosts, extra={"rank": r})
            writers.append(tdurable.DurableWriter(root, lineage, r, num_hosts, shm, keep=0))
        for w in reversed(writers):  # rank 0 last: its commit waits for the others
            assert w.drain(step)
        for w in writers:
            w.stop()
    finally:
        for shm in shms:
            shm.unlink()


def _jax_generation(root, lineage, step, state, num_hosts=2):
    shms = [JaxShm(r, name=f"jdurable_src_{r}") for r in range(num_hosts)]
    try:
        writers = []
        for r, shm in enumerate(shms):
            tree = {"params": {k: jnp.asarray(v) for k, v in state["params"].items()},
                    "opt_state": {"mu": {k: jnp.asarray(v)
                                         for k, v in state["opt_state"]["mu"].items()}},
                    "step": state["step"]}
            shm.save_pytree(step, tree, num_hosts=num_hosts, extra={"rank": r})
            writers.append(jdurable.DurableWriter(root, lineage, r, num_hosts, shm, keep=0))
        for w in reversed(writers):
            assert w.drain(step)
        for w in writers:
            w.stop()
    finally:
        for shm in shms:
            shm.unlink()


def _flat(state):
    return {"params/w": state["params"]["w"], "params/e": state["params"]["e"],
            "opt_state/mu/w": state["opt_state"]["mu"]["w"], "step": state["step"]}


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_generation_written_by_one_package_reads_in_the_other(tmp_path, writer, reader):
    root = str(tmp_path / "durable")
    state = _state(1)
    (_port_generation if writer == "port" else _jax_generation)(root, "lin", 12, state)
    read = tdurable.read_generation if reader == "port" else jdurable.read_generation
    listed = tdurable.list_lineages if reader == "port" else jdurable.list_lineages
    layout = (tdurable.DurableLayout if reader == "port" else jdurable.DurableLayout)(root, "lin")
    assert listed(root) == ["lin"] and layout.latest_committed() == 12
    step, manifest, arrays, extra = read(root, "lin", host_rank=1)
    assert step == 12 and manifest.num_hosts == 2 and extra == {"rank": 1}
    assert sorted(arrays) == sorted(_flat(state))
    for path, want in _flat(state).items():
        got = _as_numpy(arrays[path])
        assert got.dtype == np.asarray(want).dtype and np.array_equal(got, want), path
    assert not layout.leased_steps()  # the read's lease was released


def test_shards_done_files_and_manifests_are_byte_equal(tmp_path):
    """The same image through both packages' phase 1 and phase 2: the same
    shard bytes, crc32 done records and metas; manifests equal but for the
    commit's timestamp."""
    payload = np.arange(4096, dtype=np.float32).tobytes() + bytes(range(7))
    recs = [ShardRecord(path="params/w", global_shape=[4096], local_shape=[4096],
                        dtype="float32", index=[(0, 4096)], offset=0, nbytes=16384, spec=[]),
            ShardRecord(path="x/bytes", global_shape=[7], local_shape=[7], dtype="uint8",
                        index=[(0, 7)], offset=16384, nbytes=7, spec=[])]
    meta = CheckpointMeta(step=4, host_rank=0, num_hosts=1, records=recs,
                          total_bytes=len(payload), timestamp=1.5, extra={"k": 1})
    roots = {}
    for name, layout_cls, meta_obj, commit in (
            ("port", tdurable.DurableLayout, meta, tdurable.commit_generation),
            ("jax", jdurable.DurableLayout, jmeta.CheckpointMeta.from_json(meta.to_json()),
             jdurable.commit_generation)):
        roots[name] = str(tmp_path / name)
        layout = layout_cls(roots[name], "lin")
        crc = layout.write_shard(meta_obj, lambda o, n: payload[o : o + n])
        assert commit(layout, 4, 1)
        roots[name] = (layout, crc)
    (tl, tcrc), (jl, jcrc) = roots["port"], roots["jax"]
    assert tcrc == jcrc
    for path in ("shard_bin_path", "shard_meta_path", "done_path"):
        with open(getattr(tl, path)(4, 0), "rb") as a, open(getattr(jl, path)(4, 0), "rb") as b:
            assert a.read() == b.read(), path
    manifests = []
    for layout in (tl, jl):
        with open(layout.manifest_path(4)) as f:
            m = json.load(f)
        m.pop("timestamp")
        manifests.append(m)
    assert manifests[0] == manifests[1]
    assert manifests[0]["category_specs"] == {"params": {"params/w": []}, "extra": {"x/bytes": []}}
    for layout in (tl, jl):
        with open(layout.tracker_path()) as f:
            assert f.read() == "4"


def _gen(layout, step, commit=True):
    payload = np.full((4,), float(step), np.float32).tobytes()
    meta = CheckpointMeta(step=step, host_rank=0, num_hosts=1, total_bytes=16, records=[
        ShardRecord(path="params/w", global_shape=[4], local_shape=[4], dtype="float32",
                    index=[], offset=0, nbytes=16, spec=[])])
    layout.write_shard(meta, lambda o, n: payload[o : o + n])
    if commit:
        assert tdurable.commit_generation(layout, step, 1)


@pytest.mark.parametrize("case", ["keep_two", "pins_and_leases", "tracker_only", "partials"])
def test_collect_generations_keeps_what_jax_keeps(tmp_path, case):
    base = str(tmp_path / "base")
    layout = tdurable.DurableLayout(base, "lin")
    keep = 2
    for step in (1, 2, 3, 4, 5):
        _gen(layout, step, commit=not (case == "partials" and step in (2, 3)))
    if case == "pins_and_leases":
        layout.pin(1)
        layout.take_lease(3)
    elif case == "tracker_only":
        layout.advance_tracker(2)
        keep = 1
    elif case == "partials":
        old = time.time() - 7200
        os.utime(layout.gen_dir(2), (old, old))  # past the grace period; 3 is fresh
    got = {}
    for name, module in (("port", tdurable), ("jax", jdurable)):
        root = str(tmp_path / name)
        shutil.copytree(base, root)
        lay = module.DurableLayout(root, "lin")
        got[name] = (module.collect_generations(lay, keep=keep),
                     sorted(os.listdir(lay.lineage_dir)))
    assert got["port"] == got["jax"]


def test_a_flipped_byte_fails_both_readers(tmp_path):
    root = str(tmp_path / "durable")
    _port_generation(root, "lin", 7, _state(2))
    path = tdurable.DurableLayout(root, "lin").shard_bin_path(7, 1)
    with open(path, "r+b") as f:
        f.seek(5)
        byte = f.read(1)
        f.seek(5)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(tdurable.DurableShardError):
        tdurable.read_generation(root, "lin")
    with pytest.raises(jdurable.DurableShardError):
        jdurable.read_generation(root, "lin")


def test_the_engines_durable_rung_restores_a_world_of_two_in_a_world_of_one(tmp_path):
    """A whole-pool loss: no shm and no flash storage, a lineage committed by
    a world of two. The port engine (world of one) agrees on the newest
    generation and restores it into its template, as the JAX engine does
    with the same lineage."""
    root = str(tmp_path / "durable")
    _port_generation(root, "lin", 5, _state(0))
    _port_generation(root, "lin", 10, _state(4))
    engine = CheckpointEngine(str(tmp_path / "ckpt"), standalone=True, durable_dir=root,
                              durable_lineage="lin")
    try:
        step, restored = engine.load_consistent(_template())
        assert (step, engine.restored_from) == (10, "durable")
        assert restored["step"] == 7
        for path, want in _flat(_state(4)).items():
            if path != "step":
                node = restored
                for key in path.split("/"):
                    node = node[key]
                assert np.array_equal(_as_numpy(node), want), path
    finally:
        engine.close()
    jengine = _jax_engine_without_saver(str(tmp_path / "jckpt"), root, "lin")
    try:
        template = {"params": {"w": jnp.zeros((4, 8)), "e": jnp.zeros(16, jnp.bfloat16)},
                    "opt_state": {"mu": {"w": jnp.zeros((4, 8))}}, "step": np.int64(0)}
        jstep, jrestored = jengine.load_consistent(template)
        assert jstep == 10 and int(jrestored["step"]) == 7
        assert np.array_equal(np.asarray(jrestored["params"]["e"]), _state(4)["params"]["e"])
        assert np.array_equal(np.asarray(jrestored["params"]["w"]), _as_numpy(restored["params"]["w"]))
    finally:
        jengine.shm.close()


def _jax_engine_without_saver(ckpt_dir, durable_dir, lineage):
    """A JAX engine of a world of one with empty shm and storage, for its
    restore decision and rungs alone: a standalone JAX engine's close()
    waits on its saver's queues at shutdown, which took minutes."""
    from dlrover_tpu.checkpoint.storage import PosixCheckpointStorage as JaxStorage
    from dlrover_tpu.common.events import TrainerEvents

    engine = JaxEngine.__new__(JaxEngine)
    engine.host_rank, engine.num_hosts, engine.mesh = 0, 1, None
    engine.durable_dir, engine.durable_lineage = durable_dir, lineage
    engine._replicate, engine._replica_peers, engine.master_client = False, None, None
    engine._stage_thread = engine._stage_error = None
    engine._prefetch_thread = engine._prefetched = None
    engine._prefetch_invalid = False
    engine._events = TrainerEvents()
    engine.shm = JaxShm(0, name=f"empty_{uuid.uuid4().hex[:6]}")
    engine.storage = JaxStorage(ckpt_dir)
    return engine


def test_a_torn_tier_is_a_fresh_start(tmp_path):
    """The durable rung's broad except, as in JAX: a corrupt generation is
    no crash but a fresh start."""
    root = str(tmp_path / "durable")
    _port_generation(root, "lin", 5, _state(0))
    path = tdurable.DurableLayout(root, "lin").shard_bin_path(5, 0)
    with open(path, "r+b") as f:
        f.truncate(8)
    engine = CheckpointEngine(str(tmp_path / "ckpt"), standalone=True, durable_dir=root,
                              durable_lineage="lin")
    try:
        assert engine.load_consistent(_template()) == (-1, None)
    finally:
        engine.close()


def test_the_saver_drains_from_its_persist_buffer(tmp_path):
    """A storage save whose step ``durable_every`` divides commits a
    generation written from the buffer the persist copied out of shm: no
    shard-lock hold of its own, and the buffer comes back."""
    root = str(tmp_path / "durable")
    engine = CheckpointEngine(str(tmp_path / "ckpt"), standalone=True, durable_dir=root,
                              durable_lineage="lin")
    try:
        state = _torch_tree(_state(3))
        assert engine.save_to_storage(6, state)
        assert engine.wait_saving(60)
        saver = AsyncCheckpointSaver._instance
        writer = saver._durable_writer
        assert writer.wait_idle(60)
        assert tdurable.DurableLayout(root, "lin").latest_committed() == 6
        assert writer.stats[-1]["source"] == "saver buffer" and writer.stats[-1]["hold_s"] == 0.0
        assert not saver._lent and len(saver._bufs) == 2
        step, _, arrays, _ = jdurable.read_generation(root, "lin")
        assert step == 6 and np.array_equal(arrays["params/w"], _state(3)["params"]["w"])
    finally:
        engine.shm.unlink()
        engine.close()


def test_place_with_rules_and_warm_start_raise_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="reshard on read"):
        tdurable.place_with_rules(tdurable.GenerationManifest(), {}, None)
    with pytest.raises(NotImplementedError, match="reshard on read"):
        tdurable.warm_start(str(tmp_path), "lin", None)
    assert sorted(tdurable.__all__) == sorted(jdurable.__all__)


class _KV:
    """The master's ``kv_store_add`` counter, in memory."""

    def __init__(self):
        self.kv = {}

    def kv_store_add(self, key, amount):
        self.kv[key] = self.kv.get(key, 0) + amount
        return self.kv[key]


def _shard(layout, step, rank, num_hosts=2):
    payload = np.full((4,), float(step), np.float32).tobytes()
    meta = CheckpointMeta(step=step, host_rank=rank, num_hosts=num_hosts, total_bytes=16, records=[
        ShardRecord(path="params/w", global_shape=[4], local_shape=[4], dtype="float32",
                    index=[], offset=0, nbytes=16, spec=[])])
    layout.write_shard(meta, lambda o, n: payload[o : o + n])


@pytest.mark.parametrize("kind", ["fs", "kv"])
def test_rank_0_gives_a_generation_up_that_another_host_skipped(tmp_path, kind):
    """Rank 0 waits for gen 5, which host 1 will never write (it drained
    10 instead, latest wins, or it is a replacement that never had 5):
    once 10 waits behind 5 in rank 0's writer and host 1 has signalled 10,
    rank 0 gives 5 up at once instead of waiting out its timeout; 5 stays
    uncommitted, and 10 commits."""
    layout = tdurable.DurableLayout(str(tmp_path / "durable"), "lin")
    barrier = (tdurable.FsBarrier(layout, 2) if kind == "fs"
               else tdurable.MasterKVBarrier(_KV(), "lin", 2))
    _shard(layout, 5, 0)
    barrier.signal(5, 0)
    assert not tdurable.commit_generation(layout, 5, 2, barrier=barrier, timeout_s=0.3,
                                          newer=lambda: 10)  # host 1 has not written 10 yet
    _shard(layout, 10, 1)
    barrier.signal(10, 1)
    t0 = time.monotonic()
    assert not tdurable.commit_generation(layout, 5, 2, barrier=barrier, timeout_s=60,
                                          newer=lambda: 10)
    assert time.monotonic() - t0 < 10 and not layout.committed(5)
    _shard(layout, 10, 0)
    barrier.signal(10, 0)
    assert tdurable.commit_generation(layout, 10, 2, barrier=barrier, timeout_s=10,
                                      newer=lambda: None)
    assert layout.latest_committed() == 10
