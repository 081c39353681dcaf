"""The port's peer-memory replicas (``dlrover_tpu_torch/checkpoint/
replica.py`` and their wiring in the saver and the engine) against the JAX
package's ``dlrover_tpu/checkpoint/replica.py``: the backup pairing and
the token are the same, a port client pushes to a JAX server and a JAX
client fetches from a port server byte for byte, the staleness rule and
the torn-PUT rule hold, and a replaced host restores from its peer's
memory without storage, in processes of its own."""

import io
import os
import subprocess
import sys
import textwrap
import threading
import time
import uuid

import pytest
import torch

from dlrover_tpu.checkpoint import replica as jreplica
from dlrover_tpu.checkpoint import shm_handler as jshm
from dlrover_tpu_torch.checkpoint import replica as treplica
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.meta import HEADER_LEN_BYTES, CheckpointMeta
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
from dlrover_tpu_torch.common import multi_process as tmp

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def job(tmp_path, monkeypatch):
    """A unique job name (the shm namespace and the token), the port's
    sockets under ``tmp_path``, no SIGTERM hook, the job's segments
    unlinked afterwards."""
    name = f"trp_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_JOB_NAME", name)
    for var in ("DLROVER_IPC_NAMESPACE", "DLROVER_REPLICA_TOKEN", "DLROVER_MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tmp, "SOCKET_TMP_DIR", str(tmp_path / "sockets"))
    monkeypatch.setattr(AsyncCheckpointSaver, "_signals_installed", True)
    AsyncCheckpointSaver.reset()
    yield name
    AsyncCheckpointSaver.shutdown()
    for seg in os.listdir("/dev/shm"):
        if seg.startswith(f"dlrover_{name}"):
            os.unlink(os.path.join("/dev/shm", seg))


def _image(step: int, payload: bytes) -> bytes:
    meta = CheckpointMeta(step=step, total_bytes=len(payload)).to_json().encode()
    return len(meta).to_bytes(HEADER_LEN_BYTES, "little") + meta + payload


def _reader(data: bytes):
    """What the port's stores and shm read from: a stream's ``readinto``."""
    return io.BytesIO(data).readinto


def _collect(got: bytearray):
    """A JAX fetch's sink: ``sink(total, read)``."""
    def sink(total, read):
        while len(got) < total:
            chunk = read(min(1 << 20, total - len(got)))
            if not chunk:
                break
            got.extend(chunk)

    return sink


def _collect_into(got: bytearray):
    """A port fetch's sink: ``sink(total, readinto)``."""
    def sink(total, readinto):
        buf = bytearray(total)
        off = 0
        with memoryview(buf) as view:
            while off < total:
                n = readinto(view[off:])
                if not n:
                    break
                off += n
        got.extend(buf[:off])

    return sink


@pytest.mark.parametrize("num_hosts", range(1, 10))
def test_backup_rank_matches_jax(num_hosts):
    ranks = range(num_hosts)
    assert [treplica.backup_rank(r, num_hosts) for r in ranks] == \
        [jreplica.backup_rank(r, num_hosts) for r in ranks]


@pytest.mark.parametrize("secret", [None, "operator-secret"])
def test_job_token_matches_jax(monkeypatch, secret):
    if secret is not None:
        monkeypatch.setenv("DLROVER_REPLICA_TOKEN", secret)
    assert treplica._job_token() == jreplica._job_token()
    assert treplica._TOKEN_HEADER == jreplica._TOKEN_HEADER
    assert treplica.KV_PREFIX == jreplica.KV_PREFIX
    assert treplica.replica_segment_name(3) == jreplica.replica_segment_name(3)


def test_port_client_pushes_to_a_jax_server_and_fetches_back():
    """More than one 8 MiB chunk, so the chunking of both sides shows."""
    store = jreplica.ReplicaStore()
    server = jreplica.ReplicaServer(store)
    server.start()
    try:
        addr = f"127.0.0.1:{server.port}"
        image = _image(7, os.urandom((17 << 20) + 3))
        assert treplica.ReplicaClient.push(addr, 1, len(image), lambda o, n: image[o : o + n])
        assert store.read(1, 0, len(image)) == image and store.step_of(1) == 7
        got = bytearray()
        assert treplica.ReplicaClient.fetch_stream(addr, 1, _collect_into(got))
        assert bytes(got) == image
        assert not treplica.ReplicaClient.fetch_stream(addr, 5, _collect_into(bytearray()))
    finally:
        server.stop()
        store.unlink()


def test_jax_client_pushes_to_a_port_server_and_fetches_back():
    store = treplica.ReplicaStore()
    server = treplica.ReplicaServer(store)
    server.start()
    try:
        addr = f"127.0.0.1:{server.port}"
        image = _image(9, os.urandom((9 << 20) + 5))
        assert jreplica.ReplicaClient.push(addr, 0, len(image), lambda o, n: image[o : o + n])
        assert store.read(0, 0, len(image)) == image and store.step_of(0) == 9
        got = bytearray()
        assert jreplica.ReplicaClient.fetch_stream(addr, 0, _collect(got))
        assert bytes(got) == image
        assert not jreplica.ReplicaClient.fetch_stream(addr, 4, _collect(bytearray()))
    finally:
        server.stop()
        store.unlink()


def test_a_wrong_token_is_refused():
    import http.client

    store = treplica.ReplicaStore()
    server = treplica.ReplicaServer(store)
    server.start()
    try:
        image = _image(1, b"x" * 64)
        for method, body in (("PUT", image), ("GET", None)):
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
            conn.request(method, "/shard/0", body=body,
                         headers={treplica._TOKEN_HEADER: "another-job"})
            assert conn.getresponse().status == 403
            conn.close()
        assert store.image_size(0) == 0
    finally:
        server.stop()
        store.unlink()


def test_torn_put_leaves_store_unreadable():
    """An interrupted PUT leaves no image that parses (the header lands
    last), never a new meta over an old payload; as JAX's
    ``test_torn_put_leaves_store_unreadable``."""
    for module in (treplica, jreplica):
        store = module.ReplicaStore()
        # the port's store reads a stream's readinto, JAX's its read
        stream = _reader if module is treplica else (lambda data: io.BytesIO(data).read)
        try:
            store.put_stream(0, len(_image(9, b"x" * 1024)), stream(_image(9, b"x" * 1024)))
            assert store.step_of(0) == 9
            newer = _image(10, b"y" * 1024)
            with pytest.raises(IOError):
                store.put_stream(0, len(newer), stream(newer[: len(newer) // 2]))
            assert store.image_size(0) == 0 and store.step_of(0) is None
        finally:
            store.unlink()


def test_a_closed_store_refuses_a_late_put():
    store = treplica.ReplicaStore()
    store.put_stream(2, len(_image(1, b"z" * 16)), _reader(_image(1, b"z" * 16)))
    store.unlink()
    with pytest.raises(RuntimeError, match="closed"):
        store.put_stream(2, len(_image(2, b"z" * 16)), _reader(_image(2, b"z" * 16)))


def test_a_push_has_a_deadline_for_the_whole_body():
    """A peer that accepts but never reads: the push returns False within
    its deadline instead of hanging."""
    import socket

    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    try:
        addr = f"127.0.0.1:{listener.getsockname()[1]}"
        big = bytes(64 << 20)
        t0 = time.monotonic()
        assert not treplica.ReplicaClient.push(addr, 0, len(big), lambda o, n: big[o : o + n],
                                               timeout=1.0)
        assert time.monotonic() - t0 < 10
    finally:
        listener.close()


class _Storage:
    def __init__(self, step):
        self.step = step

    def latest_step(self):
        return self.step


@pytest.mark.parametrize("storage_step,outcome", [(None, "refilled"), (5, "refilled"),
                                                  (6, "stale")])
def test_refill_shm_refuses_a_replica_older_than_storage(storage_step, outcome):
    """The rule both packages share: a replica older than storage's newest
    committed step is dropped (shm reads empty afterwards). Each package's
    manager refills its own package's shm handler from the port's server."""
    holder = treplica.ReplicaManager(1, 2, peers={})
    holder.start()
    try:
        image = _image(5, b"p" * 256)
        holder.store.put_stream(0, len(image), _reader(image))
        addr = {1: f"127.0.0.1:{holder.server.port}"}
        results = []
        for module, handler, shm_name in ((treplica, SharedMemoryHandler, "port_refill"),
                                          (jreplica, jshm.SharedMemoryHandler, "jax_refill")):
            shm = handler(0, name=shm_name)
            try:
                mgr = module.ReplicaManager(0, 2, peers=addr, advertise_host="127.0.0.1")
                results.append(mgr.refill_shm(shm, _Storage(storage_step)))
                meta = shm.read_meta()
                assert (meta is None) == (outcome == "stale")
                if meta is not None:
                    assert shm.image_size() == len(image)
                    assert shm.read_image(0, len(image)) == image
            finally:
                shm.unlink()
        assert results == [outcome, outcome]
    finally:
        holder.stop(unlink=True)


def test_peer_addresses_come_from_the_kv_store_on_every_call():
    """A replaced peer registers a new address; the next lookup reads it."""

    class _KV:
        def __init__(self):
            self.kv = {}

        def kv_store_set(self, key, value):
            self.kv[key] = value

        def kv_store_multi_get(self, keys):
            return {k: self.kv[k] for k in keys if k in self.kv}

    kv = _KV()
    mgr = treplica.ReplicaManager(0, 2, master_client=kv, advertise_host="127.0.0.1")
    mgr.start()
    try:
        assert kv.kv["ckpt_replica/0"] == f"127.0.0.1:{mgr.server.port}".encode()
        kv.kv_store_set("ckpt_replica/1", b"10.0.0.1:1")
        assert mgr.peer_addrs() == {0: f"127.0.0.1:{mgr.server.port}", 1: "10.0.0.1:1"}
        kv.kv_store_set("ckpt_replica/1", b"10.0.0.2:2")
        assert mgr.peer_addrs()[1] == "10.0.0.2:2"
    finally:
        mgr.stop(unlink=True)
    assert kv.kv["ckpt_replica/0"] == b""  # unregistered


def test_the_saver_pushes_from_its_buffer_with_the_shard_lock_free(tmp_path):
    """The push reads the saver's private copy: while a slow peer takes the
    body, the trainer's shard lock is free; the peer ends up with the
    staged image, byte-equal."""
    holder = jreplica.ReplicaManager(1, 2, peers={}, advertise_host="127.0.0.1")
    holder.start()
    slow = threading.Event()
    orig = treplica.ReplicaClient.push

    def slow_push(addr, owner, total, read, timeout=None):
        def paced(offset, n):
            slow.set()
            time.sleep(0.2)
            return read(offset, n)

        return orig(addr, owner, total, paced, timeout)

    engine = CheckpointEngine(str(tmp_path / "ckpt"), host_rank=0, num_hosts=2, standalone=True,
                              replica_peers={1: f"127.0.0.1:{holder.server.port}"})
    try:
        treplica.ReplicaClient.push = staticmethod(slow_push)
        image = torch.arange(3 << 20, dtype=torch.float32)  # 12 MiB: two chunks
        assert engine.save_to_memory(4, {"w": image})
        assert slow.wait(30)
        t0 = time.monotonic()
        assert engine._shard_lock.acquire(blocking=True, timeout=5)
        engine._shard_lock.release()
        assert time.monotonic() - t0 < 1.0
        stats = AsyncCheckpointSaver._instance.replica_stats
        deadline = time.monotonic() + 60
        while not stats:
            assert time.monotonic() < deadline, "the push never ended"
            time.sleep(0.05)
        total = engine.shm.image_size()
        assert holder.store.step_of(0) == 4
        assert holder.store.read(0, 0, total) == engine.shm.read_image(0, total)
        assert stats[-1]["ok"] and stats[-1]["step"] == 4 and stats[-1]["bytes"] == total
    finally:
        treplica.ReplicaClient.push = staticmethod(orig)
        engine.shm.unlink()
        engine.close()
        holder.stop()
        holder.store.unlink()


def test_replicate_events_between_save_events_are_not_lost(tmp_path):
    """The event loop collapses SAVE events; a REPLICATE among them still
    reaches the push worker."""
    holder = treplica.ReplicaManager(1, 2, peers={})
    holder.start()
    engine = CheckpointEngine(str(tmp_path / "ckpt"), host_rank=0, num_hosts=2, standalone=True,
                              replica_peers={1: f"127.0.0.1:{holder.server.port}"})
    try:
        for step in range(3):
            assert engine.save_to_storage(step, {"w": torch.full((8,), float(step))})
        deadline = time.monotonic() + 60
        while holder.store.step_of(0) != 2:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        engine.shm.unlink()
        engine.close()
        holder.stop(unlink=True)


def test_prefetch_restore_refills_an_empty_shm_from_the_peer(tmp_path):
    """The agent's overlapped restore: ``staged`` with an image, else the
    peer's replica (``refilled``)."""
    holder = treplica.ReplicaManager(1, 2, peers={})
    holder.start()
    try:
        saver = AsyncCheckpointSaver(str(tmp_path / "ckpt"), host_rank=0, num_hosts=2,
                                     replicate=True,
                                     replica_peers={1: f"127.0.0.1:{holder.server.port}"})
        try:
            assert saver.prefetch_restore() == "empty"
            shm = SharedMemoryHandler(0, name="source")
            shm.save_pytree(11, {"w": torch.ones(4)}, num_hosts=2)
            image = shm.read_image(0, shm.image_size())
            shm.unlink()
            holder.store.put_stream(0, len(image), _reader(image))
            assert saver.prefetch_restore() == "refilled"
            assert saver.shm.read_meta().step == 11
            assert saver.prefetch_restore() == "staged"
        finally:
            saver.stop()
            saver.shm.unlink()
            saver._shard_lock.close()
    finally:
        holder.stop(unlink=True)


_HOST1 = textwrap.dedent("""
    import sys, time
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    engine = CheckpointEngine(sys.argv[1], host_rank=1, num_hosts=2, standalone=True,
                              replica_peers={})
    inst = AsyncCheckpointSaver._instance
    for _ in range(200):
        if inst is not None and inst.replica_manager is not None:
            break
        time.sleep(0.05)
        inst = AsyncCheckpointSaver._instance
    with open(sys.argv[2], "w") as f:
        f.write(str(inst.replica_manager.server.port))
    time.sleep(120)
""")

_HOST0_SAVE = textwrap.dedent("""
    import sys, time
    import torch
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    engine = CheckpointEngine(sys.argv[1], host_rank=0, num_hosts=2, standalone=True,
                              replica_peers={1: sys.argv[2]})
    tree = {"w": torch.arange(512, dtype=torch.float32).reshape(16, 32),
            "b": torch.full((8,), 2.5), "step_count": 41}
    assert engine.save_to_memory(5, tree)
    stats = AsyncCheckpointSaver._instance.replica_stats
    for _ in range(300):
        if stats and stats[-1]["ok"]:
            print("REPLICATED", flush=True)
            sys.exit(0)
        time.sleep(0.05)
    sys.exit(3)
""")

_HOST0_RESTORE = textwrap.dedent("""
    import os, sys
    import torch
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine

    engine = CheckpointEngine(sys.argv[1], host_rank=0, num_hosts=2, standalone=True,
                              replica_peers={1: sys.argv[2]})
    template = {"w": torch.zeros(16, 32), "b": torch.zeros(8), "step_count": 0}
    step, restored = engine.load(template)
    assert step == 5, step
    assert torch.equal(restored["w"], torch.arange(512, dtype=torch.float32).reshape(16, 32))
    assert torch.equal(restored["b"], torch.full((8,), 2.5)) and restored["step_count"] == 41
    assert engine.peer_refill == "refilled" and engine.restored_from == "peer", (
        engine.peer_refill, engine.restored_from)
    assert not [n for n in os.listdir(sys.argv[1]) if not n.startswith(".")], os.listdir(sys.argv[1])
    print("RESTORED_FROM_PEER", flush=True)
    engine.shm.unlink()
    engine.close()
""")


def _spawn(code, args, job_name, tmp_path):
    env = dict(os.environ, DLROVER_JOB_NAME=job_name, DLROVER_REPLICA_TOKEN="test-job-secret",
               PYTHONPATH=_REPO, DLROVER_IPC_DIR=str(tmp_path / f"sock_{job_name}"),
               OMP_NUM_THREADS="1")
    env.pop("DLROVER_MASTER_ADDR", None)
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path))


def test_node_replacement_restores_from_peer(tmp_path):
    """JAX ``test_node_replacement_restores_from_peer`` with port processes:
    host 0 stages and its saver mirrors the image into host 1's memory; host
    0 dies; its replacement, in a fresh namespace (its shm went with the old
    machine), restores the image from host 1 without touching storage."""
    uid = uuid.uuid4().hex[:8]
    port_file = tmp_path / "host1_port"
    dirs = [tmp_path / d for d in ("ckpt1", "ckpt0", "ckpt0b")]
    for d in dirs:
        d.mkdir()
    jobs = [f"trph1_{uid}", f"trph0_{uid}", f"trph0b_{uid}"]
    host1 = _spawn(_HOST1, [str(dirs[0]), str(port_file)], jobs[0], tmp_path)
    procs = [host1]
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not port_file.exists():
            assert host1.poll() is None, host1.stdout.read()
            time.sleep(0.1)
        assert port_file.exists(), "host 1's replica server never came up"
        time.sleep(0.1)
        peer = f"127.0.0.1:{port_file.read_text().strip()}"
        host0 = _spawn(_HOST0_SAVE, [str(dirs[1]), peer], jobs[1], tmp_path)
        procs.append(host0)
        out, _ = host0.communicate(timeout=90)
        assert host0.returncode == 0 and "REPLICATED" in out, out
        host0b = _spawn(_HOST0_RESTORE, [str(dirs[2]), peer], jobs[2], tmp_path)
        procs.append(host0b)
        out, _ = host0b.communicate(timeout=90)
        assert host0b.returncode == 0 and "RESTORED_FROM_PEER" in out, out
        assert "recovered shard of rank 0 from peer 1" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        for name in os.listdir("/dev/shm"):
            if any(name.startswith(f"dlrover_{j}_") for j in jobs):
                os.unlink(os.path.join("/dev/shm", name))
