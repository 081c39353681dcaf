"""Peer-memory checkpoint replicas over the control network: the port of
``dlrover_tpu/checkpoint/replica.py``.

Each host's staged shm image is pushed by its agent's saver to a peer
host's :class:`ReplicaServer`, which keeps it in a shm segment of its own;
a replaced host, whose shm went with the old machine, fetches its image
back from that peer and restores through the memory path, without
storage. Replication is host-level: the push runs in the agent's saver,
never in the train step, and survives the death of the training process.
Peers find each other through the master's KV store
(``ckpt_replica/{rank}`` -> ``host:port``).

The wire protocol, the token and the stored unit are the JAX package's,
so a port client and a JAX server (or the reverse) interoperate: ``PUT``
and ``GET`` of ``/shard/{owner_rank}`` with the ``X-Replica-Token`` header
and a ``Content-Length`` body, the body being the raw segment image
``[8B meta_len][meta JSON][payload]``. Differences from the JAX module:

- every transfer has a deadline of ``ckpt_replica_timeout_s`` for the
  whole body, not per socket operation; the client moves the body in
  8 MiB chunks through ``http.client`` (urllib sends a request body in
  8 KiB blocks);
- :meth:`ReplicaServer.stop` waits for requests in flight at most its
  deadline, and a closed :class:`ReplicaStore` refuses writes, so a late
  ``PUT`` cannot recreate a segment the store already unlinked;
- the JAX module's fault-injection points (``chaos.faults``) are left
  out: the chaos harness is not ported.
"""

import hashlib
import http.client
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from ..common.config import get_context
from ..common.log import logger
from ..common.multi_process import SharedMemorySegment
from .meta import HEADER_LEN_BYTES, CheckpointMeta
from .shm_handler import IMAGE_CHUNK, segment_image_size, stream_into_segment

KV_PREFIX = "ckpt_replica/"
_CHUNK = IMAGE_CHUNK
_TOKEN_HEADER = "X-Replica-Token"


def _job_token() -> str:
    """Shared secret of the replica endpoints: ``DLROVER_REPLICA_TOKEN``
    when an operator set one, else derived from the job name, so that
    requests of other jobs are refused."""
    secret = os.getenv("DLROVER_REPLICA_TOKEN")
    if secret:
        return secret
    job = os.getenv("DLROVER_JOB_NAME", "default")
    return hashlib.sha256(f"dlrover-replica:{job}".encode()).hexdigest()


def default_master_client():
    """The process's ``MasterClient`` when a master address is set, else
    None."""
    try:
        from ..rpc.client import MasterClient

        return MasterClient.singleton()
    except Exception as e:  # noqa: BLE001 — replicas work without a master (static peers)
        logger.debug("no master client for replica placement: %r", e)
        return None


def replica_segment_name(owner_rank: int) -> str:
    return f"ckpt_replica_{owner_rank}"


def backup_rank(host_rank: int, num_hosts: int) -> int:
    """The peer that stores this host's replica: adjacent ranks pair up,
    and a trailing odd rank wraps to rank 0."""
    if num_hosts <= 1:
        return host_rank
    partner = host_rank ^ 1
    return 0 if partner >= num_hosts else partner


class ReplicaStore:
    """Peers' segment images in this host's shared memory (a replica
    outlives the process that received it, as the local shard does).

    A lock per owner rank: a ``PUT`` body is paced by its sender, so a
    stalled peer wedges only its own slot (rank 0 can hold two ranks'
    replicas when the world is odd)."""

    def __init__(self):
        self._segments: Dict[int, SharedMemorySegment] = {}
        self._sizes: Dict[int, int] = {}
        self._gens: Dict[int, int] = {}  # bumped on every overwrite
        self._meta_lock = threading.Lock()
        self._rank_locks: Dict[int, threading.Lock] = {}
        self._closed = False

    def _lock_for(self, owner_rank: int) -> threading.Lock:
        with self._meta_lock:
            lock = self._rank_locks.get(owner_rank)
            if lock is None:
                lock = self._rank_locks[owner_rank] = threading.Lock()
            return lock

    def _segment(self, owner_rank: int) -> SharedMemorySegment:
        with self._meta_lock:
            if self._closed:
                raise RuntimeError("replica store is closed")
            seg = self._segments.get(owner_rank)
            if seg is None:
                seg = self._segments[owner_rank] = SharedMemorySegment(
                    replica_segment_name(owner_rank))
            return seg

    def put_stream(self, owner_rank: int, total: int, readinto: Callable[[memoryview], int]) -> None:
        """Stream ``total`` bytes from ``readinto`` into the owner's slot.
        The advertised size is dropped before the overwrite and the image's
        header lands last, so an interrupted ``PUT`` leaves a slot that
        reads as absent."""
        with self._lock_for(owner_rank):
            self._sizes.pop(owner_rank, None)
            self._gens[owner_rank] = self._gens.get(owner_rank, 0) + 1
            stream_into_segment(self._segment(owner_rank), total, readinto)
            self._sizes[owner_rank] = total

    def image_size(self, owner_rank: int) -> int:
        with self._lock_for(owner_rank):
            size = self._sizes.get(owner_rank, 0)
            if size:
                return size
            # a segment left by an earlier agent: its size is in its meta
            size = segment_image_size(self._segment(owner_rank))
            if size:
                self._sizes[owner_rank] = size
            return size

    def generation(self, owner_rank: int) -> int:
        with self._lock_for(owner_rank):
            return self._gens.get(owner_rank, 0)

    def read_checked(self, owner_rank: int, offset: int, nbytes: int, gen: int) -> Optional[bytes]:
        """The bytes, if the slot still holds generation ``gen``; None when
        it was overwritten (check and read under one lock hold)."""
        with self._lock_for(owner_rank):
            if self._gens.get(owner_rank, 0) != gen:
                return None
            seg = self._segment(owner_rank)
            if not seg.attach():
                return None
            return seg.read(offset, nbytes)

    def read(self, owner_rank: int, offset: int, nbytes: int) -> bytes:
        with self._lock_for(owner_rank):
            seg = self._segment(owner_rank)
            if not seg.attach():
                return b""
            return seg.read(offset, nbytes)

    def step_of(self, owner_rank: int) -> Optional[int]:
        """The step of the owner's replica; None when the slot is empty or
        torn."""
        if not self.image_size(owner_rank):
            return None
        with self._lock_for(owner_rank):
            seg = self._segment(owner_rank)
            try:
                meta_len = int.from_bytes(seg.read(0, HEADER_LEN_BYTES), "little")
                return CheckpointMeta.from_json(seg.read(HEADER_LEN_BYTES, meta_len).decode()).step
            except (ValueError, TypeError, KeyError, UnicodeDecodeError, RuntimeError) as e:
                logger.debug("replica meta unreadable: %r", e)
                return None

    def close(self) -> None:
        with self._meta_lock:
            for seg in self._segments.values():
                seg.close()
            self._segments.clear()

    def unlink(self) -> None:
        """Remove every slot's segment; the store refuses writes from now
        on."""
        with self._meta_lock:
            self._closed = True
            for seg in self._segments.values():
                seg.unlink()
            self._segments.clear()
            self._sizes.clear()


class _ReplicaHandler(BaseHTTPRequestHandler):
    store: ReplicaStore = None  # set on the server's subclass
    protocol_version = "HTTP/1.1"
    # a peer that dies mid-PUT without a reset must not pin this thread
    # (and its rank's lock) forever
    timeout = 60

    def _rank(self) -> Optional[int]:
        parts = self.path.strip("/").split("/")
        if len(parts) == 2 and parts[0] == "shard":
            try:
                return int(parts[1])
            except ValueError:
                return None
        return None

    def _authorized(self) -> bool:
        if self.headers.get(_TOKEN_HEADER, "") == _job_token():
            return True
        self.send_error(403)
        return False

    def do_PUT(self):  # noqa: N802 — http.server API
        if not self._authorized():
            return
        rank = self._rank()
        length = int(self.headers.get("Content-Length", 0))
        if rank is None or length <= 0:
            self.send_error(400)
            return
        try:  # the body goes straight into shm
            self.store.put_stream(rank, length, self.rfile.readinto)
        except Exception as e:  # noqa: BLE001 — answered as a 500, the sender logs it
            logger.warning("replica PUT of rank %s failed: %r", rank, e)
            self.send_error(500, str(e))
            return
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):  # noqa: N802
        if not self._authorized():
            return
        rank = self._rank()
        total = self.store.image_size(rank) if rank is not None else 0
        if not total:
            self.send_error(404)
            return
        # a PUT overwriting the slot mid-stream would serve a mixed image:
        # abort (a short body, which the client discards) instead
        gen = self.store.generation(rank)
        self.send_response(200)
        self.send_header("Content-Length", str(total))
        self.end_headers()
        off = 0
        while off < total:
            chunk = self.store.read_checked(rank, off, min(_CHUNK, total - off), gen)
            if chunk is None:
                logger.warning("replica GET of rank %s aborted: slot overwritten", rank)
                self.close_connection = True
                return
            if not chunk:
                break
            self.wfile.write(chunk)
            off += len(chunk)

    def log_message(self, fmt, *args):  # no line on stderr per request
        pass


class _Server(ThreadingHTTPServer):
    """Counts the requests in flight, so that a stop can wait for them."""

    daemon_threads = True
    block_on_close = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.active = 0
        self.idle = threading.Condition()

    def process_request_thread(self, request, client_address):
        with self.idle:
            self.active += 1
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self.idle:
                self.active -= 1
                self.idle.notify_all()


class ReplicaServer:
    """This host's replica endpoint (in the agent's saver)."""

    def __init__(self, store: ReplicaStore, port: int = 0):
        handler = type("BoundReplicaHandler", (_ReplicaHandler,), {"store": store})
        self._httpd = _Server(("0.0.0.0", port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
                                        daemon=True, name="ckpt-replica")

    def start(self) -> None:
        self._thread.start()
        logger.info("checkpoint replica server on :%s", self.port)

    def stop(self, timeout: float = 10.0) -> None:
        """Stop accepting, then wait at most ``timeout`` for the requests in
        flight (a handler's socket times out after 60 s of silence)."""
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout)
        self._httpd.server_close()
        deadline = time.monotonic() + timeout
        with self._httpd.idle:
            while self._httpd.active and time.monotonic() < deadline:
                self._httpd.idle.wait(deadline - time.monotonic())
            if self._httpd.active:
                logger.warning("replica server stopped with %s request(s) in flight",
                               self._httpd.active)


def _split(addr: str):
    host, port = addr.rsplit(":", 1)
    return host, int(port)


class ReplicaClient:
    """Push and fetch segment images to and from a peer's server."""

    @staticmethod
    def push(addr: str, owner_rank: int, total: int, read: Callable[[int, int], Any],
             timeout: Optional[float] = None) -> bool:
        """``PUT`` ``total`` bytes, ``read(offset, n)``, as ``owner_rank``'s
        image. The whole transfer has ``timeout`` seconds (None:
        ``ckpt_replica_timeout_s``). False on any failure: replication is
        best-effort, and the caller logs and drops it."""
        if timeout is None:
            timeout = get_context().ckpt_replica_timeout_s
        deadline = time.monotonic() + timeout
        conn = None
        try:
            conn = http.client.HTTPConnection(*_split(addr), timeout=timeout)
            conn.putrequest("PUT", f"/shard/{owner_rank}", skip_accept_encoding=True)
            conn.putheader("Content-Length", str(total))
            conn.putheader(_TOKEN_HEADER, _job_token())
            conn.endheaders()
            off = 0
            while off < total:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"push passed its {timeout:.0f} s deadline at {off}/{total}")
                conn.sock.settimeout(left)
                chunk = read(off, min(_CHUNK, total - off))
                if not len(chunk):
                    raise IOError(f"image source ended at {off}/{total}")
                conn.sock.sendall(chunk)
                off += len(chunk)
            conn.sock.settimeout(max(0.1, deadline - time.monotonic()))
            resp = conn.getresponse()
            resp.read()
            return resp.status == 200
        except Exception as e:  # noqa: BLE001 — best-effort, reported to the caller
            logger.warning("replica push to %s failed: %s", addr, e)
            return False
        finally:
            if conn is not None:
                conn.close()

    @staticmethod
    def fetch_stream(addr: str, owner_rank: int,
                     sink: Callable[[int, Callable[[memoryview], int]], None],
                     timeout: Optional[float] = None) -> bool:
        """``GET`` ``owner_rank``'s image from ``addr`` and hand it to
        ``sink(total, readinto)``, ``readinto`` the response body's; the
        whole transfer has ``timeout`` seconds.
        False when the peer has none or the transfer fails."""
        if timeout is None:
            timeout = get_context().ckpt_replica_timeout_s
        deadline = time.monotonic() + timeout
        conn = None
        try:
            conn = http.client.HTTPConnection(*_split(addr), timeout=timeout)
            conn.request("GET", f"/shard/{owner_rank}", headers={_TOKEN_HEADER: _job_token()})
            resp = conn.getresponse()
            total = int(resp.headers.get("Content-Length", 0))
            if resp.status != 200 or total <= 0:
                resp.read()
                return False

            def budget() -> None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"fetch passed its {timeout:.0f} s deadline")
                conn.sock.settimeout(left)

            def readinto(view) -> int:
                budget()
                return resp.readinto(view)

            sink(total, readinto)
            return True
        except Exception as e:  # noqa: BLE001 — the restore chain goes on to storage
            logger.warning("replica fetch from %s: %s", addr, e)
            return False
        finally:
            if conn is not None:
                conn.close()


class ReplicaManager:
    """The agent's replication driver: :meth:`replicate` pushes this host's
    image to its backup peer; :meth:`fetch_own_shard` recovers it from the
    peer that holds it."""

    def __init__(self, host_rank: int, num_hosts: int, master_client=None,
                 peers: Optional[Dict[int, str]] = None, advertise_host: Optional[str] = None):
        self.host_rank = host_rank
        self.num_hosts = num_hosts
        self.master_client = master_client
        self._static_peers = peers
        self.store = ReplicaStore()
        # made in start(): a fetch-only user (the engine restoring from a
        # peer) binds no port
        self.server: Optional[ReplicaServer] = None
        self._advertise_host = advertise_host or _local_host()

    def start(self) -> None:
        if self.server is None:
            self.server = ReplicaServer(self.store)
        self.server.start()
        self._register()

    def _register(self) -> None:
        if self.master_client is None or self.server is None:
            return
        addr = f"{self._advertise_host}:{self.server.port}"
        try:
            self.master_client.kv_store_set(f"{KV_PREFIX}{self.host_rank}", addr.encode())
        except Exception as e:  # noqa: BLE001 — peers then find no address and skip the push
            logger.warning("replica address registration failed: %r", e)

    def peer_addrs(self) -> Dict[int, str]:
        """Every registered peer's address, read from the KV store on each
        call (a replaced peer registers a new one)."""
        if self._static_peers is not None:
            return dict(self._static_peers)
        if self.master_client is None:
            return {}
        keys = [f"{KV_PREFIX}{r}" for r in range(self.num_hosts)]
        try:
            kvs = self.master_client.kv_store_multi_get(keys)
        except Exception as e:  # noqa: BLE001 — no peer this time
            logger.warning("replica peer lookup failed: %r", e)
            return {}
        out = {}
        for key, val in (kvs or {}).items():
            if val:
                out[int(key.rsplit("/", 1)[-1])] = val.decode()
        return out

    def replicate(self, total: int, read: Callable[[int, int], Any]) -> bool:
        """Push this host's image to its backup peer."""
        peer = backup_rank(self.host_rank, self.num_hosts)
        if peer == self.host_rank:
            return True  # one host: nothing to protect against
        addr = self.peer_addrs().get(peer)
        if not addr:
            logger.warning("no replica address for peer %s", peer)
            return False
        ok = ReplicaClient.push(addr, self.host_rank, total, read)
        if ok:
            logger.info("replicated shard of rank %s (%d bytes) to rank %s", self.host_rank,
                        total, peer)
        return ok

    def refill_shm(self, shm, storage) -> str:
        """Fetch this host's replica into ``shm`` (the caller holds the
        shard lock): ``empty`` (no replica, or unreadable), ``stale`` (the
        replica is older than storage's newest committed step, and is
        dropped, so that a breakpoint save cannot persist it behind the
        tracker) or ``refilled``."""
        if not self.fetch_own_shard(shm.write_image_stream):
            return "empty"
        meta = shm.read_meta()
        if meta is None:
            return "empty"
        storage_step = storage.latest_step()
        if storage_step is not None and storage_step > meta.step:
            logger.info("peer replica holds step %s but storage has %s; preferring storage",
                        meta.step, storage_step)
            shm.invalidate()
            return "stale"
        return "refilled"

    def fetch_own_shard(self, sink: Callable[[int, Callable[[memoryview], int]], None]) -> bool:
        """Recover this host's image from the one peer that can hold it,
        ``backup_rank(self)``."""
        holder = backup_rank(self.host_rank, self.num_hosts)
        if holder == self.host_rank:
            return False
        addr = self.peer_addrs().get(holder)
        if not addr:
            logger.warning("no replica address for holder %s", holder)
            return False
        t0 = time.monotonic()
        if ReplicaClient.fetch_stream(addr, self.host_rank, sink):
            logger.info("recovered shard of rank %s from peer %s at %s in %.3f s", self.host_rank,
                        holder, addr, time.monotonic() - t0)
            return True
        return False

    def stop(self, unlink: bool = False) -> None:
        """Stop serving, unregister the address (peers must not push to a
        dead endpoint) and close the store; ``unlink`` also removes the
        replicas held for peers."""
        if self.server is not None:
            self.server.stop()
            if self.master_client is not None:
                try:
                    self.master_client.kv_store_set(f"{KV_PREFIX}{self.host_rank}", b"")
                except Exception as e:  # noqa: BLE001 — the master may be gone at the end
                    logger.warning("replica address unregister failed: %r", e)
        if unlink:
            self.store.unlink()
        else:
            self.store.close()


def _local_host() -> str:
    """The address this node advertises for its replica endpoint: never a
    loopback when the machine has another, and never a job-wide override
    (every node would advertise one address)."""
    from ..common.platform import routable_host

    return routable_host()
