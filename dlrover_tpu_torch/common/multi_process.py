"""Local inter-process primitives: the port of
``dlrover_tpu/common/multi_process.py``.

The agent (per-host supervisor) owns the server side of each primitive
over a unix domain socket; the training process connects as a client.
Checkpoint bytes go through POSIX shared memory; control goes through
these sockets. Socket, segment and namespace names are the JAX package's,
so the two packages find each other's segments.

Two differences from the JAX module:

- frames are a 4-byte length prefix and a JSON body (standard library
  only; the JAX module frames with msgpack), so every request, reply and
  queue item is a JSON value;
- every wait is bounded. A client call waits at most its own deadline for
  the reply (``timeout`` plus the server-side wait the operation asked
  for), lock and queue operations take finite timeouts (``None`` means
  the default deadline, never "forever"), and server threads poll their
  sockets so that ``stop`` ends them. The JAX module's ``put`` during
  saver shutdown could wait forever for a reply.
"""

import hashlib
import json
import os
import queue as _queue
import socket
import struct
import tempfile
import threading
import time
import uuid
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Dict, List, Optional

from .log import logger

SOCKET_TMP_DIR = os.getenv(
    "DLROVER_IPC_DIR", os.path.join(tempfile.gettempdir(), "dlrover_tpu", "sockets")
)

_LEN = struct.Struct("!I")
# How often a server thread wakes to check whether it was stopped.
POLL_S = 0.5
# Deadline of a client call beyond the server-side wait it asked for.
CALL_TIMEOUT_S = 60.0
# Default bound of a blocking lock acquire or queue get/put.
DEFAULT_WAIT_S = 600.0


def _ipc_namespace() -> str:
    """Machine-local IPC namespace: DLROVER_IPC_NAMESPACE when set (several
    simulated hosts of one job on one machine), else the job name."""
    return os.getenv("DLROVER_IPC_NAMESPACE") or os.getenv(
        "DLROVER_JOB_NAME", "local"
    )


def _socket_path(name: str) -> str:
    os.makedirs(SOCKET_TMP_DIR, exist_ok=True)
    fname = f"{_ipc_namespace()}_{name}.sock"
    path = os.path.join(SOCKET_TMP_DIR, fname)
    # AF_UNIX sun_path is limited to ~108 bytes; hash long names down.
    if len(path) > 100:
        digest = hashlib.sha1(fname.encode()).hexdigest()[:16]
        path = os.path.join(SOCKET_TMP_DIR, f"s_{digest}.sock")
    if len(path) > 100:
        # the directory alone is too long: a short name keyed by the full path
        digest = hashlib.sha1(os.path.join(SOCKET_TMP_DIR, fname).encode()).hexdigest()[:24]
        path = os.path.join(tempfile.gettempdir(), f"dlrover_s_{digest}.sock")
    return path


def _bounded_wait(timeout: Optional[float]) -> float:
    return DEFAULT_WAIT_S if timeout is None or timeout < 0 else float(timeout)


def _send_frame(sock: socket.socket, payload: Dict[str, Any]) -> None:
    data = json.dumps(payload).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int, deadline: Optional[float], stopped=None) -> bytes:
    """``n`` bytes from ``sock``, whose timeout is the poll interval. Raises
    TimeoutError past ``deadline``; while no byte has arrived and
    ``deadline`` is None, waits until ``stopped()`` says to give up."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if deadline is None and buf:
                deadline = time.monotonic() + CALL_TIMEOUT_S  # a frame began
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("no reply within the deadline") from None
            if stopped is not None and stopped():
                raise ConnectionError("server stopped") from None
            continue
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket, deadline: Optional[float], stopped=None) -> Dict[str, Any]:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size, deadline, stopped))
    body_deadline = deadline if deadline is not None else time.monotonic() + CALL_TIMEOUT_S
    return json.loads(_recv_exact(sock, length, body_deadline, stopped))


class LocalSocketServer:
    """Threaded unix-socket server dispatching ``{"m": method, "a": args}``
    to ``op_<method>``."""

    # Methods whose semantics are bound to the connection (lock ownership)
    # re-execute on retransmit instead of replaying a cached reply.
    UNCACHED_METHODS: frozenset = frozenset()

    def __init__(self, name: str):
        self.name = name
        self.path = _socket_path(name)
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(64)
        self._sock.settimeout(POLL_S)
        self._stopped = False
        self._resp_cache: Dict[str, Dict[str, Any]] = {}
        self._cache_lock = threading.Lock()
        self._conn_local = threading.local()
        self._thread = threading.Thread(
            target=self._accept_loop, name=f"ipc-{name}", daemon=True
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(POLL_S)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _stopped_now(self) -> bool:
        return self._stopped

    def _serve_conn(self, conn: socket.socket) -> None:
        conn_id = id(conn)
        # At-most-once execution: a cache entry is installed before
        # dispatch, so a retransmit arriving while the original still runs
        # waits for it instead of running the operation twice (which would
        # drop a queue item).
        try:
            with conn:
                while not self._stopped:
                    try:
                        req = _recv_frame(conn, None, self._stopped_now)
                    except (ConnectionError, OSError, ValueError):
                        return
                    cid, seq = req.get("cid"), req.get("seq")
                    entry = None
                    if cid is not None and req["m"] not in self.UNCACHED_METHODS:
                        with self._cache_lock:
                            cached = self._resp_cache.get(cid)
                            if cached is not None and cached["seq"] == seq:
                                entry = cached
                            else:
                                entry = {"seq": seq, "done": threading.Event(),
                                         "resp": None, "mine": True}
                                self._resp_cache[cid] = entry
                                while len(self._resp_cache) > 4096:
                                    oldest = next(iter(self._resp_cache))
                                    if oldest == cid:
                                        break
                                    self._resp_cache.pop(oldest, None)
                        if not entry.get("mine"):
                            entry["done"].wait(timeout=DEFAULT_WAIT_S + CALL_TIMEOUT_S)
                            resp = entry["resp"] or {
                                "ok": False, "err": "original request still in flight"}
                            try:
                                _send_frame(conn, resp)
                                continue
                            except OSError:
                                return
                        entry["mine"] = False
                    try:
                        resp = {"ok": True, "r": self._dispatch(req["m"], req.get("a") or {}, conn_id)}
                    except Exception as e:  # noqa: BLE001 — reported to the client
                        resp = {"ok": False, "err": repr(e)}
                    if entry is not None:
                        entry["resp"] = resp
                        entry["done"].set()
                    try:
                        _send_frame(conn, resp)
                    except OSError:
                        return
        finally:
            self._on_conn_closed(conn_id)

    def _on_conn_closed(self, conn_id: int) -> None:
        """Hook: subclasses release per-connection resources (locks)."""

    def _dispatch(self, method: str, args: Dict[str, Any], conn_id: int) -> Any:
        fn = getattr(self, "op_" + method, None)
        if fn is None:
            raise ValueError(f"unknown method {method}")
        self._conn_local.conn_id = conn_id
        return fn(**args)

    def stop(self) -> None:
        self._stopped = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)  # wakes a blocked accept()
        except OSError:
            pass
        try:
            self._sock.close()
        finally:
            try:
                os.unlink(self.path)
            except OSError:
                pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=2 * POLL_S + 1.0)


class LocalSocketClient:
    """Client for :class:`LocalSocketServer`; reconnects lazily. A call
    waits at most ``timeout`` plus the server-side wait it asked for."""

    def __init__(self, name: str, timeout: float = CALL_TIMEOUT_S):
        self.name = name
        self.path = _socket_path(name)
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._cid = uuid.uuid4().hex
        self._seq = 0

    def _connect(self, deadline: float) -> socket.socket:
        while True:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.settimeout(POLL_S)
                s.connect(self.path)
                return s
            except (FileNotFoundError, ConnectionRefusedError):
                s.close()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"IPC server {self.name} unavailable") from None
                time.sleep(0.1)

    def _drop(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def call(self, method: str, _wait_s: float = 0.0, **args: Any) -> Any:
        deadline = time.monotonic() + self._timeout + _wait_s
        if not self._lock.acquire(timeout=max(0.0, deadline - time.monotonic())):
            raise TimeoutError(f"IPC {self.name}.{method}: client busy past the deadline")
        try:
            self._seq += 1
            req = {"m": method, "a": args, "cid": self._cid, "seq": self._seq}
            for attempt in (0, 1):
                if self._sock is None:
                    self._sock = self._connect(deadline)
                try:
                    _send_frame(self._sock, req)
                    resp = _recv_frame(self._sock, deadline)
                    break
                except TimeoutError:
                    # a late reply would desynchronise the stream
                    self._drop()
                    raise
                except (ConnectionError, OSError):
                    self._drop()
                    if attempt == 1:
                        raise
        finally:
            self._lock.release()
        if not resp["ok"]:
            raise RuntimeError(f"IPC {self.name}.{method}: {resp['err']}")
        return resp["r"]

    def available(self) -> bool:
        """True only if a server is accepting on the socket (a socket file
        left by a SIGKILLed server reads as unavailable)."""
        if not os.path.exists(self.path):
            return False
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.settimeout(2.0)
            s.connect(self.path)
            return True
        except OSError:
            return False
        finally:
            s.close()

    def close(self) -> None:
        if self._lock.acquire(timeout=self._timeout):
            try:
                self._drop()
            finally:
                self._lock.release()


# ---------------------------------------------------------------------------
# SharedLock
# ---------------------------------------------------------------------------


class SharedLockServer(LocalSocketServer):
    """Lock with reentrancy (hold count) and death-of-holder release: when
    the holding client's connection drops (its process died), the lock is
    force-released, so the agent draining a checkpoint after a trainer crash
    never deadlocks."""

    UNCACHED_METHODS = frozenset({"acquire", "release", "locked"})

    def __init__(self, name: str):
        # state before super().__init__, which starts the accept thread
        self._locked_by: Optional[str] = None
        self._holder_conn: Optional[int] = None
        self._hold_count = 0
        self._cond = threading.Condition()
        super().__init__("lock_" + name)

    def op_acquire(self, owner: str, blocking: bool = True, timeout: float = DEFAULT_WAIT_S) -> bool:
        conn_id = self._conn_local.conn_id
        deadline = time.monotonic() + _bounded_wait(timeout)
        with self._cond:
            while self._locked_by is not None and self._locked_by != owner:
                remaining = deadline - time.monotonic()
                if not blocking or remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 1.0))
            self._locked_by = owner
            self._holder_conn = conn_id
            self._hold_count += 1
            return True

    def op_release(self, owner: str) -> bool:
        with self._cond:
            if self._locked_by != owner:
                return False
            self._hold_count -= 1
            if self._hold_count <= 0:
                self._locked_by = None
                self._holder_conn = None
                self._hold_count = 0
                self._cond.notify_all()
            return True

    def op_locked(self) -> bool:
        with self._cond:
            return self._locked_by is not None

    def _on_conn_closed(self, conn_id: int) -> None:
        with self._cond:
            if self._holder_conn == conn_id and self._locked_by is not None:
                logger.warning("lock %s force-released: holder %s connection dropped",
                               self.name, self._locked_by)
                self._locked_by = None
                self._holder_conn = None
                self._hold_count = 0
                self._cond.notify_all()


class SharedLock:
    """Cross-process lock; ``name`` scopes it within the job. Reentrant per
    owner (this object in this process)."""

    def __init__(self, name: str, create: bool = False):
        self.name = name
        self._server = SharedLockServer(name) if create else None
        self._client = LocalSocketClient("lock_" + name)
        self._owner = f"{os.getpid()}_{id(self)}"

    def acquire(self, blocking: bool = True, timeout: Optional[float] = DEFAULT_WAIT_S) -> bool:
        timeout = _bounded_wait(timeout)
        return self._client.call("acquire", _wait_s=timeout if blocking else 0.0,
                                 owner=self._owner, blocking=blocking, timeout=timeout)

    def release(self) -> bool:
        return self._client.call("release", owner=self._owner)

    def locked(self) -> bool:
        return self._client.call("locked")

    def __enter__(self):
        if not self.acquire():
            raise TimeoutError(f"lock {self.name} not acquired within {DEFAULT_WAIT_S} s")
        return self

    def __exit__(self, *exc):
        self.release()

    def close(self) -> None:
        self._client.close()
        if self._server:
            self._server.stop()


# ---------------------------------------------------------------------------
# SharedQueue
# ---------------------------------------------------------------------------


class SharedQueueServer(LocalSocketServer):
    def __init__(self, name: str, maxsize: int = 0):
        self._queue: "_queue.Queue[Any]" = _queue.Queue(maxsize)
        super().__init__("queue_" + name)

    def op_put(self, item: Any, block: bool = True, timeout: float = DEFAULT_WAIT_S) -> bool:
        try:
            self._queue.put(item, block=block, timeout=_bounded_wait(timeout))
            return True
        except _queue.Full:
            return False

    def op_get(self, block: bool = True, timeout: float = 1.0) -> Dict[str, Any]:
        try:
            return {"found": True, "item": self._queue.get(block=block, timeout=_bounded_wait(timeout))}
        except _queue.Empty:
            return {"found": False, "item": None}


class SharedQueue:
    """Cross-process FIFO of JSON values."""

    def __init__(self, name: str, create: bool = False, maxsize: int = 0):
        self.name = name
        self._server = SharedQueueServer(name, maxsize) if create else None
        self._client = LocalSocketClient("queue_" + name)

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = DEFAULT_WAIT_S) -> bool:
        timeout = _bounded_wait(timeout)
        return self._client.call("put", _wait_s=timeout if block else 0.0,
                                 item=item, block=block, timeout=timeout)

    def get(self, block: bool = True, timeout: Optional[float] = DEFAULT_WAIT_S) -> Any:
        """The next item; raises ``queue.Empty`` past ``timeout``. Polls with
        short server-side waits so one slow get does not pin the
        connection."""
        deadline = time.monotonic() + _bounded_wait(timeout)
        while True:
            chunk = min(1.0, max(0.0, deadline - time.monotonic())) if block else 0.0
            resp = self._client.call("get", _wait_s=chunk, block=block, timeout=chunk)
            if resp["found"]:
                return resp["item"]
            if not block or time.monotonic() >= deadline:
                raise _queue.Empty

    def available(self) -> bool:
        """True while a server accepts on this queue's socket, i.e. while
        the owning process is alive."""
        return self._client.available()

    def close(self) -> None:
        self._client.close()
        if self._server:
            self._server.stop()


# ---------------------------------------------------------------------------
# Shared memory
# ---------------------------------------------------------------------------


def _shm_name(name: str) -> str:
    return f"dlrover_{_ipc_namespace()}_{name}"


# Mappings whose close() hit "BufferError: cannot close exported pointers
# exist" (a live view still references the mmap). Quarantined with a strong
# reference so SharedMemory.__del__ never raises an unraisable BufferError;
# retried when the next mapping closes. Guarded: concurrent close() calls
# must not lose an entry in the sweep's rewrite.
_UNCLOSEABLE: List[shared_memory.SharedMemory] = []
_UNCLOSEABLE_LOCK = threading.Lock()


def _sweep_uncloseable() -> None:
    with _UNCLOSEABLE_LOCK:
        still = []
        for shm in _UNCLOSEABLE:
            try:
                shm.close()
            except BufferError:
                still.append(shm)
        _UNCLOSEABLE[:] = still


class SharedMemorySegment:
    """POSIX shared-memory segment with create-or-attach-and-resize
    semantics. The trainer stages checkpoint bytes here and the agent
    drains them; the agent owns its lifetime through :meth:`unlink`."""

    def __init__(self, name: str):
        self.name = _shm_name(name)
        self._shm: Optional[shared_memory.SharedMemory] = None
        self._ino: Optional[int] = None

    @staticmethod
    def _untrack(shm: shared_memory.SharedMemory) -> None:
        # CPython's resource tracker unlinks "leaked" segments when the
        # creating process exits, which would destroy a staged checkpoint
        # exactly when the trainer crashes.
        try:
            resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
        except Exception as e:  # noqa: BLE001 — tracker implementation varies
            logger.debug("resource tracker unregister: %r", e)

    @staticmethod
    def _posix_unlink(shm: shared_memory.SharedMemory) -> None:
        # SharedMemory.unlink() would unregister from the tracker a second
        # time (the tracker daemon then prints KeyErrors).
        try:
            shared_memory._posixshmem.shm_unlink(shm._name)  # noqa: SLF001
        except FileNotFoundError:
            pass

    def _path(self) -> str:
        return os.path.join("/dev/shm", self.name)

    def _file_ino(self) -> Optional[int]:
        try:
            return os.stat(self._path()).st_ino
        except OSError:
            return None

    def _record_ino(self) -> None:
        fd = getattr(self._shm, "_fd", -1)
        try:
            self._ino = os.fstat(fd).st_ino if fd >= 0 else self._file_ino()
        except OSError:
            self._ino = self._file_ino()

    @property
    def size(self) -> int:
        return self._shm.size if self._shm else 0

    @property
    def buf(self):
        return self._shm.buf if self._shm else None

    def ensure(self, size: int, reserve: int = 0) -> None:
        """Create the segment, growing (recreating) it if too small. A
        segment made here holds ``reserve`` bytes beyond ``size``."""
        if self._shm is not None and self._shm.size >= size:
            return
        if self._shm is not None:
            self.unlink()
        try:
            self._shm = shared_memory.SharedMemory(name=self.name, create=True, size=size + reserve)
        except FileExistsError:
            existing = shared_memory.SharedMemory(name=self.name)
            self._untrack(existing)
            if existing.size >= size:
                self._shm = existing
            else:
                existing.close()
                self._posix_unlink(existing)
                self._shm = shared_memory.SharedMemory(name=self.name, create=True,
                                                       size=size + reserve)
        self._untrack(self._shm)
        self._record_ino()

    def attach(self) -> bool:
        if self._shm is not None:
            # The creator may have grown the segment (unlink + recreate
            # under the same name); a cached mapping would then read the
            # orphaned old segment. Detect it by the inode.
            if self._ino is not None and self._file_ino() == self._ino:
                return True
            self.close()
        try:
            self._shm = shared_memory.SharedMemory(name=self.name)
        except FileNotFoundError:
            return False
        self._untrack(self._shm)
        self._record_ino()
        return True

    def read(self, offset: int, length: int) -> bytes:
        if self._shm is None:
            raise RuntimeError(f"segment {self.name} is not mapped")
        return bytes(self._shm.buf[offset : offset + length])

    @staticmethod
    def _close_or_quarantine(shm: shared_memory.SharedMemory) -> None:
        """Close a mapping; never raise. A mapping with live exported views
        goes to the quarantine list."""
        _sweep_uncloseable()
        try:
            shm.close()
        except BufferError:
            with _UNCLOSEABLE_LOCK:
                _UNCLOSEABLE.append(shm)

    def close(self) -> None:
        if self._shm is not None:
            shm, self._shm = self._shm, None
            self._close_or_quarantine(shm)

    def unlink(self) -> None:
        if self._shm is None and not self.attach():
            return
        shm, self._shm = self._shm, None
        self._ino = None
        self._close_or_quarantine(shm)
        self._posix_unlink(shm)
