"""Filesystem storage with the done-file commit protocol: the port of
``dlrover_tpu/checkpoint/storage.py``, with the same layout, so each
package reads the steps the other persisted:

    <dir>/<step>/shard_<rank>.meta.json
    <dir>/<step>/shard_<rank>.bin
    <dir>/<step>/.done/shard_<rank>.done
    <dir>/<step>/commit_success
    <dir>/dlrover_latest.txt
    <dir>/.persist_error_<rank>
"""

import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import torch

from ..common.constants import CheckpointConstant
from ..common.log import logger
from .meta import CheckpointMeta, ShardRecord, assemble_global


class PosixCheckpointStorage:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- paths -------------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, str(step))

    def _done_dir(self, step: int) -> str:
        return os.path.join(self.step_dir(step), CheckpointConstant.DONE_DIR)

    def tracker_path(self) -> str:
        return os.path.join(self.root, CheckpointConstant.TRACKER_FILE)

    # -- writes ------------------------------------------------------------

    WRITE_CHUNK = 64 * 1024 * 1024

    def write_shard(self, meta: CheckpointMeta, payload) -> None:
        """``payload`` is the raw bytes or a reader ``(offset, nbytes)``
        streamed in chunks; a memoryview it returns is released after its
        chunk is written."""
        step_dir = self.step_dir(meta.step)
        os.makedirs(self._done_dir(meta.step), exist_ok=True)
        rank = meta.host_rank
        self._atomic_write(os.path.join(step_dir, f"shard_{rank}.meta.json"), meta.to_json().encode())
        bin_path = os.path.join(step_dir, f"shard_{rank}.bin")
        if callable(payload):
            self._atomic_write_stream(bin_path, payload, meta.total_bytes)
        else:
            self._atomic_write(bin_path, payload)
        self._atomic_write(os.path.join(self._done_dir(meta.step), f"shard_{rank}.done"), b"ok")

    def commit(self, step: int, num_shards: int) -> bool:
        """All shards done: write the commit marker and the tracker."""
        if not self.all_shards_done(step, num_shards):
            return False
        self._atomic_write(os.path.join(self.step_dir(step), CheckpointConstant.COMMIT_FILE), b"ok")
        self._atomic_write(self.tracker_path(), str(step).encode())
        logger.info("checkpoint step %s committed (%s shards)", step, num_shards)
        return True

    def _atomic_write_stream(self, path: str, reader, total_bytes: int) -> None:
        def write(f):
            offset = 0
            while offset < total_bytes:
                n = min(self.WRITE_CHUNK, total_bytes - offset)
                chunk = reader(offset, n)
                f.write(chunk)
                if isinstance(chunk, memoryview):
                    chunk.release()
                offset += n

        self._atomic(path, write)

    def _atomic_write(self, path: str, data: bytes) -> None:
        self._atomic(path, lambda f: f.write(data))

    @staticmethod
    def _atomic(path: str, write) -> None:
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d)
        try:
            with os.fdopen(fd, "wb") as f:
                write(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- persist error channel (saver -> blocked trainer) -------------------

    def _error_path(self, rank: int) -> str:
        return os.path.join(self.root, f".persist_error_{rank}")

    def record_persist_error(self, rank: int, step: int, reason: str) -> None:
        self._atomic_write(self._error_path(rank), f"{step}\n{reason}".encode())

    def clear_persist_error(self, rank: int) -> None:
        try:
            os.unlink(self._error_path(rank))
        except OSError:
            pass

    def persist_error(self, rank: int):
        """(step, reason) of the rank's last failed persist, or None."""
        try:
            with open(self._error_path(rank)) as f:
                step_line, _, reason = f.read().partition("\n")
                return int(step_line), reason
        except (FileNotFoundError, ValueError):
            return None

    # -- queries -----------------------------------------------------------

    def all_shards_done(self, step: int, num_shards: int) -> bool:
        done = self._done_dir(step)
        return os.path.isdir(done) and all(
            os.path.exists(os.path.join(done, f"shard_{r}.done")) for r in range(num_shards)
        )

    def committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(self.step_dir(step), CheckpointConstant.COMMIT_FILE))

    def latest_step(self) -> Optional[int]:
        """Newest restorable step. The tracker is a hint: one pointing at a
        step without ``commit_success`` (a crash inside the commit window, a
        swept step) gives way to the newest step that did commit."""
        try:
            with open(self.tracker_path()) as f:
                tracked: Optional[int] = int(f.read().strip())
        except (FileNotFoundError, ValueError):
            tracked = None
        if tracked is not None and self.committed(tracked):
            return tracked
        committed = self.list_steps()
        if not committed:
            return None
        if tracked is not None:
            logger.warning("checkpoint tracker points at uncommitted step %s; "
                           "falling back to committed step %s", tracked, committed[-1])
        return committed[-1]

    def list_steps(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
        return sorted(int(n) for n in os.listdir(self.root) if n.isdigit() and self.committed(int(n)))

    # -- reads -------------------------------------------------------------

    def read_shard_meta(self, step: int, rank: int) -> Optional[CheckpointMeta]:
        path = os.path.join(self.step_dir(step), f"shard_{rank}.meta.json")
        try:
            with open(path) as f:
                return CheckpointMeta.from_json(f.read())
        except FileNotFoundError:
            return None

    def read_shard_payload(self, step: int, rank: int, nbytes: int) -> Optional[torch.Tensor]:
        """The whole payload of one shard as a ``uint8`` tensor."""
        path = os.path.join(self.step_dir(step), f"shard_{rank}.bin")
        if not os.path.exists(path):
            return None
        out = torch.empty(nbytes, dtype=torch.uint8)
        with open(path, "rb") as f:
            got = f.readinto(out.numpy()) if nbytes else 0
        if got != nbytes:
            raise IOError(f"{path}: {got} of {nbytes} bytes")
        return out

    def load_step_host(self, step: int) -> Optional[Dict[str, torch.Tensor]]:
        """``{leaf path: global CPU tensor}`` from all shards of a step."""
        metas = []
        while True:
            meta = self.read_shard_meta(step, len(metas))
            if meta is None:
                break
            metas.append(meta)
        if not metas:
            return None
        by_path: Dict[str, List[ShardRecord]] = {}
        payloads = {}
        owner: Dict[int, int] = {}
        for meta in metas:
            payloads[meta.host_rank] = self.read_shard_payload(step, meta.host_rank, meta.total_bytes)
            if payloads[meta.host_rank] is None:
                return None
            for rec in meta.records:
                by_path.setdefault(rec.path, []).append(rec)
                owner[id(rec)] = meta.host_rank

        def record_read(rec: ShardRecord) -> torch.Tensor:
            return payloads[owner[id(rec)]][rec.offset : rec.offset + rec.nbytes]

        out = {}
        for path, records in by_path.items():
            # identical indices across hosts are replicas of one shard
            uniq = {}
            for rec in records:
                uniq.setdefault(tuple(map(tuple, rec.index)), rec)
            out[path] = assemble_global(list(uniq.values()), record_read)
        return out

    def remove_step(self, step: int) -> None:
        shutil.rmtree(self.step_dir(step), ignore_errors=True)

    # Uncommitted step dirs older than this are crash leftovers; younger
    # ones may be an in-flight write.
    STALE_PARTIAL_GRACE_S = 3600.0

    def keep_latest(self, count: int) -> None:
        """Keep the ``count`` most recently committed steps (by the commit
        marker's mtime, not the step number: a fresh run reusing a root
        that holds a stale higher-numbered history keeps its new commits),
        and sweep uncommitted step dirs older than the grace period."""
        if not os.path.isdir(self.root):
            return
        committed, partial = [], []
        for name in os.listdir(self.root):
            if not name.isdigit():
                continue
            step = int(name)
            marker = os.path.join(self.step_dir(step), CheckpointConstant.COMMIT_FILE)
            try:
                committed.append((os.path.getmtime(marker), step))
            except OSError:
                try:
                    partial.append((os.path.getmtime(self.step_dir(step)), step))
                except OSError:
                    pass
        committed.sort()
        keep = {step for _, step in committed[-count:]}
        tracked = self.latest_step()
        if tracked is not None:
            keep.add(tracked)  # never delete what the tracker points at
        for _, step in committed[:-count]:
            if step not in keep:
                self.remove_step(step)
        now = time.time()
        for mtime, step in partial:
            if now - mtime > self.STALE_PARTIAL_GRACE_S and step not in keep:
                logger.info("removing stale partial checkpoint step %s", step)
                self.remove_step(step)
