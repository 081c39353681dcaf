"""Shared-memory staging of torch state trees (the "flash" in flash
checkpoint): the port of ``dlrover_tpu/checkpoint/shm_handler.py``.

The trainer copies every leaf of its state into a POSIX shm segment; the
agent persists it to storage asynchronously. The segment holds the JAX
package's image, ``[u64 meta_len][meta JSON][payload]``, with the header
written last, so either package reads the other's.

A state tree nests NamedTuples, dicts, lists and tuples over tensors,
numpy arrays and Python scalars. Leaves are named by the ``/``-joined
path ``jax.tree_util.tree_flatten_with_path`` gives for the same nesting
(NamedTuple field names, dict keys in sorted order, sequence indices),
e.g. ``params/wte``, ``opt_state/mu/blocks.0.attn.wqkv`` or ``step``.
``None`` is an empty subtree, as in JAX.
"""

import contextlib
import mmap
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.log import logger
from ..common.multi_process import SharedMemorySegment
from .meta import (
    HEADER_LEN_BYTES,
    CheckpointMeta,
    ShardRecord,
    assemble_global,
    dtype_name,
)


# the unit a whole segment image is streamed in (replica pushes and fetches)
IMAGE_CHUNK = 8 << 20


def segment_image_size(segment: SharedMemorySegment) -> int:
    """Bytes of the image a segment holds, ``[8B meta_len][meta JSON]
    [payload]``; 0 when it holds none or a torn one."""
    if not segment.attach():
        return 0
    try:
        meta_len = int.from_bytes(segment.read(0, HEADER_LEN_BYTES), "little")
        if meta_len <= 0 or meta_len > segment.size:
            return 0
        meta = CheckpointMeta.from_json(segment.read(HEADER_LEN_BYTES, meta_len).decode())
    except (ValueError, TypeError, KeyError, UnicodeDecodeError) as e:
        logger.debug("shm size probe: %r", e)
        return 0
    total = HEADER_LEN_BYTES + meta_len + meta.total_bytes
    return total if total <= segment.size else 0


def stream_into_segment(segment: SharedMemorySegment, total: int,
                        readinto: Callable[[memoryview], int]) -> None:
    """Overwrite ``segment`` with a ``total``-byte image that
    ``readinto(view)`` streams straight into it (a binary stream's
    ``readinto``: the bytes it filled, 0 at the end). The 8-byte header is
    zeroed first and written last, so a stream that dies midway leaves a
    segment that reads as empty, never a new meta over a torn payload.
    Raises on a short stream (the header stays zero)."""
    if total <= HEADER_LEN_BYTES:
        raise ValueError(f"a segment image of {total} bytes has no meta")
    segment.ensure(total)
    buf = segment.buf
    buf[:HEADER_LEN_BYTES] = b"\x00" * HEADER_LEN_BYTES
    header = bytearray(HEADER_LEN_BYTES)
    with memoryview(header) as hview, memoryview(buf) as view:
        off = 0
        while off < total:
            dst = hview[off:] if off < HEADER_LEN_BYTES else view[off : min(total, off + IMAGE_CHUNK)]
            n = readinto(dst)
            if not n:
                raise IOError(f"segment image truncated at {off}/{total}")
            off += n
    buf[:HEADER_LEN_BYTES] = header


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's flattening order."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, sub in items:
        out += flatten_with_path(sub, prefix + (str(key),))
    return out


def map_with_path(tree: Any, fn: Callable[[str, Any], Any], prefix: Tuple[str, ...] = ()) -> Any:
    """``tree`` rebuilt with every leaf replaced by ``fn(path, leaf)``;
    containers keep their type and their own key order."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(v, fn, prefix + (k,)) for k, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return type(tree)((k, map_with_path(v, fn, prefix + (str(k),))) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(v, fn, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def leaf_tensor(leaf: Any) -> torch.Tensor:
    """The tensor a leaf is staged from: tensors as they are, numpy arrays
    and Python scalars as the CPU tensor ``np.asarray`` would make (a Python
    int is int64, a float float64)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, (bool, int, float, np.ndarray, np.generic)):
        return torch.from_numpy(np.array(leaf))
    raise TypeError(f"unsupported checkpoint leaf {type(leaf).__name__}")


def tensor_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a tensor, as a 1-D ``uint8`` tensor on its device."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def plan_records(pytree: Any) -> Tuple[List[ShardRecord], List[torch.Tensor], int]:
    """Records (offsets assigned, packed back to back), their source
    tensors, and the payload's byte count."""
    records, sources, offset = [], [], 0
    for path, leaf in flatten_with_path(pytree):
        t = leaf_tensor(leaf)
        shape = list(t.shape)
        nbytes = t.numel() * t.element_size()
        records.append(ShardRecord(
            path=path, global_shape=shape, local_shape=shape, dtype=dtype_name(t.dtype),
            index=[(0, d) for d in shape], offset=offset, nbytes=nbytes, spec=[],
        ))
        sources.append(t)
        offset += nbytes
    return records, sources, offset


def host_buffer(nbytes: int, current: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A ``uint8`` host buffer of at least ``nbytes``: ``current`` when it is
    large enough, else a new one, pinned when a GPU is present so that
    copies to and from the card run asynchronously at full rate."""
    if current is not None and current.numel() >= nbytes:
        return current
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=torch.cuda.is_available())


# ``staging`` arguments below: ``nbytes -> uint8 host tensor`` of at least
# that size, so a caller can keep one buffer across saves and restores.
Staging = Optional[Callable[[int], torch.Tensor]]


def copy_to_host(records: List[ShardRecord], sources: List[torch.Tensor], staging: Staging = None,
                 stream=None) -> torch.Tensor:
    """The payload of ``plan_records`` as one host ``uint8`` tensor from
    ``staging``: every source copied to its record's offset on ``stream``
    (the current stream when None), all copies queued before one
    synchronisation."""
    total = sum(rec.nbytes for rec in records)
    staged = (staging or host_buffer)(total)[:total]
    ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    with ctx:
        for rec, src in zip(records, sources):
            staged[rec.offset : rec.offset + rec.nbytes].copy_(tensor_bytes(src), non_blocking=True)
    device = next((t.device for t in sources if t.is_cuda), None)
    if device is not None:
        (stream or torch.cuda.current_stream(device)).synchronize()
    return staged


class SharedMemoryHandler:
    """One shm segment per host shard of the checkpoint."""

    # bytes a new segment has beyond the image it is made for
    META_RESERVE_BYTES = 1 << 20

    def __init__(self, host_rank: int = 0, name: str = ""):
        self.host_rank = host_rank
        self._segment = SharedMemorySegment(name or f"ckpt_shard_{host_rank}")
        self._faulted = None  # the mapping fault_in has read

    # -- trainer side ------------------------------------------------------

    def save_pytree(
        self,
        step: int,
        pytree: Any,
        num_hosts: int = 1,
        extra: Optional[Dict[str, Any]] = None,
        staging: Staging = None,
        stream=None,
        background: bool = False,
    ) -> CheckpointMeta:
        """Stage ``pytree`` as ``step``. With a leaf on the GPU, every leaf
        is first copied into a host buffer from ``staging``, laid out as the
        payload (:func:`copy_to_host` on ``stream``). Then
        :meth:`write_image`."""
        records, sources, _ = plan_records(pytree)
        chunks = [(rec.offset, src) for rec, src in zip(records, sources)]
        if any(t.is_cuda for t in sources):
            chunks = [(0, copy_to_host(records, sources, staging, stream))]
        return self.write_image(step, records, chunks, num_hosts, extra, background)

    def write_image(self, step: int, records: List[ShardRecord], chunks: List[Tuple[int, torch.Tensor]],
                    num_hosts: int = 1, extra: Optional[Dict[str, Any]] = None,
                    background: bool = False) -> CheckpointMeta:
        """Write the image of ``records`` whose payload is ``chunks``, pairs
        of (payload offset, CPU tensor of the bytes there). The header is
        written last, so a writer killed midway leaves an image that reads
        as absent. The copy into shm runs on torch's threads, or with
        ``background`` (the trainer keeps stepping meanwhile) on this
        thread alone: torch's copy takes every core and would starve the
        training thread of the host."""
        total = sum(rec.nbytes for rec in records)
        meta = CheckpointMeta(step=step, host_rank=self.host_rank, num_hosts=num_hosts,
                              records=records, total_bytes=total, timestamp=time.time(),
                              extra=extra or {})
        meta_bytes = meta.to_json().encode()
        base = HEADER_LEN_BYTES + len(meta_bytes)
        # room for a longer meta (more step digits, another timestamp) in
        # the next image: regrowing the segment maps every page anew
        self._segment.ensure(base + total, reserve=self.META_RESERVE_BYTES)
        buf = self._segment.buf
        buf[:HEADER_LEN_BYTES] = b"\x00" * HEADER_LEN_BYTES
        buf[HEADER_LEN_BYTES:base] = meta_bytes
        if total:
            payload = np.frombuffer(buf, dtype=np.uint8, count=total, offset=base)
            for offset, src in chunks:
                src = tensor_bytes(src)
                dst = payload[offset : offset + src.numel()]
                if background:
                    dst[...] = src.numpy()  # numpy: one thread, without the GIL
                else:
                    torch.from_numpy(dst).copy_(src)
            del payload, dst  # release the exported pointers before the header lands
        buf[:HEADER_LEN_BYTES] = len(meta_bytes).to_bytes(HEADER_LEN_BYTES, "little")
        return meta

    # -- agent / loader side ----------------------------------------------

    def attach(self) -> bool:
        return self._segment.attach()

    def fault_in(self) -> int:
        """Read one byte of each page of the segment once per mapping, so
        that later reads of this process do not fault: the first read of a
        page of a fresh mapping does, and a reader under the shard lock
        would otherwise pay every fault inside its hold. Returns the pages
        read: 0 when this mapping was read already or there is no
        segment."""
        if not self._segment.attach():
            return 0
        mapping = self._segment._shm
        if mapping is self._faulted:
            return 0
        pages = np.frombuffer(self._segment.buf, dtype=np.uint8)[:: mmap.PAGESIZE]
        try:
            pages.max(initial=0)
            count = pages.size
        finally:
            del pages
        self._faulted = mapping
        return count

    def _meta_len(self) -> int:
        return int.from_bytes(self._segment.read(0, HEADER_LEN_BYTES), "little")

    def read_meta(self) -> Optional[CheckpointMeta]:
        if not self._segment.attach():
            return None
        try:
            meta_len = self._meta_len()
            if meta_len <= 0 or meta_len > self._segment.size:
                return None
            return CheckpointMeta.from_json(self._segment.read(HEADER_LEN_BYTES, meta_len).decode())
        except (ValueError, TypeError, KeyError, UnicodeDecodeError):
            logger.exception("unreadable checkpoint shm meta")
            return None

    def payload_reader(self, copy: bool = True) -> Optional[Callable[[int, int], Any]]:
        """Reader ``(offset, nbytes)`` over the payload. With ``copy=False``
        it returns memoryviews into the segment, valid while the segment
        stays mapped and unmodified (hold the shard lock) and to be
        released by the caller."""
        if self.read_meta() is None:
            return None
        base = HEADER_LEN_BYTES + self._meta_len()
        if copy:
            return lambda offset, nbytes: self._segment.read(base + offset, nbytes)
        buf = self._segment.buf
        return lambda offset, nbytes: buf[base + offset : base + offset + nbytes]

    def load_pytree_host(
        self, copy: bool = True, staging: Staging = None
    ) -> Optional[Tuple[CheckpointMeta, Dict[str, torch.Tensor]]]:
        """``(meta, {leaf path: CPU tensor})`` from this host's shm. With
        ``copy=True`` the payload is copied once into a host buffer from
        ``staging`` and the tensors are views of it; with ``copy=False``
        they are views of the segment (hold the shard lock while using
        them)."""
        meta = self.read_meta()
        if meta is None:
            return None
        base = HEADER_LEN_BYTES + self._meta_len()
        total = meta.total_bytes
        if base + total > self._segment.size:
            logger.warning("shm image of step %s is truncated", meta.step)
            return None
        seg = torch.from_numpy(np.frombuffer(self._segment.buf, dtype=np.uint8, count=total, offset=base)) \
            if total else torch.empty(0, dtype=torch.uint8)
        if copy:
            payload = (staging or host_buffer)(total)[:total]
            payload.copy_(seg)
            del seg
        else:
            payload = seg
        by_path: Dict[str, List[ShardRecord]] = {}
        for rec in meta.records:
            by_path.setdefault(rec.path, []).append(rec)
        out = {
            path: assemble_global(recs, lambda r: payload[r.offset : r.offset + r.nbytes])
            for path, recs in by_path.items()
        }
        return meta, out

    def image_size(self) -> int:
        """Bytes of the staged image, header and meta included; 0 when
        empty."""
        return segment_image_size(self._segment)

    def image_reader(self) -> Optional[Callable[[int, int], memoryview]]:
        """Reader ``(offset, nbytes)`` of memoryviews over the whole image,
        header and meta included; valid while the segment stays mapped and
        unmodified (hold the shard lock), each view released by the caller.
        None when there is no image."""
        if not self.image_size():
            return None
        buf = self._segment.buf
        return lambda offset, nbytes: buf[offset : offset + nbytes]

    def read_image(self, offset: int, nbytes: int) -> bytes:
        return self._segment.read(offset, nbytes)

    def write_image_stream(self, total: int, readinto: Callable[[memoryview], int]) -> None:
        """Overwrite the segment with a ``total``-byte image streamed by
        ``readinto`` (a peer's replica), torn-write safe
        (:func:`stream_into_segment`)."""
        stream_into_segment(self._segment, total, readinto)

    def invalidate(self) -> None:
        """Zero the header, so the staged image reads as absent (a stale
        replica that a breakpoint save must not persist)."""
        if self._segment.attach():
            buf = self._segment.buf
            if buf is not None and len(buf) >= HEADER_LEN_BYTES:
                buf[:HEADER_LEN_BYTES] = b"\x00" * HEADER_LEN_BYTES

    def close(self) -> None:
        self._segment.close()

    def unlink(self) -> None:
        self._segment.unlink()
