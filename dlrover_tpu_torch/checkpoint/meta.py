"""Checkpoint metadata: the port of ``dlrover_tpu/checkpoint/meta.py``.

The records and their JSON are the JAX package's, so each package reads
the other's images: a record names its leaf by the ``/``-joined path, the
leaf's global and local shape, its dtype as the numpy name (``"float32"``,
``"bfloat16"``, ``"int64"``), the slice of the global array it holds and
its byte range in the payload. ``spec`` (the sharding) stays ``[]`` until
the port shards its state.

Payload bytes move as ``uint8`` tensors viewed as the record's dtype:
numpy has no bfloat16 of its own, so the port never goes through
``np.dtype(record.dtype)``.
"""

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Tuple

import torch

HEADER_LEN_BYTES = 8  # u64 little-endian length of the JSON meta block

_TORCH_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a record's numpy dtype name."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported checkpoint dtype {name!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name the JAX package writes for a torch dtype."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"unsupported checkpoint dtype {dtype}") from None


@dataclass
class ShardRecord:
    """One shard of one leaf, staged at ``offset`` of the payload."""

    path: str  # "/"-joined key path
    global_shape: List[int]
    local_shape: List[int]
    dtype: str  # numpy dtype name
    # [(start, stop) per dim] of this shard within the global array
    index: List[Tuple[int, int]]
    offset: int
    nbytes: int
    spec: List[Any] = field(default_factory=list)

    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in self.index)


@dataclass
class CheckpointMeta:
    step: int = 0
    host_rank: int = 0
    num_hosts: int = 1
    mesh_axes: List[str] = field(default_factory=list)
    mesh_shape: List[int] = field(default_factory=list)
    records: List[ShardRecord] = field(default_factory=list)
    total_bytes: int = 0
    timestamp: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, data: str) -> "CheckpointMeta":
        raw = json.loads(data)
        records = [
            ShardRecord(**{**r, "index": [tuple(i) for i in r["index"]]})
            for r in raw.pop("records", [])
        ]
        return cls(records=records, **raw)


def typed_view(buf: torch.Tensor, dtype: str, shape: List[int]) -> torch.Tensor:
    """A 1-D ``uint8`` tensor read as ``dtype`` of ``shape``, without a copy
    where the offset allows it. Records are packed back to back, so a leaf
    may start at an offset its element size does not divide: such a leaf is
    copied once to an aligned tensor."""
    dt = torch_dtype(dtype)
    if buf.numel() == 0:
        return torch.empty(shape, dtype=dt)
    itemsize = torch.empty((), dtype=dt).element_size()
    if buf.storage_offset() % itemsize:
        buf = buf.clone()
    return buf.view(dt).reshape(shape)


def as_uint8(data) -> torch.Tensor:
    """A 1-D ``uint8`` tensor over ``data``: a tensor is returned as is,
    a writable buffer (bytearray, memoryview of shared memory) is wrapped
    without a copy, read-only bytes are copied."""
    if isinstance(data, torch.Tensor):
        return data
    if isinstance(data, bytes):
        data = bytearray(data)
    if len(data) == 0:
        return torch.empty(0, dtype=torch.uint8)
    return torch.frombuffer(data, dtype=torch.uint8)


def assemble_global(records: List[ShardRecord], record_read) -> torch.Tensor:
    """One leaf's global tensor from its records.

    ``record_read(rec)`` returns one record's payload (a ``uint8`` tensor,
    or any buffer :func:`as_uint8` takes). A single record covering the
    whole leaf is returned as a view of that payload; the caller keeps the
    backing memory alive while it uses the result.
    """
    if not records:
        raise ValueError("no records for leaf")
    head = records[0]
    if len(records) == 1:
        covers = (not head.index) or all(
            a == 0 and b == dim for (a, b), dim in zip(head.index, head.global_shape)
        )
        if covers:
            return typed_view(as_uint8(record_read(head)), head.dtype, head.global_shape)
    out = torch.empty(head.global_shape, dtype=torch_dtype(head.dtype))
    total = math.prod(head.global_shape)
    covered = 0
    full_write = False
    for rec in records:
        block = typed_view(as_uint8(record_read(rec)), rec.dtype, rec.local_shape)
        if rec.index:
            out[rec.slices()] = block
            covered += math.prod(rec.local_shape)
        else:
            out[...] = block
            full_write = True
    # Records are disjoint, so a volume sum equals full coverage.
    if not full_write and covered != total:
        raise ValueError(
            f"incomplete shard coverage for leaf {head.path}: {covered}/{total} elements"
        )
    return out
