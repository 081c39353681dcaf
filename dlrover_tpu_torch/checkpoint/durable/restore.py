"""Restore from the durable tier: the port of
``dlrover_tpu/checkpoint/durable/restore.py``.

:func:`read_generation` is the host side of a restore, as in JAX:

1. find the newest committed generation (a torn tracker gives way to the
   newest commit marker) and take a GC lease on it;
2. check every shard's size and crc32 against the manifest before any of
   its content is read: a torn or rotted shard fails the restore;
3. assemble each leaf's global tensor from the saved shards through
   ``meta.assemble_global`` (records deduplicated by slice: a replicated
   leaf is saved whole by every host of the world);
4. release the lease.

The engine then copies the tensors into its template, whose tensors say
where each leaf lives. A lineage saved by a world of two reads in a world
of one, because every leaf of the port's data-parallel state is whole on
every rank. :func:`place_with_rules` and :func:`warm_start`, the
templateless placement on a mesh that may differ from the saved one,
need the port's ``parallel/sharding.py`` (a later slice) and raise
``not_ported`` until then.
"""

import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...common.platform import not_ported
from ..meta import CheckpointMeta, ShardRecord, assemble_global
from .layout import CHUNK, DurableLayout, GenerationManifest
from .layout import list_lineages as list_lineages  # re-exported for callers


class DurableShardError(RuntimeError):
    """A shard failed its checksum or size check."""


def verify_shards(layout: DurableLayout, step: int, manifest: GenerationManifest) -> None:
    """crc32 and size of every shard against the manifest."""
    for rank_s, rec in manifest.shards.items():
        rank = int(rank_s)
        path = layout.shard_bin_path(step, rank)
        crc = 0
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                while True:
                    block = f.read(CHUNK)
                    if not block:
                        break
                    crc = zlib.crc32(block, crc)
        except OSError as e:
            raise DurableShardError(f"durable shard {rank} of gen_{step} unreadable: {e}") from e
        if size != int(rec["nbytes"]) or crc != int(rec["checksum"]):
            raise DurableShardError(f"durable shard {rank} of gen_{step} failed verification: "
                                    f"size {size}/{rec['nbytes']}, crc {crc}/{rec['checksum']}")


def _dedupe_records(metas: Dict[int, CheckpointMeta]) -> Dict[str, List[Tuple[int, ShardRecord]]]:
    """Each leaf's records across the saved ranks, one per distinct slice
    (the first rank's)."""
    by_path: Dict[str, List[Tuple[int, ShardRecord]]] = {}
    seen = set()
    for rank in sorted(metas):
        for rec in metas[rank].records:
            key = (rec.path, tuple(tuple(i) for i in rec.index))
            if key in seen:
                continue
            seen.add(key)
            by_path.setdefault(rec.path, []).append((rank, rec))
    return by_path


def read_generation(root: str, lineage: str, step: Optional[int] = None, host_rank: int = 0,
                    verify: bool = True
                    ) -> Tuple[Optional[int], Optional[GenerationManifest], Dict[str, torch.Tensor],
                               Dict[str, Any]]:
    """``(step, manifest, {leaf path: global CPU tensor}, this host's
    extra)``; ``(None, None, {}, {})`` when the lineage has no committed
    generation (or ``step`` is not committed). Holds a GC lease while it
    reads."""
    layout = DurableLayout(root, lineage)
    if step is None:
        step = layout.latest_committed()
    if step is None or not layout.committed(step):
        return None, None, {}, {}
    token = layout.take_lease(step)
    files = {}
    try:
        manifest = layout.read_manifest(step)
        if manifest is None:
            raise DurableShardError(f"gen_{step} committed but its manifest is unreadable")
        if verify:
            verify_shards(layout, step, manifest)
        metas: Dict[int, CheckpointMeta] = {}
        for rank in range(manifest.num_hosts):
            with open(layout.shard_meta_path(step, rank)) as f:
                metas[rank] = CheckpointMeta.from_json(f.read())
        for rank in range(manifest.num_hosts):
            files[rank] = open(layout.shard_bin_path(step, rank), "rb")

        arrays: Dict[str, torch.Tensor] = {}
        for path, recs in _dedupe_records(metas).items():
            rank_of = {id(rec): rank for rank, rec in recs}

            def read(rec: ShardRecord) -> bytearray:
                f = files[rank_of[id(rec)]]
                f.seek(rec.offset)
                data = bytearray(rec.nbytes)
                if f.readinto(data) != rec.nbytes:
                    raise DurableShardError(f"gen_{step}: record {rec.path} is cut short")
                return data

            arrays[path] = assemble_global([rec for _, rec in recs], read)
        # host_local leaves: this host's extra from the same rank's shard; a
        # host beyond the saved world starts without one
        extra = dict(metas[host_rank].extra) if host_rank in metas else {}
        return step, manifest, arrays, extra
    finally:
        for f in files.values():
            try:
                f.close()
            except OSError:
                pass
        layout.release_lease(step, token)


def place_with_rules(manifest: GenerationManifest, arrays: Dict[str, torch.Tensor], mesh):
    """Templateless placement of a generation on ``mesh`` by the reshard
    rules: needs the port's ``parallel/sharding.py``."""
    raise not_ported("reshard on read under a mesh")


def warm_start(root: str, lineage: str, mesh, step: Optional[int] = None, host_rank: int = 0):
    """Another job's newest generation placed on this job's mesh without a
    template: needs :func:`place_with_rules`."""
    raise not_ported("reshard on read under a mesh")
