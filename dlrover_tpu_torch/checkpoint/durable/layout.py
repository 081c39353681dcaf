"""On-disk layout of the durable checkpoint tier: the port of
``dlrover_tpu/checkpoint/durable/layout.py``, byte for byte the same tree,
so each package lists, verifies and reads the other's generations.

One durable root holds many *lineages* (one per family of training runs,
the key a later job warm-starts from); a lineage holds *generations* (one
per persisted step), each the flash tier's sharded layout behind a
two-phase commit:

    <root>/<lineage>/gen_<step>/shard_<rank>.meta.json
    <root>/<lineage>/gen_<step>/shard_<rank>.bin
    <root>/<lineage>/gen_<step>/.done/shard_<rank>.done   (phase 1)
    <root>/<lineage>/gen_<step>/manifest.json             (phase 2)
    <root>/<lineage>/gen_<step>/commit_success            (phase 2)
    <root>/<lineage>/LATEST                               (tracker)
    <root>/<lineage>/pins/<step>.pin                      (GC keep)
    <root>/<lineage>/leases/gen_<step>/<token>.lease      (GC shield)

Beyond the flash tier: each shard's crc32 is in its done file and in the
manifest, so a restore rejects a torn or rotted shard before it reads
state from it; the commit marker follows a barrier over every host's done
file, so no reader sees a torn generation; the manifest records each
leaf's save-time sharding by category (``spec_to_jsonable``'s form: the
port's leaves are whole on every rank of a data-parallel world, so each
spec is ``[]``, replicated) and a snapshot of the reshard rules.

``RESHARD_RULES``, ``category_of_path`` and ``validate_saved_spec`` are
the port's copies of ``dlrover_tpu/parallel/sharding.py``'s, which the
manifest and the restore's check need; the port's sharding module (the
parallel layouts) is a later slice.
"""

import json
import os
import uuid
import zlib
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ...common.log import logger
from ..meta import CheckpointMeta
from ..storage import PosixCheckpointStorage

# category: (policy, mesh axes the category's shardings may name), as in
# dlrover_tpu/parallel/sharding.py
RESHARD_RULES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "step": ("replicate", ()),
    "params": ("respec", ("dp", "fsdp", "ep", "tp", "sp", "pp")),
    "opt_state": ("mirror_dp", ("dp", "fsdp", "ep", "tp", "sp", "pp")),
    # the engine's extra= side channel: host bytes, restored per host
    "extra": ("host_local", ()),
}


def category_of_path(path: str) -> str:
    """The state category of a ``/``-joined leaf path; an unknown root is
    ``extra``."""
    head = path.split("/", 1)[0]
    return head if head in RESHARD_RULES else "extra"


def validate_saved_spec(category: str, spec) -> None:
    """Refuse a saved spec that names mesh axes outside its category's
    rule."""
    policy, allowed = RESHARD_RULES.get(category, RESHARD_RULES["extra"])
    axes = []
    for entry in tuple(spec or ()):
        parts = entry if isinstance(entry, (tuple, list)) else (entry,)
        axes += [ax for ax in parts if isinstance(ax, str)]
    stray = [ax for ax in axes if ax not in allowed]
    if stray:
        raise ValueError(f"saved spec {tuple(spec or ())} for category {category!r} names mesh "
                         f"axes {stray} outside its {policy!r} rule's {allowed}")

TRACKER_FILE = "LATEST"
MANIFEST_FILE = "manifest.json"
COMMIT_FILE = "commit_success"
DONE_DIR = ".done"
PINS_DIR = "pins"
LEASES_DIR = "leases"

# Streaming unit for shard writes/checksums (matches the flash tier's
# chunked persist: no full-payload copy per write call).
CHUNK = 64 * 1024 * 1024


def checksum_stream(reader, total: int, chunk: int = CHUNK) -> int:
    """crc32 over ``total`` bytes served by ``reader(offset, nbytes)``."""
    crc = 0
    offset = 0
    while offset < total:
        n = min(chunk, total - offset)
        crc = zlib.crc32(reader(offset, n), crc)
        offset += n
    return crc


@dataclass
class GenerationManifest:
    """Phase-2 commit artifact: everything a reader in a *different*
    world needs to validate and reshard the generation."""

    step: int = 0
    lineage: str = ""
    num_hosts: int = 1
    mesh_axes: List[str] = field(default_factory=list)
    mesh_shape: List[int] = field(default_factory=list)
    timestamp: float = 0.0
    # rank -> {"checksum": crc32, "nbytes": payload bytes}
    shards: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # TrainState category -> {leaf path: save-time PartitionSpec (jsonable)}
    category_specs: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # snapshot of parallel/sharding.py RESHARD_RULES at save time
    reshard_rules: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, data: str) -> "GenerationManifest":
        return cls(**json.loads(data))


class DurableLayout:
    """Path arithmetic + tracker/pin/lease bookkeeping for one lineage.

    Pure filesystem mechanics — the commit *protocol* lives in
    :mod:`.commit`, the data plane in :mod:`.writer`/:mod:`.restore`.
    Reuses the flash storage's fsync-then-rename atomic writes.
    """

    def __init__(self, root: str, lineage: str):
        if not lineage:
            raise ValueError("durable lineage must be non-empty")
        self.root = root
        self.lineage = lineage
        self.lineage_dir = os.path.join(root, lineage)
        os.makedirs(self.lineage_dir, exist_ok=True)
        # borrow the atomic-write helpers; its root is our lineage dir
        self._fs = PosixCheckpointStorage(self.lineage_dir)

    # -- paths -------------------------------------------------------------

    def gen_dir(self, step: int) -> str:
        return os.path.join(self.lineage_dir, f"gen_{step}")

    def done_dir(self, step: int) -> str:
        return os.path.join(self.gen_dir(step), DONE_DIR)

    def done_path(self, step: int, rank: int) -> str:
        return os.path.join(self.done_dir(step), f"shard_{rank}.done")

    def shard_meta_path(self, step: int, rank: int) -> str:
        return os.path.join(self.gen_dir(step), f"shard_{rank}.meta.json")

    def shard_bin_path(self, step: int, rank: int) -> str:
        return os.path.join(self.gen_dir(step), f"shard_{rank}.bin")

    def manifest_path(self, step: int) -> str:
        return os.path.join(self.gen_dir(step), MANIFEST_FILE)

    def commit_path(self, step: int) -> str:
        return os.path.join(self.gen_dir(step), COMMIT_FILE)

    def tracker_path(self) -> str:
        return os.path.join(self.lineage_dir, TRACKER_FILE)

    def atomic_write(self, path: str, data: bytes) -> None:
        self._fs._atomic_write(path, data)

    def atomic_write_stream(self, path: str, reader, total: int) -> None:
        self._fs._atomic_write_stream(path, reader, total)

    # -- shard writes (phase 1) --------------------------------------------

    def write_shard(self, meta: CheckpointMeta, reader) -> int:
        """Stream one host's shard into the generation dir and mark it
        done. Returns the payload crc32, which is also recorded in the
        done file so the committer can assemble the manifest without
        re-reading multi-GB payloads."""
        step, rank = meta.step, meta.host_rank
        os.makedirs(self.done_dir(step), exist_ok=True)
        self.atomic_write(
            self.shard_meta_path(step, rank), meta.to_json().encode()
        )
        crc = 0

        def counting_read(offset: int, nbytes: int) -> bytes:
            nonlocal crc
            block = reader(offset, nbytes)
            crc = zlib.crc32(block, crc)
            return block

        self.atomic_write_stream(
            self.shard_bin_path(step, rank), counting_read, meta.total_bytes
        )
        self.atomic_write(
            self.done_path(step, rank),
            json.dumps(
                {"checksum": crc, "nbytes": meta.total_bytes}
            ).encode(),
        )
        return crc

    def read_done(self, step: int, rank: int) -> Optional[Dict[str, int]]:
        try:
            with open(self.done_path(step, rank)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def all_shards_done(self, step: int, num_hosts: int) -> bool:
        return all(
            self.read_done(step, r) is not None for r in range(num_hosts)
        )

    # -- commit state ------------------------------------------------------

    def committed(self, step: int) -> bool:
        return os.path.exists(self.commit_path(step))

    def read_manifest(self, step: int) -> Optional[GenerationManifest]:
        try:
            with open(self.manifest_path(step)) as f:
                return GenerationManifest.from_json(f.read())
        except (OSError, ValueError, TypeError):
            return None

    def list_committed(self) -> List[int]:
        steps = []
        try:
            names = os.listdir(self.lineage_dir)
        except OSError:
            return steps
        for name in names:
            if name.startswith("gen_") and name[4:].lstrip("-").isdigit():
                step = int(name[4:])
                if self.committed(step):
                    steps.append(step)
        return sorted(steps)

    def latest_committed(self) -> Optional[int]:
        """Newest restorable generation. Same torn-tracker discipline
        as the hardened flash ``latest_step``: a tracker pointing at a
        generation whose commit marker is missing (crash inside the
        commit window, or a swept generation) is skipped in favor of
        the newest generation that actually committed."""
        tracked: Optional[int] = None
        try:
            with open(self.tracker_path()) as f:
                tracked = int(f.read().strip())
        except (OSError, ValueError):
            tracked = None
        if tracked is not None and self.committed(tracked):
            return tracked
        committed = self.list_committed()
        if committed:
            if tracked is not None:
                logger.warning(
                    "durable tracker for %s points at uncommitted "
                    "gen_%s; falling back to committed gen_%s",
                    self.lineage,
                    tracked,
                    committed[-1],
                )
            return committed[-1]
        return None

    def advance_tracker(self, step: int) -> None:
        self.atomic_write(self.tracker_path(), str(step).encode())

    # -- pins (operator keep) ----------------------------------------------

    def pin_path(self, step: int) -> str:
        return os.path.join(self.lineage_dir, PINS_DIR, f"{step}.pin")

    def pin(self, step: int) -> None:
        self.atomic_write(self.pin_path(step), b"pinned")

    def unpin(self, step: int) -> None:
        try:
            os.unlink(self.pin_path(step))
        except OSError:
            pass

    def pinned_steps(self) -> List[int]:
        pins_dir = os.path.join(self.lineage_dir, PINS_DIR)
        out = []
        try:
            names = os.listdir(pins_dir)
        except OSError:
            return out
        for name in names:
            stem = name[:-4] if name.endswith(".pin") else name
            if stem.lstrip("-").isdigit():
                out.append(int(stem))
        return sorted(out)

    # -- restore leases (GC shield) ----------------------------------------

    def lease_dir(self, step: int) -> str:
        return os.path.join(self.lineage_dir, LEASES_DIR, f"gen_{step}")

    def take_lease(self, step: int) -> str:
        """Mark a restore in flight on this generation; GC refuses to
        delete a leased generation (an in-flight reader may hold open
        file handles on a filesystem where unlink is not graceful)."""
        token = uuid.uuid4().hex
        self.atomic_write(
            os.path.join(self.lease_dir(step), f"{token}.lease"), b"lease"
        )
        return token

    def release_lease(self, step: int, token: str) -> None:
        try:
            os.unlink(os.path.join(self.lease_dir(step), f"{token}.lease"))
        except OSError:
            pass
        try:
            os.rmdir(self.lease_dir(step))
        except OSError:
            pass  # other leases still active, or already gone

    def leased_steps(self) -> List[int]:
        leases_root = os.path.join(self.lineage_dir, LEASES_DIR)
        out = []
        try:
            names = os.listdir(leases_root)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("gen_") and name[4:].lstrip("-").isdigit()):
                continue
            try:
                active = bool(os.listdir(os.path.join(leases_root, name)))
            except OSError:
                active = False
            if active:
                out.append(int(name[4:]))
        return sorted(out)


def list_lineages(root: str) -> List[str]:
    """Lineage names with at least one committed generation — what the
    cross-job warm pool can start from."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in sorted(names):
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        if DurableLayout(root, name).list_committed():
            out.append(name)
    return out
