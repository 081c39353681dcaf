"""Two-phase commit of a durable generation: the port of
``dlrover_tpu/checkpoint/durable/commit.py``.

Phase 1 (every host, :meth:`.layout.DurableLayout.write_shard`): stream
the shard and record its crc32 and size in a done file. Phase 2 (rank 0):
wait for a barrier saying every host is done, then write ``manifest.json``,
``commit_success`` and ``LATEST``, each atomically and the tracker last, so
a crash anywhere in the window leaves the previous generation or this one
visible, never a torn one.

The barrier is a counter in the master's KV store when a master is
reachable (``kv_store_add``, the port's ``MasterClient``); without one,
the done files themselves. The committer checks the done files on disk in
both cases before it writes the marker. The JAX module's fault-injection
point before the commit is left out (the chaos harness is not ported).

One rule is added to the JAX barrier: rank 0 gives a generation up, before
its timeout, once a newer step waits in its own writer and every other
host has signalled that newer step. Each host drains its steps in order
and newest first (latest wins), so such a host will never signal the
older one: it skipped it, or it is a replacement that never had it. The
JAX barrier waits out ``durable_commit_timeout_s`` (120 s) there, with
the newer generations queued behind it.
"""

import time

from typing import Callable, Optional

from ...common.log import logger
from ..meta import CheckpointMeta
from .layout import RESHARD_RULES, DurableLayout, GenerationManifest, category_of_path

BARRIER_POLL_S = 0.1
KV_PREFIX = "ckpt/durable"


class FsBarrier:
    """Done-file barrier for standalone (no-master) jobs: the phase-1
    done files double as the arrival signal."""

    def __init__(self, layout: DurableLayout, num_hosts: int):
        self.layout = layout
        self.num_hosts = num_hosts

    def signal(self, step: int, rank: int) -> None:
        pass  # write_shard's done file IS the signal

    def others_done(self, step: int) -> bool:
        """Every host but rank 0 has written its shard of ``step``."""
        return all(self.layout.read_done(step, r) is not None for r in range(1, self.num_hosts))

    def wait_all(self, step: int, timeout_s: float, newer: Optional[Callable[[], Optional[int]]] = None
                 ) -> bool:
        deadline = time.monotonic() + timeout_s
        while True:
            if self.layout.all_shards_done(step, self.num_hosts):
                return True
            if time.monotonic() >= deadline or _gives_way(self, step, newer):
                return False
            time.sleep(BARRIER_POLL_S)


class MasterKVBarrier:
    """Commit barrier through the master's journaled kv store.

    Each host bumps one counter key per (lineage, step); the committer
    polls it with the kv ``add(key, 0)`` read idiom. No new master
    endpoints: ``kv_store_add`` is already journaled (the WAL records
    the resulting value), so the barrier survives master failover.
    """

    def __init__(self, client, lineage: str, num_hosts: int):
        self.client = client
        self.lineage = lineage
        self.num_hosts = num_hosts

    def key(self, step: int) -> str:
        return f"{KV_PREFIX}/{self.lineage}/{step}/done"

    def signal(self, step: int, rank: int) -> None:
        self.client.kv_store_add(self.key(step), 1)

    def others_done(self, step: int) -> bool:
        """Every host but rank 0 has signalled ``step`` (rank 0 asks this of
        a step it has not drained yet)."""
        try:
            return int(self.client.kv_store_add(self.key(step), 0)) >= self.num_hosts - 1
        except Exception as e:  # noqa: BLE001 — master flapping: no verdict this poll
            logger.warning("durable barrier poll failed for step %s: %s", step, e)
            return False

    def wait_all(self, step: int, timeout_s: float, newer: Optional[Callable[[], Optional[int]]] = None
                 ) -> bool:
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                count = int(self.client.kv_store_add(self.key(step), 0))
            except Exception as e:  # noqa: BLE001 — master flapping mid-barrier
                logger.warning(
                    "durable barrier poll failed for step %s: %s", step, e
                )
                count = -1
            if count >= self.num_hosts:
                return True
            if time.monotonic() >= deadline or _gives_way(self, step, newer):
                return False
            time.sleep(BARRIER_POLL_S)


def _gives_way(barrier, step: int, newer: Optional[Callable[[], Optional[int]]]) -> bool:
    """``newer()`` (the step waiting behind this one in rank 0's writer) is
    newer than ``step`` and every other host has signalled it."""
    later = newer() if newer is not None else None
    if later is None or later <= step or not barrier.others_done(later):
        return False
    logger.info("durable gen_%s gives way to gen_%s, which every other host has written",
                step, later)
    return True


def build_manifest(
    layout: DurableLayout, step: int, num_hosts: int
) -> GenerationManifest:
    """Assemble the phase-2 manifest from the phase-1 artifacts: shard
    checksums from the done files, the save-time sharding from the
    per-rank metas, and a snapshot of the reshard rule table."""
    manifest = GenerationManifest(
        step=step,
        lineage=layout.lineage,
        num_hosts=num_hosts,
        timestamp=time.time(),
        reshard_rules={
            cat: [policy, list(axes)]
            for cat, (policy, axes) in RESHARD_RULES.items()
        },
    )
    for rank in range(num_hosts):
        done = layout.read_done(step, rank)
        if done is None:
            raise RuntimeError(
                f"durable commit for gen_{step}: shard {rank} has no "
                "done record despite a met barrier"
            )
        manifest.shards[str(rank)] = {
            "checksum": int(done["checksum"]),
            "nbytes": int(done["nbytes"]),
        }
        with open(layout.shard_meta_path(step, rank)) as f:
            meta = CheckpointMeta.from_json(f.read())
        if rank == 0:
            manifest.mesh_axes = list(meta.mesh_axes)
            manifest.mesh_shape = list(meta.mesh_shape)
        for rec in meta.records:
            cat = category_of_path(rec.path)
            manifest.category_specs.setdefault(cat, {}).setdefault(
                rec.path, list(rec.spec or [])
            )
    return manifest


def commit_generation(
    layout: DurableLayout,
    step: int,
    num_hosts: int,
    barrier=None,
    timeout_s: float = 120.0,
    newer: Optional[Callable[[], Optional[int]]] = None,
) -> bool:
    """Rank-0 phase 2. Returns True iff the generation committed. When the
    barrier times out, or gives way to ``newer()`` (see the module
    docstring), the generation is left uncommitted (invisible to readers)
    for the GC's stale-partial sweep."""
    barrier = barrier or FsBarrier(layout, num_hosts)
    if not barrier.wait_all(step, timeout_s, newer):
        logger.warning(
            "durable commit barrier for %s gen_%s not met (timed out after %.0fs or gave way); "
            "the generation stays uncommitted",
            layout.lineage,
            step,
            timeout_s,
        )
        return False
    # The kv barrier is a signal; the done files are the truth — verify
    # them regardless of which barrier fired.
    if not layout.all_shards_done(step, num_hosts):
        logger.warning(
            "durable barrier met for gen_%s but done files missing; "
            "refusing to commit",
            step,
        )
        return False
    manifest = build_manifest(layout, step, num_hosts)
    layout.atomic_write(
        layout.manifest_path(step), manifest.to_json().encode()
    )
    layout.atomic_write(layout.commit_path(step), b"ok")
    layout.advance_tracker(step)
    logger.info(
        "durable generation committed: %s gen_%s (%s shards)",
        layout.lineage,
        step,
        num_hosts,
    )
    return True


def make_barrier(layout: DurableLayout, num_hosts: int, master_client=None):
    """Pick the barrier for this deployment: master kv when a client is
    available, else the done-file fallback."""
    if master_client is not None:
        return MasterKVBarrier(master_client, layout.lineage, num_hosts)
    return FsBarrier(layout, num_hosts)
