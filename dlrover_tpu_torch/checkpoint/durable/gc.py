"""Generation GC of a durable lineage: the port of
``dlrover_tpu/checkpoint/durable/gc.py``.

Keep = the newest N committed generations, the pinned ones, the leased
ones (a restore in flight holds a lease; deleting under it would tear the
read) and the tracker's. Uncommitted partials, from a crash between the
two phases, are swept only once older than a grace period, so a drain or
a barrier still converging is never collected from under itself.
"""

import os
import shutil
import time
from typing import List

from ...common.log import logger
from .layout import DurableLayout

# Mirrors the flash tier's stale-partial grace: a partial younger than
# this may still be mid-commit on a slow barrier.
STALE_PARTIAL_GRACE_S = 3600.0


def collect_generations(
    layout: DurableLayout,
    keep: int = 3,
    grace_s: float = STALE_PARTIAL_GRACE_S,
) -> List[int]:
    """Apply the keep-policy to one lineage; returns the swept steps."""
    committed = layout.list_committed()
    protected = set(committed[-keep:]) if keep > 0 else set()
    protected.update(layout.pinned_steps())
    protected.update(layout.leased_steps())
    latest = layout.latest_committed()
    if latest is not None:
        protected.add(latest)
    removed: List[int] = []
    for step in committed:
        if step in protected:
            continue
        shutil.rmtree(layout.gen_dir(step), ignore_errors=True)
        removed.append(step)

    now = time.time()
    try:
        names = os.listdir(layout.lineage_dir)
    except OSError:
        names = []
    for name in names:
        if not (name.startswith("gen_") and name[4:].lstrip("-").isdigit()):
            continue
        step = int(name[4:])
        if layout.committed(step) or step in protected:
            continue
        path = layout.gen_dir(step)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue
        if age > grace_s:
            shutil.rmtree(path, ignore_errors=True)
            removed.append(step)
    if removed:
        logger.info(
            "durable GC swept %s generation(s) from %s: %s",
            len(removed),
            layout.lineage,
            sorted(removed),
        )
    return sorted(removed)
