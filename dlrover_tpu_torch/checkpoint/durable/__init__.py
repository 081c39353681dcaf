"""Durable checkpoint tier: the port of
``dlrover_tpu/checkpoint/durable/__init__.py``.

The last rung of the restore chain (shm, peer replica, flash storage,
**durable**): a background writer drains each flash-committed image to
durable storage behind a two-phase, crc32-verified commit, so a job that
lost every host's memory and flash storage resumes from the newest
committed generation. It exports what the JAX package exports;
:func:`place_with_rules` and :func:`warm_start` (reshard on read under a
mesh, and the cross-job warm start built on it) raise ``not_ported``
until the port's ``parallel/sharding.py`` exists.
"""

from .commit import FsBarrier, MasterKVBarrier, commit_generation
from .gc import collect_generations
from .layout import DurableLayout, GenerationManifest, list_lineages
from .restore import DurableShardError, place_with_rules, read_generation, warm_start
from .writer import DurableWriter

__all__ = [
    "DurableLayout",
    "GenerationManifest",
    "DurableWriter",
    "DurableShardError",
    "FsBarrier",
    "MasterKVBarrier",
    "commit_generation",
    "collect_generations",
    "list_lineages",
    "read_generation",
    "place_with_rules",
    "warm_start",
]
