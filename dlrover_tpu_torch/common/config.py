"""Runtime knobs: the port of ``dlrover_tpu/common/config.py``.

One process-wide ``Context`` whose fields are overridden from
``DLROVER_<UPPER_NAME>`` environment variables, as in the JAX package. It
holds the knobs the checkpoint, the elastic loop, the control plane and
the agent read, with the JAX package's defaults (the transport excepted:
the port's master speaks HTTP); the others come with the slices that
read them.
"""

import os
import threading
from dataclasses import dataclass, fields

from .constants import CommsType, DefaultValues

_ENV_PREFIX = "DLROVER_"


@dataclass
class Context:
    master_service_type: str = DefaultValues.SERVICE_TYPE
    # Master RPC client: per-call deadline and the jittered exponential
    # backoff between retries.
    rpc_deadline_s: float = 30.0
    rpc_retries: int = 3
    rpc_backoff_base_s: float = 0.5
    rpc_backoff_cap_s: float = 5.0
    # Rendezvous
    rdzv_timeout_s: float = DefaultValues.RDZV_TIMEOUT_S
    rdzv_lastcall_s: float = DefaultValues.RDZV_LASTCALL_S
    # Fault tolerance
    max_relaunch_count: int = DefaultValues.MAX_RELAUNCH_COUNT
    relaunch_always: bool = False
    heartbeat_interval_s: float = DefaultValues.HEARTBEAT_INTERVAL_S
    # the master marks a node dead after this long without a heartbeat
    heartbeat_deadline_s: float = 600.0
    # Orphan guard: the agent aborts after the master has been unreachable
    # this long (0 disables).
    master_lost_timeout_s: float = 600.0

    # The saver persists the staged step when it is asked to terminate
    # (SIGTERM: pod eviction, preemption).
    save_at_breakpoint: bool = True
    # committed steps kept on storage (0 = unlimited); pruned by the
    # saver after each successful commit
    ckpt_keep_latest: int = 3
    # The engine starts the host-side read of a staged image at
    # construction, so it overlaps model build and the first step.
    ckpt_prefetch_restore: bool = True
    # Peer-replica transfers (checkpoint/replica.py) move whole segment
    # images, so they have their own deadline rather than rpc_deadline_s.
    ckpt_replica_timeout_s: float = 120.0
    # Durable checkpoint tier (checkpoint/durable/): empty root disables
    # it. A background writer drains each flash-committed image to
    # <durable_dir>/<durable_lineage>/gen_<N> behind a two-phase,
    # crc32-verified commit; the restore chain reads it last.
    durable_dir: str = ""
    # lineage the job writes under; empty: the job name
    durable_lineage: str = ""
    # committed generations kept per lineage (pins and leases always kept)
    durable_keep: int = 3
    # drain a flash-committed step whose number this divides
    durable_every: int = 1
    # rank 0's wait for every host's shard-done signal before the commit
    durable_commit_timeout_s: float = 120.0
    # The train loop keeps one batch in flight on a background thread
    # (trainer/dataloader.py PrefetchIterator).
    input_prefetch: bool = True

    def apply_env(self) -> None:
        """Override fields from ``DLROVER_<UPPER_NAME>`` env vars."""
        for f in fields(self):
            raw = os.getenv(_ENV_PREFIX + f.name.upper())
            if raw is None:
                continue
            if f.type in (bool, "bool"):
                setattr(self, f.name, raw.lower() in ("1", "true", "yes"))
            elif f.type in (int, "int"):
                setattr(self, f.name, int(raw))
            elif f.type in (float, "float"):
                setattr(self, f.name, float(raw))
            else:
                setattr(self, f.name, raw)

    def master_comms(self) -> str:
        """The transport the master and its clients use. Only HTTP is
        ported; asking for gRPC raises where a server or client is built."""
        if self.master_service_type not in (CommsType.GRPC, CommsType.HTTP):
            return DefaultValues.SERVICE_TYPE
        return self.master_service_type

    _singleton = None
    _lock = threading.Lock()

    @classmethod
    def singleton_instance(cls) -> "Context":
        if cls._singleton is None:
            with cls._lock:
                if cls._singleton is None:
                    ctx = cls()
                    ctx.apply_env()
                    cls._singleton = ctx
        return cls._singleton


def get_context() -> Context:
    return Context.singleton_instance()
