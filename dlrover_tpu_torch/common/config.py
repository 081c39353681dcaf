"""Runtime knobs: the port of ``dlrover_tpu/common/config.py``.

One process-wide ``Context`` whose fields are overridden from
``DLROVER_<UPPER_NAME>`` environment variables, as in the JAX package. It
holds the knobs the checkpoint and the elastic loop read; the others come
with the slices that read them.
"""

import os
import threading
from dataclasses import dataclass, fields

_ENV_PREFIX = "DLROVER_"


@dataclass
class Context:
    # The saver persists the staged step when it is asked to terminate
    # (SIGTERM: pod eviction, preemption).
    save_at_breakpoint: bool = True
    # committed steps kept on storage (0 = unlimited); pruned by the
    # saver after each successful commit
    ckpt_keep_latest: int = 3
    # The engine starts the host-side read of a staged image at
    # construction, so it overlaps model build and the first step.
    ckpt_prefetch_restore: bool = True
    # Durable checkpoint tier root; empty disables it. The port has no
    # durable tier yet, and the engine raises when one is configured.
    durable_dir: str = ""
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
