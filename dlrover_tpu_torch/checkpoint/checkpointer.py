"""User-facing checkpoint API: the port of
``dlrover_tpu/checkpoint/checkpointer.py`` over the port's engine."""

from typing import Any, Optional, Tuple

from .engine import CheckpointEngine


class StorageType:
    MEMORY = "memory"
    DISK = "disk"


class Checkpointer:
    """``save_checkpoint(step, state, storage_type)`` / ``load_checkpoint``.

    ``state`` is a torch state tree (e.g. a ``TrainState``). Memory saves
    copy into shared memory; disk saves also hand persistence to the
    agent's saver.
    """

    def __init__(self, checkpoint_dir: str, **engine_kwargs):
        self.engine = CheckpointEngine(checkpoint_dir, **engine_kwargs)

    def save_checkpoint(self, step: int, state: Any, storage_type: str = StorageType.DISK) -> bool:
        if storage_type == StorageType.MEMORY:
            return self.engine.save_to_memory(step, state)
        return self.engine.save_to_storage(step, state)

    def load_checkpoint(self, template: Any) -> Tuple[int, Optional[Any]]:
        """Restore into the template's tensors; returns (step, state|None)."""
        return self.engine.load(template)

    def wait_latest_checkpoint(self, timeout: float = 300.0) -> bool:
        return self.engine.wait_saving(timeout)

    def close(self) -> None:
        self.engine.close()
