"""Warm-spare worker: the port of ``dlrover_tpu/agent/warm_worker.py``.

A pre-imported interpreter that waits for the env contract, then becomes
the worker. A restarted worker otherwise pays a fresh CPython start and the
import of torch and of the port's training modules before any of its own
code runs; the spare pays that while the previous worker still trains, and
turns into the worker when the agent writes the contract (the rendezvous
round's env, the entry point and its arguments) to its stdin as one JSON
line. It then applies the env and ``runpy``-runs the entry point as
``__main__``, as the JAX spare does.

The JAX rule "importing is free, initializing is binding" becomes: the
spare never touches ``torch.cuda`` (no ``is_available``, no device count,
no tensor on the card). A CUDA context is per process and binds the device
memory; the worker makes its own after the hand-off, and a spare holding
one would take about 0.5 GB of the card from the worker beside it. The JAX
spare pre-applies the compile cache; the counterpart here is the kernel
library in the build cache (``ops/_build/``), which the spare loads when it
is there already: loading runs no CUDA call, the first launch does.

``HANDOFF`` holds the spare's wall-clock stamps in the process it became,
for the worker's boot record.
"""

import json
import os
import runpy
import sys
import time
from typing import Dict, Optional

# Set in an adopted spare: {"started", "ready", "contract"} wall-clock stamps
# (the spare's start, the end of its imports, the contract line's arrival).
HANDOFF: Optional[Dict[str, float]] = None

# torch._dynamo: torch.utils.checkpoint (the model's remat) imports it on
# its first call, with sympy and torch.distributed, about 840 modules; a
# worker otherwise pays that inside its first forward. Importing it opens
# no device.
PRELOAD = ("numpy", "torch", "torch._dynamo", "dlrover_tpu_torch.models.gpt",
           "dlrover_tpu_torch.parallel.train_step", "dlrover_tpu_torch.trainer.loop",
           "dlrover_tpu_torch.checkpoint.engine", "dlrover_tpu_torch.ops.flash_attention")


def _preload_kernel_library() -> None:
    """Load the flash kernels' library if the build cache holds it already
    (never build here: ``nvcc`` takes seconds of the CPU the worker trains
    on)."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import flash_attention

    if os.path.exists(_build.library_path("flash_attention")):
        flash_attention._lib()


def main() -> int:
    started = time.time()
    env = dict(os.environ)
    # The import tax, paid while the previous worker still trains.
    import importlib

    for mod in PRELOAD:
        try:
            importlib.import_module(mod)
        except ImportError as e:
            print(f"warm spare: cannot preload {mod}: {e!r}", file=sys.stderr)
    try:
        _preload_kernel_library()
    except Exception as e:  # noqa: BLE001 — an optimization only
        print(f"warm spare: kernel library not preloaded: {e!r}", file=sys.stderr)
    # a preload may set variables of its own (torch's inductor sets its cache
    # directory): the worker starts from the environment a cold start has
    for key in set(os.environ) - set(env):
        del os.environ[key]
    os.environ.update(env)
    ready = time.time()
    # Tell the agent we are ready. The marker is a file: stdout is the
    # worker's (the agent's own, or the worker log), and the spare writes
    # nothing there before it becomes the worker.
    ready_file = os.environ.get("DLROVER_WARM_READY_FILE")
    if ready_file:
        with open(ready_file, "w") as f:
            f.write(str(os.getpid()))

    line = sys.stdin.readline()
    if not line.strip():
        return 0  # the agent closed the pipe: the spare is no longer needed
    contract = json.loads(line)
    from dlrover_tpu_torch.agent import warm_worker

    warm_worker.HANDOFF = {"started": started, "ready": ready, "contract": time.time()}
    os.environ.update({k: str(v) for k, v in contract["env"].items()})
    entrypoint = contract["entrypoint"]
    sys.argv = [entrypoint] + list(contract.get("args", []))
    if contract.get("run_module"):
        runpy.run_module(entrypoint, run_name="__main__", alter_sys=True)
    else:
        runpy.run_path(entrypoint, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
