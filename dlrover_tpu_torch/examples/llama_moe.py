"""Llama with mixture-of-experts blocks: the port of the repository's
``examples/llama_moe.py``.

    python -m dlrover_tpu_torch.examples.llama_moe [--device cpu]

The tiny Llama (``LlamaConfig.tiny``, seq 128) with every 2nd block a
top-2 expert layer trains 30 steps on seeded random tokens through the
port's train step, which adds the experts' load-balance term to the loss,
and prints the loss of every 5th step.

The mesh rule is the JAX example's: ``ep = 4`` when the world's device
count is a multiple of 4, else 1, with ``2 * ep`` experts and a global
batch of ``2 * dp``. The world is this process's ``torch.distributed``
group, one device a process, or this process alone. An ``ep`` above 1
raises until the parallel layouts are ported (``parallel/mesh.py``), as
every mesh axis but dp does.

Runs on the GPU unless ``--device cpu`` is given.
"""

import argparse
import sys
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..common.platform import resolve_device
from ..models.llama import Llama, LlamaConfig, llama_loss
from ..parallel.mesh import DataParallelMesh, MeshConfig, build_mesh, local_batch_slice
from ..parallel.train_step import build_train_step, default_optimizer, init_train_state

STEPS = 30


def mesh_for(n: int) -> DataParallelMesh:
    """The JAX example's mesh for ``n`` devices: ep 4 when 4 divides ``n``."""
    ep = 4 if n % 4 == 0 else 1
    return build_mesh(MeshConfig(dp=n // ep, fsdp=1, ep=ep), world_size=n)


def train(device=None, steps: int = STEPS, log_every: int = 5) -> List[float]:
    """Train the example's model for ``steps`` steps; returns the losses."""
    device = resolve_device(device)
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    mesh = mesh_for(n)
    print("mesh:", mesh.shape, flush=True)
    ep = mesh.shape["ep"]
    cfg = LlamaConfig.tiny(num_experts=ep * 2, moe_every=2, max_seq_len=128)
    model = Llama(cfg, device=device)
    tx = default_optimizer(warmup_steps=5)
    batch = 2 * (n // ep)
    local = local_batch_slice(batch, mesh)
    rank = dist.get_rank() if n > 1 else 0
    rows = slice(rank * local, (rank + 1) * local)

    tokens = torch.zeros((local, cfg.max_seq_len), dtype=torch.long)
    state = init_train_state(model, tokens, tx, device=device)
    step_fn = build_train_step(model, tx, llama_loss, mesh=mesh)

    rng = np.random.default_rng(0)
    losses = []
    for step in range(steps):
        x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq_len)))
        x = x[rows].to(device)
        y = torch.roll(x, -1, dims=1)
        state, loss = step_fn(state, x, y)
        losses.append(float(loss))
        if step % log_every == 0:
            print(f"step {step}: loss {losses[-1]:.4f}", flush=True)
    return losses


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the GPU, which must exist)")
    args = parser.parse_args(argv)
    train(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
