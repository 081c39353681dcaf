"""Elastic GPT-2 training with flash checkpointing, the flagship workflow:
the port of the repository's ``examples/gpt_elastic.py``.

Run on one host (the launcher spawns a standalone master):

    python -m dlrover_tpu_torch.launcher.elastic_run --standalone --nnodes 1 \\
        --nproc_per_node 1 -m dlrover_tpu_torch.examples.gpt_elastic

or on N nodes, one worker process each, against a master started with
``python -m dlrover_tpu_torch.master.main --num_workers N --port_file F``:
on node r, with ``DLROVER_MASTER_ADDR`` set to the master's address,

    python -m dlrover_tpu_torch.launcher.elastic_run --nnodes N --node_rank r \\
        --nproc_per_node 1 -m dlrover_tpu_torch.examples.gpt_elastic

GPT-2 small at full width (flash attention through the port's CUDA
kernels, remat, seq 1024, batch 8) trains ``TOTAL_STEPS`` steps through
``ElasticTrainLoop``, staging every step to shared memory and persisting
every 5th to ``CKPT_DIR``. Weights come from seed 0 and the global batch
of step s from seed s, so a restarted worker resumes with exactly the data
it would have seen. SIGKILL the worker mid-run: its agent persists the
staged step, restarts it, and the new worker restores from shared memory.

The world comes from the agent's env contract (``elastic_context``) and
the mesh is data-parallel (``build_mesh(choose_mesh_shape(n,
prefer_fsdp=False))``): process r of n trains rows ``[r*B/n, (r+1)*B/n)``
of each global batch and the step averages the gradients over the world,
so a world of two gives a world of one's losses. The JAX example shards
the parameters (fsdp); the port's parallel layouts are a later slice, and
fsdp computes the same losses as dp.

``--device cpu --small`` runs a 2-layer model on the CPU (the tests).
Without ``--device cpu`` the script needs a GPU and fails without one.

Each worker prints JSON lines prefixed ``gpt_elastic``: ``boot`` (restart
count, start-up stamps, whether the kernel library came from the build
cache, the storage tracker before the restore, the world's size, this
process's rank and the process group's backend, and whether the process
was an adopted warm spare, with the spare's age at the hand-off and the
time from the contract line to this script), ``resume`` (the step and rung
of the restore, and the outcome of a refill from a peer's replica),
``first_step`` and ``second_step`` (the first two steps of
this process split into forward, backward, all-reduce in a world of
several, optimizer and loss fetch by device synchronisations; the first
with its stage into shm), one ``step`` per step (loss, wall-clock stamp,
flash launches of the step, the stages skipped so far) and ``done`` (with
the SHA-256 of the final state). Only those two steps synchronise between
their parts.
"""

import time

T_START = time.time()  # before the imports: the worker's boot is timed from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ..checkpoint.engine import CheckpointEngine  # noqa: E402
from ..checkpoint.shm_handler import flatten_with_path  # noqa: E402
from ..common.platform import resolve_device, strict_fp32  # noqa: E402
from ..models import gpt  # noqa: E402
from ..ops import _build  # noqa: E402
from ..ops import flash_attention as fa  # noqa: E402
from ..parallel import train_step  # noqa: E402
from ..parallel.mesh import build_mesh, choose_mesh_shape, local_batch_slice  # noqa: E402
from ..trainer.dataloader import to_device  # noqa: E402
from ..trainer.elastic import elastic_context  # noqa: E402
from ..trainer.loop import ElasticTrainLoop  # noqa: E402

STORAGE_EVERY = 5
PREFIX = "gpt_elastic "


def build(small: bool, device, mesh=None, rank: int = 0):
    """(config, train state, step fn, batches): GPT-2 small at full width
    (flash, remat, seq 1024, global batch 8), or a 2-layer model at embed 64
    and global batch 4 for the CPU tests. Weights from seed 0;
    ``batches(start, stop)`` yields this process's rows of the global batch
    of step s, drawn from seed s: on a data-parallel ``mesh``, process
    ``rank``'s share of them (all of them without a mesh)."""
    if small:
        cfg = gpt.GPTConfig(vocab_size=256, max_seq_len=32, num_layers=2, num_heads=4,
                            head_dim=16, embed_dim=64, use_remat=True, attention_impl="flash")
        batch, seq = 4, 32
    else:
        cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(), attention_impl="flash",
                                  max_seq_len=1024, use_remat=True)
        batch, seq = 8, 1024
    model = gpt.GPT(cfg, device=device)
    tx = train_step.default_optimizer()
    local = batch if mesh is None else local_batch_slice(batch, mesh)
    rows = slice(rank * local, (rank + 1) * local)
    state = train_step.init_train_state(model, torch.zeros((local, seq), dtype=torch.long), tx,
                                        device=device, seed=0)
    step_fn = train_step.build_train_step(model, tx, gpt.cross_entropy_loss, mesh=mesh)

    def batches(start, stop):
        for s in range(start, stop):
            t = torch.from_numpy(
                np.random.default_rng(s).integers(0, cfg.vocab_size, (batch, seq + 1)))[rows]
            yield t[:, :-1], t[:, 1:]

    return cfg, state, step_fn, batches


def state_hash(state) -> str:
    """SHA-256 over every leaf's path and bytes (tensors) or value (ints)."""
    h = hashlib.sha256()
    for path, leaf in flatten_with_path(state):
        h.update(path.encode())
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def emit(event: str, **fields) -> None:
    print(PREFIX + json.dumps({"event": event, "pid": os.getpid(), **fields}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the GPU, which must exist)")
    parser.add_argument("--small", action="store_true", help="2-layer model (tests)")
    args = parser.parse_args(argv)
    total_steps = int(os.environ.get("TOTAL_STEPS", "200"))
    ckpt_dir = os.environ.get("CKPT_DIR", os.path.join(tempfile.gettempdir(), "gpt_elastic_ckpt"))
    t_imported = time.time()

    device = resolve_device(args.device)  # raises without a GPU unless --device cpu
    lib_cached = None
    if device.type == "cuda":
        strict_fp32()
        torch.empty(1, device=device)  # the CUDA context
    t_cuda = time.time()
    ctx = elastic_context(device=device)  # the world, from the agent's env contract
    mesh = build_mesh(choose_mesh_shape(ctx.world_device_count(), prefer_fsdp=False))
    t_world = time.time()
    # the engine first: its prefetch of a staged image overlaps the rest
    engine = CheckpointEngine(ckpt_dir)
    tracker = engine.storage.latest_step()
    t_engine = time.time()
    if device.type == "cuda":
        lib_cached = os.path.exists(_build.library_path("flash_attention"))
        fa._lib()
    t_lib = time.time()
    cfg, state, inner_step, batches = build(args.small, device, mesh, ctx.process_id)
    t_model = time.time()
    handoff = getattr(sys.modules.get("dlrover_tpu_torch.agent.warm_worker"), "HANDOFF", None)
    spare = {"adopted": handoff is not None}
    if handoff is not None:
        started, contract = handoff["started"], handoff["contract"]
        spare.update(spare_started=started, spare_import_s=handoff["ready"] - started,
                     spare_age_s=contract - started, t_contract=contract,
                     contract_to_script_s=T_START - contract)
    emit("boot", restart_count=ctx.restart_count, process_id=ctx.process_id,
         world_size=ctx.num_processes, world=mesh.dp, rank=ctx.process_id, backend=ctx.backend,
         gpu_uuids=ctx.gpu_uuids, device=str(device), lib_cached=lib_cached,
         tracker=tracker, t_start=T_START, t_imported=t_imported, t_cuda=t_cuda,
         t_world=t_world, t_engine=t_engine, t_lib=t_lib,
         t_model=t_model, n_params=sum(p.numel() for p in state.params.values()), **spare)

    launches = dict(fa.launches)
    split, splits = {}, []  # the step being split, the finished splits

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step_fn(st, x, y):
        """The train step; the first two calls of this process are split
        into their parts by device synchronisations."""
        if len(splits) == 2:
            return inner_step(st, x, y)
        split.clear()
        stamp = [time.perf_counter()]

        def mark(part):
            sync()
            now = time.perf_counter()
            split[part + "_s"] = split.get(part + "_s", 0.0) + now - stamp[0]
            stamp[0] = now

        st, loss = inner_step(st, x, y, mark=mark)
        float(loss)
        split["loss_fetch_s"] = time.perf_counter() - stamp[0]
        split["t_end"] = time.perf_counter()
        splits.append(dict(split))
        return st, loss

    def on_step(step, loss):
        loss = float(loss)  # synchronises: the stamp is the step's end
        now = time.time()
        if step == loop.start_step:
            emit("resume", restored_step=loop.start_step - 1, restored_from=engine.restored_from,
                 peer_refill=engine.peer_refill, restore_s=loop.last_restore_s, t_loop=t_loop)
            # the first stage: the snapshot, the pinned buffer's allocation and
            # the first copies to the host and into shm
            staged = engine.wait_staged(600)
            first = dict(splits[0])
            emit("first_step", step=step, staged=staged,
                 stage_s=time.perf_counter() - first.pop("t_end"), **first)
        elif step == loop.start_step + 1:
            second = dict(splits[1])
            second.pop("t_end")
            emit("second_step", step=step, **second)
        per_step = {k: fa.launches[k] - launches[k] for k in launches}
        launches.update(fa.launches)
        emit("step", step=step, rank=ctx.process_id, loss=loss, t=now, launches=per_step,
             skipped=dict(engine.skipped_stages), storage_wait_s=engine.storage_wait_s)
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} at step {step}")

    loop = ElasticTrainLoop(engine, step_fn, ctx=ctx, max_steps=total_steps, memory_every=1,
                            storage_every=STORAGE_EVERY, log_every=10, on_step=on_step,
                            input_stage_fn=to_device(device), input_device=device)
    t_loop = time.time()
    state = loop.run(state, data_factory=lambda start: batches(start, total_steps))
    engine.close()
    ctx.shutdown()
    emit("done", steps=total_steps, rank=ctx.process_id, stage_failures=engine.stage_failures,
         skipped=dict(engine.skipped_stages), storage_wait_s=engine.storage_wait_s,
         state_hash=state_hash(state))
    return 0


if __name__ == "__main__":
    sys.exit(main())
