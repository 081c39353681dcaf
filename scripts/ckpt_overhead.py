#!/usr/bin/env python3
"""Where the elastic loop's step time goes when it stages to shm every step.

    python3 scripts/ckpt_overhead.py [--steps 20] [--rounds 2] [--variants a,b,...]

Runs on one GPU. This process plays the agent (the checkpoint saver) and
starts one trainer process, which builds GPT-2 small at full width as
``chip_smoke.py``'s checkpoint phase does and times, in turns (each round
in one order and then the reverse), the median step of:

- ``bare``: the train step alone, with the batch copied to the card inline;
- ``loop_no_stage``: ``ElasticTrainLoop`` with no stage in the timed steps
  (input prefetch thread, save cadence checks);
- ``snapshot_only``: a stage every step whose staging thread only releases
  the shard lock (the device-side snapshot, lock IPC and thread start);
- ``d2h_per_tensor``, ``d2h_foreach``: the staging thread copies the
  snapshot into pinned host memory, but writes nothing to shm: by one
  ``copy_`` call a tensor, as the engine was first written, or by the
  engine's one ``_foreach_copy_`` into views made once;
- ``stage_per_tensor``, ``stage``: the same, and the copy into shm by numpy
  on the staging thread alone; ``stage`` is the engine as it is;
- ``stage_torch``: the per-tensor copies, and the copy into shm by torch's
  parallel copy;
- ``d2h_paced``, ``stage_paced``: as ``d2h_foreach`` and ``stage``, with
  the copies to pinned memory queued in batches of ``PACE_BYTES``, each
  waited for before the next is queued.

Every step ends in a loss fetch (a synchronisation), in all variants. The
last line is a JSON object with each variant's step times and the count of
stages each loop variant started.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = ("bare", "loop_no_stage", "snapshot_only", "d2h_per_tensor", "d2h_foreach",
            "stage_per_tensor", "stage", "stage_torch", "d2h_paced", "stage_paced")
PACE_BYTES = 64 << 20


def child(args) -> dict:
    import torch

    import chip_smoke
    from dlrover_tpu_torch.checkpoint import shm_handler
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.common.platform import resolve_device, strict_fp32
    from dlrover_tpu_torch.trainer.dataloader import to_device
    from dlrover_tpu_torch.trainer.loop import ElasticTrainLoop

    device = resolve_device(args.device)
    strict_fp32()
    _, state, step_fn, batches = chip_smoke.trainer_setup(args.small, device)
    stage = to_device(device)
    engine = CheckpointEngine(args.ckpt)
    real_stage, real_write = engine._stage_async, engine.shm.write_image
    streams = []

    def per_tensor(step, snapshot, event, extra, for_storage, write=True, background=True):
        """The staging thread as first written: a ``copy_`` call a tensor."""
        try:
            records, _, sources, values = snapshot
            it = iter(sources)
            srcs = [values[r.path] if r.path in values else next(it) for r in records]
            stream = None
            if event is not None:
                if not streams:
                    streams.append(torch.cuda.Stream(event[1]))
                stream = streams[0]
                stream.wait_event(event[0])
            payload = shm_handler.copy_to_host(records, srcs, engine._host_buffer, stream)
            if write:
                real_write(step, records, [(0, payload)], extra=extra, background=background)
        finally:
            engine._shard_lock.release()

    paced = {}

    def foreach_paced(step, snapshot, event, extra, for_storage, write=True):
        """The engine's stage, its copies to pinned memory queued in batches
        of PACE_BYTES, each waited for before the next."""
        try:
            records, total, sources, values = snapshot
            staged = engine._host_buffer(total)
            key = (id(staged), id(records))
            if key not in paced:
                views = [staged[r.offset : r.offset + r.nbytes] for r in records if r.path not in values]
                groups, cur, size = [], [], 0
                for i, v in enumerate(views):
                    cur.append(i)
                    size += v.numel()
                    if size >= PACE_BYTES:
                        groups.append(cur)
                        cur, size = [], 0
                groups += [cur] if cur else []
                paced.clear()
                paced[key] = [([views[i] for i in g], [sources[i] for i in g]) for g in groups]
            if event is None:
                for dst, src in paced[key]:
                    torch._foreach_copy_(dst, src)
            else:
                if not streams:
                    streams.append(torch.cuda.Stream(event[1]))
                stream = streams[0]
                stream.wait_event(event[0])
                for dst, src in paced[key]:
                    with torch.cuda.stream(stream):
                        torch._foreach_copy_(dst, src, non_blocking=True)
                    stream.synchronize()
            for rec in records:
                if rec.path in values:
                    staged[rec.offset : rec.offset + rec.nbytes].copy_(shm_handler.tensor_bytes(values[rec.path]))
            if write:
                real_write(step, records, [(0, staged[:total])], extra=extra, background=True)
        finally:
            engine._shard_lock.release()

    def snapshot_only(step, snapshot, event, extra, for_storage):
        engine._shard_lock.release()

    stage_fns = {
        "snapshot_only": snapshot_only,
        "d2h_per_tensor": lambda *a: per_tensor(*a, write=False),
        "stage_per_tensor": per_tensor,
        "stage_torch": lambda *a: per_tensor(*a, background=False),
        "d2h_paced": lambda *a: foreach_paced(*a, write=False),
        "stage_paced": foreach_paced,
    }

    def bare(n):
        times = []
        for x, y in batches(0, n):
            x, y = stage((x, y))
            t0 = time.perf_counter()
            _, loss = step_fn(state, x, y)
            float(loss)
            times.append(time.perf_counter() - t0)
        return times[1:], None

    def loop(n, variant):
        engine._stage_async = stage_fns.get(variant, real_stage)
        if variant == "d2h_foreach":
            engine.shm.write_image = lambda *a, **kw: None
        started = [0]
        save = engine.save_to_memory

        def counting(s, tree, *a, **kw):
            ok = save(s, tree, *a, **kw)
            started[0] += bool(ok and kw.get("block") is False)
            return ok

        engine.save_to_memory = counting
        stamps = []

        def on_step(s, loss):
            float(loss)
            stamps.append(time.perf_counter())

        every = 10 ** 9 if variant == "loop_no_stage" else 1
        lp = ElasticTrainLoop(engine, step_fn, memory_every=every, storage_every=0,
                              log_every=10 ** 9, on_step=on_step, input_stage_fn=stage,
                              input_device=device)

        def data(start):
            lp.max_steps = start + n
            return batches(start, start + n)

        lp.run(state, data_factory=data)
        engine.save_to_memory = save
        engine._stage_async, engine.shm.write_image = real_stage, real_write
        return [b - a for a, b in zip(stamps, stamps[1:])][1:], started[0]

    if not engine.save_to_memory(0, state):  # something for the loops to restore
        raise RuntimeError("first save skipped")
    bare(4)  # warm-up
    variants = args.variants.split(",") if args.variants else list(VARIANTS)
    out = {v: {"step_s": [], "stages": []} for v in variants}
    for r in range(args.rounds):
        for v in variants if r % 2 == 0 else variants[::-1]:
            times, stages = bare(args.steps) if v == "bare" else loop(args.steps, v)
            out[v]["step_s"].append(statistics.median(times))
            out[v]["stages"].append(stages)
            print(f"round {r} {v}: median step {statistics.median(times):.4f} s, stages {stages}", flush=True)
    engine.close()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--variants", default="", help="comma-separated subset of " + ",".join(VARIANTS))
    parser.add_argument("--child", action="store_true")
    parser.add_argument("--ckpt")
    parser.add_argument("--device", default="cuda", help="cpu: a rehearsal, no numbers")
    parser.add_argument("--small", action="store_true", help="the 2-layer model (rehearsal)")
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(args)), flush=True)
        return 0

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("ckpt_overhead: no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.common import multi_process

    work = tempfile.mkdtemp(prefix="ckpt_overhead_")
    job = f"ckpt_overhead_{os.getpid()}"
    os.environ.update(DLROVER_JOB_NAME=job, DLROVER_IPC_DIR=os.path.join(work, "sockets"))
    multi_process.SOCKET_TMP_DIR = os.environ["DLROVER_IPC_DIR"]
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

    AsyncCheckpointSaver.start_async_saving_ckpt()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--ckpt", os.path.join(work, "ckpt"),
             "--steps", str(args.steps), "--rounds", str(args.rounds), "--device", args.device,
             "--variants", args.variants]
            + (["--small"] if args.small else []),
            capture_output=True, text=True, timeout=1200)
    finally:
        AsyncCheckpointSaver.shutdown()
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrover_{job}"):
                os.unlink(os.path.join("/dev/shm", name))
        shutil.rmtree(work, ignore_errors=True)
    if proc.returncode:
        sys.stderr.write(proc.stderr[-4000:])
        return proc.returncode
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip())
    print(lines[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
