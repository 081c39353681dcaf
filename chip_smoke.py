#!/usr/bin/env python3
"""Runs the PyTorch port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. probe: a CUDA device must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them, and keeps fp32 matmuls in fp32;
2. build: compiles the flash-attention kernels from ``dlrover_tpu_torch/ops/
   csrc`` with ``nvcc`` (first use) and prints the build seconds;
3. kernels: prints each kernel's registers and spills from the ptxas log
   and its HGMMA (wgmma) and UTMALDG (TMA load) counts from ``cuobjdump
   --dump-sass`` of the built library, and fails if any of the three
   kernels issues no wgmma or no TMA load; then holds each of them against
   its plain PyTorch version, run at the kernel's own tile sizes
   (``kernel_tiles``), on the same bf16 inputs at the training shape (B=8,
   T=1024, H=12, D=64, causal) and at ragged shapes (T=1000; D=128
   non-causal at batch 1, D=64 causal; causal q_len 384 < kv_len 1000;
   causal q_len > kv_len at a ragged kv_len, D=64 and D=128), and times
   kernel, plain version and ``scaled_dot_product_attention`` (the
   yardstick, never called by the port) with CUDA events;
4. main path: GPT-2 small at full width (flash attention, remat, seq
   1024) takes a few training steps at batch 8 on seeded random tokens
   through ``init_train_state`` / ``build_train_step``; the losses must be
   finite, the first near ln(vocab), each step must launch exactly 24
   forward, 12 dK/dV and 12 dQ kernels, and the trained model's flash
   losses must agree with the plain dense attention path on a small batch;
5. checkpoint and elastic loop: this process plays the agent and runs the
   checkpoint saver; trainers are child processes (``chip_smoke.py
   --trainer ROLE``) driving GPT-2 small at full width through
   ``ElasticTrainLoop`` (a stage to shm every step, a persist every 5):
   an uninterrupted run of 30 steps in its own namespace; a run that stages
   step 7 and dies by SIGKILL holding the shard lock (shm must hold step 7,
   storage step 5, and the lock must come free); a run that must restore
   step 7 from shm with the killed state's SHA-256, train steps 8-11 within
   1e-2 of the uninterrupted losses at 24/12/12 flash launches a step, with
   no failed async stage; with the segment unlinked, a restore that must
   read step 10 from storage, hash-equal to what was staged; and a trainer
   that times the checkpoint (blocking and async saves, persist, restore,
   and the loop's step with a stage every step against the bare step);
   it prints each persist's shard-lock hold (the copy out of shm) and
   write, and the stages the trainers skipped;
6. tpurun, twice: the flagship command a user runs,
   ``python3 -m dlrover_tpu_torch.launcher.elastic_run --standalone --nnodes
   1 --nproc_per_node 1 -m dlrover_tpu_torch.examples.gpt_elastic``, with a
   fresh job name, ``CKPT_DIR`` in a temporary directory, ``TOTAL_STEPS=30``
   and the CLI's default intervals: the launcher spawns the standalone
   master, the agent runs the saver and keeps a warm spare, and the worker
   trains GPT-2 small at full width. Run A is the command as typed (the
   spare on, the default); run B is the same launcher with
   ``ElasticLaunchConfig(warm_spare=False)`` (``chip_smoke.py
   --tpurun-no-spare <launcher arguments>``). Once the worker has staged
   step 10 or later (by step 18), this process SIGKILLs it (found through
   the agent's pidfile). The launcher must exit 0 and the master with
   SUCCEEDED; the agent must restart the worker once
   (``DLROVER_RESTART_COUNT=1``) after its breakpoint save committed the
   staged step, by adopting the ready spare in run A ("warm": the spare
   held no /dev/nvidia* before, and the next spare follows about
   ``SPARE_SPAWN_DELAY_S`` later) and by a cold start in run B; the new
   worker must restore that step from shm, redo no step but the one in
   flight, load the kernel library from the build cache, and every step of
   both workers must launch 24/12/12 flash kernels with a finite loss
   within 1e-2 of phase 5's uninterrupted run; only the worker may hold the
   GPU (no /dev/nvidia* open in the agent, the master or a spare, at most
   this process's and the worker's contexts in ``nvidia-smi``); afterwards
   no process (worker, spare, agent, master) and no shm segment of the job
   may be left. The time to recover is split into detection, breakpoint
   persist, respawn (hand-off or interpreter, imports, CUDA init, engine,
   library, model build), shm restore and the first step after the resume
   (forward, backward, optimizer, loss fetch, first stage), and printed
   for both runs side by side with the persists, the skipped stages, the
   staged step's lag at the kill, the agent's peak RSS, the spare's RSS and
   the step time while a spare imports.

The output ends with the checkpoint numbers, the ``tpurun`` timings and
the kernel table as one JSON line each, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` as the last line.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor rate and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

MAIN_SHAPE = dict(B=8, T=1024, H=12, D=64, causal=True)
# ragged edges (T % 128 != 0), head_dim 128, batch 1, causal ragged tiles,
# causal q_len < kv_len, where the end-aligned diagonal crosses 128-row tiles
# off their corners, and causal q_len > kv_len at a ragged kv_len, where the
# first q_len - kv_len rows see no key (lse -1e30: the kernels must take their
# p from the mask) and whole Q tiles visit no K tile. On those rows the
# reference's forward averages V over the keys of the blocks it visits, zero
# padding included (ROADMAP.md section C), so its output depends on the block
# size: every comparison runs the plain version at the kernel's own tiles.
RAGGED_SHAPES = [dict(B=1, T=1000, H=4, D=128, causal=False),
                 dict(B=2, T=1000, H=2, D=64, causal=True),
                 dict(B=2, Tq=384, Tkv=1000, H=2, D=64, causal=True),
                 dict(B=2, Tq=1000, Tkv=700, H=2, D=64, causal=True),
                 dict(B=1, Tq=520, Tkv=200, H=3, D=128, causal=True)]
# kernels rewritten for Hopper's wgmma and TMA: their SASS must hold HGMMA and
# UTMALDG
WGMMA_KERNELS = ("fwd", "bwd_dkdv", "bwd_dq")
SOURCE = "dlrover_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {
    "fwd": "dlrover_tpu/ops/flash_attention.py:71",
    "bwd_dkdv": "dlrover_tpu/ops/flash_attention.py:230",
    "bwd_dq": "dlrover_tpu/ops/flash_attention.py:306",
}
# Kernel vs plain version, same bf16 inputs, plain at the kernel's own tiles:
# sums run in another order and p is rounded to bf16 at other points, so a
# bf16 output may differ by one rounding step at its largest magnitude
# (2**-7 relative), and never by more than 2e-2 below magnitude 2.56.
LSE_TOL = 1e-3


def bf16_tol(ref):
    return max(2e-2, 2.0**-7 * float(ref.abs().max()))


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup=3, samples=25, reps=10):
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls of ``fn``, by CUDA events, after warm-up. Back to back, the host
    queues launches ahead of the card, so its dispatch time stays out."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def causal_pairs(t_q, t_kv, causal):
    """Query/key pairs the mask keeps (end-aligned causal)."""
    if not causal:
        return t_q * t_kv
    off = t_kv - t_q
    return sum(min(t_kv, max(0, i + off + 1)) for i in range(t_q))


def bounds(B, T, H, D, causal):
    """(bytes, flops) each kernel must move and compute: each input read
    once, each output written once; matmul flops on the kept pairs."""
    tensor = B * T * H * D * 2  # one bf16 [B, T, H, D]
    row = B * H * T * 4  # one fp32 [B*H, T]
    pairs = B * H * causal_pairs(T, T, causal)
    return {
        "fwd": (3 * tensor + tensor + row, 4 * D * pairs),
        "bwd_dkdv": (4 * tensor + 2 * row + 2 * tensor, 8 * D * pairs),
        "bwd_dq": (4 * tensor + 2 * row + tensor, 6 * D * pairs),
    }


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


KERNEL_SYMBOLS = {"fwd": "flash_fwd_kernel", "bwd_dkdv": "flash_bwd_dkdv_kernel",
                  "bwd_dq": "flash_bwd_dq_kernel"}


def binary_report(build):
    """Per kernel instance ``(name, head_dim)``: registers and spill bytes
    from the ptxas log kept beside the library, and the HGMMA (wgmma) and
    UTMALDG (TMA load) instructions in its SASS (``cuobjdump --dump-sass``).
    Raises if a kernel rewritten for wgmma and TMA issues no HGMMA or no
    UTMALDG."""

    def instance(symbol):
        for name, kernel in KERNEL_SYMBOLS.items():
            m = re.search(kernel + r"ILi(\d+)E", symbol)
            if m:
                return name, int(m.group(1))
        return None

    lib = build.library_path("flash_attention")
    report, cur = {}, None
    with open(lib[: -len(".so")] + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = instance(m.group(1))
                if cur:
                    report[cur] = dict(registers=None, spill_stores=0, spill_loads=0,
                                       hgmma=0, utmaldg=0)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                report[cur]["spill_stores"] = int(m.group(1))
                report[cur]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[cur]["registers"] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = instance(m.group(1))
        elif cur in report:
            report[cur]["hgmma"] += "HGMMA" in line
            report[cur]["utmaldg"] += "UTMALDG" in line
    for (name, d), r in sorted(report.items()):
        log(f"  {name:9s} D={d:3d}: {r['registers']} registers at entry, spills "
            f"{r['spill_stores']} B stored / {r['spill_loads']} B loaded, "
            f"HGMMA {r['hgmma']}, UTMALDG {r['utmaldg']}")
    for name in KERNEL_SYMBOLS:
        for d in (64, 128):
            if (name, d) not in report:
                raise AssertionError(f"no ptxas entry for {name} D={d}")
            for what, key in (("wgmma (HGMMA)", "hgmma"), ("TMA load (UTMALDG)", "utmaldg")):
                if name in WGMMA_KERNELS and report[(name, d)][key] == 0:
                    raise AssertionError(f"{name} D={d} issues no {what} in its SASS")
    return report


def kernel_phase(fa, shape, gen, timed):
    """Kernels vs plain versions at one shape. Returns per-kernel checks and,
    when ``timed``, the timings."""
    import torch
    import torch.nn.functional as F

    B, H, D, causal = (shape[k] for k in ("B", "H", "D", "causal"))
    t_q, t_kv = shape.get("Tq", shape.get("T")), shape.get("Tkv", shape.get("T"))
    dev = "cuda"

    def rand(t):
        return torch.randn((B, t, H, D), device=dev, generator=gen).to(torch.bfloat16)

    q, k, v, do = rand(t_q), rand(t_kv), rand(t_kv), rand(t_q)
    scale = 1.0 / math.sqrt(D)
    out, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    delta = fa.delta_bh(do, out)
    args = (q, k, v, do, lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkdv_cuda(*args)
    dq = fa.flash_bwd_dq_cuda(*args)
    torch.cuda.synchronize()

    b3 = fa._to_bht
    plain_args = (b3(q), b3(k), b3(v), b3(do), lse, delta, scale, causal)
    out3, lse3 = fa.flash_fwd_plain(b3(q), b3(k), b3(v), scale, causal,
                                    *fa.kernel_tiles("fwd", D))
    dk3, dv3 = fa.flash_bwd_dkdv_plain(*plain_args, *fa.kernel_tiles("bwd_dkdv", D))
    dq3 = fa.flash_bwd_dq_plain(*plain_args, *fa.kernel_tiles("bwd_dq", D))

    def err(a, ref):
        return float((a.float() - ref.float()).abs().max())

    checks = {
        "fwd": [("out", err(b3(out), out3), bf16_tol(out3)),
                ("lse", err(lse, lse3), LSE_TOL)],
        "bwd_dkdv": [("dk", err(b3(dk), dk3), bf16_tol(dk3)),
                     ("dv", err(b3(dv), dv3), bf16_tol(dv3))],
        "bwd_dq": [("dq", err(b3(dq), dq3), bf16_tol(dq3))],
    }
    for name, rows in checks.items():
        for what, e, tol in rows:
            log(f"  {name:9s} {what:4s} max_abs_err {e:.3e}  tol {tol:.3e}")
            if not math.isfinite(e) or e > tol:
                raise AssertionError(
                    f"{name} {what} disagrees with its plain version at {shape}: "
                    f"{e:.3e} > {tol:.3e}"
                )
    if not timed:
        return checks, None

    plain_fwd = lambda: fa.flash_fwd_plain(  # noqa: E731
        b3(q), b3(k), b3(v), scale, causal, fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K)
    blocks = (fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    do_t = do.transpose(1, 2)
    times = {
        "fwd": dict(
            ms=time_ms(lambda: fa.flash_fwd_cuda(q, k, v, scale, causal)),
            plain_ms=time_ms(plain_fwd),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), is_causal=causal)),
            library_call="torch.nn.functional.scaled_dot_product_attention (forward)",
        ),
        "bwd_dkdv": dict(
            ms=time_ms(lambda: fa.flash_bwd_dkdv_cuda(*args)),
            plain_ms=time_ms(lambda: fa.flash_bwd_dkdv_plain(*plain_args, *blocks)),
        ),
        "bwd_dq": dict(
            ms=time_ms(lambda: fa.flash_bwd_dq_cuda(*args)),
            plain_ms=time_ms(lambda: fa.flash_bwd_dq_plain(*plain_args, *blocks)),
        ),
    }
    # No single PyTorch call computes dK/dV or dQ alone; the yardstick for
    # both is the backward of scaled_dot_product_attention, which computes
    # dQ, dK and dV together (compare it with the two kernels' sum).
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), do_t, retain_graph=True))
    for name in ("bwd_dkdv", "bwd_dq"):
        times[name]["library_ms"] = sdpa_bwd
        times[name]["library_call"] = (
            "backward of torch.nn.functional.scaled_dot_product_attention "
            "(dQ, dK and dV together)")
    return checks, times


def main_path(fa, gpt, train_step, n_steps=10, batch=8, seq=1024):
    import numpy as np
    import torch

    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(), attention_impl="flash",
                              max_seq_len=seq, use_remat=True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).cuda()
    targets = torch.roll(tokens, -1, dims=1)
    model = gpt.GPT(cfg)
    tx = train_step.default_optimizer()
    state = train_step.init_train_state(model, tokens, tx, seed=0)
    step_fn = train_step.build_train_step(model, tx, gpt.cross_entropy_loss)
    n_params = sum(p.numel() for p in state.params.values())

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens, targets)
        loss = float(loss)  # synchronises
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = dict(fa.launches)
    log(f"  losses {losses}")
    log(f"  step seconds {step_s}")
    log(f"  launches {launches} over {n_steps} steps")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(
            f"first loss {losses[0]} is not near ln(vocab) {math.log(cfg.vocab_size)}")
    per_step = {"fwd": 2 * cfg.num_layers, "bwd_dkdv": cfg.num_layers,
                "bwd_dq": cfg.num_layers}  # forward twice: remat recomputes it
    for name, n in per_step.items():
        if launches[name] != n * n_steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times, expected {n * n_steps}")

    # The trained weights through the flash kernels and through the plain
    # dense attention must give the same per-token losses. The model runs in
    # bf16 and the two paths round at different points (the dense path
    # rounds the logits and probabilities to bf16, the kernels keep them in
    # fp32), so a token's loss may move by a few 1e-2.
    dense = gpt.GPT(dataclasses.replace(cfg, attention_impl="dense"))
    dense.load_state_dict(model.state_dict())
    small_in, small_tgt = tokens[:2, :256], targets[:2, :256]
    with torch.no_grad():
        flash_tl = model(small_in, targets=small_tgt)
        dense_tl = dense(small_in, targets=small_tgt)
    if flash_tl.shape != (2, 256) or not torch.isfinite(flash_tl).all():
        raise AssertionError(f"bad flash token losses {flash_tl.shape}")
    mean_diff = float((flash_tl.mean() - dense_tl.mean()).abs())
    max_diff = float((flash_tl - dense_tl).abs().max())
    log(f"  flash vs dense token losses: mean diff {mean_diff:.3e}, max diff {max_diff:.3e}")
    if mean_diff > 2e-2 or max_diff > 0.25:
        raise AssertionError("flash and dense attention paths disagree")

    steady = statistics.median(step_s[1:])
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * cfg.embed_dim * seq
    return {
        "model": f"gpt2-small-{n_params / 1e6:.0f}M",
        "n_params": n_params,
        "batch": batch, "seq_len": seq, "steps": n_steps,
        "first_step_s": step_s[0], "step_s": steady,
        "tokens_per_s": batch * seq / steady,
        "mfu": flops_per_token * batch * seq / steady / PEAK_BF16_FLOPS,
        "losses": losses,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "flash_vs_dense_mean_loss_diff": mean_diff,
    }


# -- phase 5: flash checkpoint and the elastic loop ---------------------------
#
# This process plays the agent: it runs the checkpoint saver on its main
# thread, and the trainers are separate OS processes (``chip_smoke.py
# --trainer ROLE``) that connect to it under one fresh DLROVER_JOB_NAME.

LOOP_STEPS = 12      # the killed and resumed trainers run steps 0..11
# Phase 6's job; the uninterrupted (reference) trainer runs as many. A
# persist holds the shard lock only for its copy out of shm, so stages go
# on while it writes and a stage at or after step 10 lands within a few steps
# of step 10.
TPURUN_STEPS = 30
STORAGE_EVERY = 5    # storage steps 0, 5, 10; every step is staged to shm
KILL_AT = 7          # the killed trainer dies after staging this step
HASH_AT = 10         # the resumed trainer's last storage step
RESUME_LOSS_TOL = 1e-2
BENCH_STEP = 1000    # first step number of the timed saves
LOOP_BENCH_STEPS = 20


def trainer_setup(small, device):
    """(config, train state, step fn, batches) of the phase's trainers: the
    flagship example's model and data (``examples/gpt_elastic.build``),
    GPT-2 small at full width (flash, remat, seq 1024, batch 8), or a
    2-layer model at embed 64 for the CPU tests. Weights from seed 0; the
    batch of step s is drawn from seed s, so any trainer can resume at any
    step with the same data."""
    from dlrover_tpu_torch.examples import gpt_elastic

    return gpt_elastic.build(small, device)


def state_hash(state):
    """SHA-256 over every leaf's path and bytes (tensors) or value (ints)."""
    import hashlib

    import torch

    from dlrover_tpu_torch.checkpoint.shm_handler import flatten_with_path

    h = hashlib.sha256()
    for path, leaf in flatten_with_path(state):
        h.update(path.encode())
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def emit(result):
    print("RESULT " + json.dumps(result), flush=True)


def trainer(args) -> int:
    """One trainer process of phase 5 (``--trainer ROLE``):

    - ``reference``: run the loop to TPURUN_STEPS uninterrupted (phase 6
      compares with its losses too) and report the losses and launches;
    - ``resume``: run the loop to LOOP_STEPS and report the losses, the
      restored state's hash and the flash launches;
    - ``kill``: run the loop and, after staging KILL_AT, report the state's
      hash and die by SIGKILL while holding the shard lock;
    - ``restore``: restore through the loop only and report the hash;
    - ``bench``: time the checkpoint (phase 5's numbers).
    """
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.common.platform import resolve_device, strict_fp32
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.trainer.dataloader import to_device
    from dlrover_tpu_torch.trainer.loop import ElasticTrainLoop

    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32()
    cfg, state, inner_step, batches = trainer_setup(args.small, device)
    engine = CheckpointEngine(args.ckpt)
    if args.trainer == "bench":
        emit(bench(engine, state, inner_step, batches, device))
        engine.close()
        return 0
    out = {"role": args.trainer, "losses": {}, "hashes": {}}
    live = {}

    def step_fn(st, *batch):
        if args.trainer == "resume" and "restored_hash" not in out:
            out["restored_hash"] = state_hash(st)  # the state restore handed the loop
        live["state"], loss = inner_step(st, *batch)
        return live["state"], loss

    def on_step(step, loss):
        out["losses"][step] = float(loss)
        if (step + 1) % STORAGE_EVERY == 0 and args.trainer != "reference":
            # the next step persists: let this step's stage and the last
            # persist finish, so that save is not skipped (the reference
            # needs only its losses: it runs at the flagship job's pace)
            if not (engine.wait_staged(600) and engine.wait_saving(600)):
                raise RuntimeError(f"stage or persist before step {step + 1} failed")
        if step == HASH_AT:
            out["hashes"][step] = state_hash(live["state"])
        if args.trainer == "kill" and step == KILL_AT:
            die_staged(engine, step, live["state"], out)

    steps = TPURUN_STEPS if args.trainer == "reference" else LOOP_STEPS
    loop = ElasticTrainLoop(engine, step_fn, max_steps=steps, memory_every=1,
                            storage_every=STORAGE_EVERY, log_every=steps, on_step=on_step,
                            input_stage_fn=to_device(device), input_device=device)
    if args.trainer == "restore":
        start, restored = loop.restore(state)
        out.update(step=start - 1, restored_from=engine.restored_from, hash=state_hash(restored))
    else:
        fa.reset_launches()
        loop.run(state, data_factory=lambda start: batches(start, steps))
        out.update(restored_step=loop.start_step - 1, restored_from=engine.restored_from,
                   launches=dict(fa.launches), steps=len(out["losses"]),
                   stage_failures=engine.stage_failures, skipped=engine.skipped_stages,
                   storage_wait_s=engine.storage_wait_s,
                   tracker=engine.storage.latest_step(), staged=engine.shm.read_meta().step)
    emit(out)
    engine.close()
    return 0


def die_staged(engine, step, state, out):
    """Make sure ``step`` is the staged image (the persist of the last storage
    step held the shard lock and made the saves since skip), report its hash,
    then die by SIGKILL holding the shard lock: the agent's lock server must
    free it."""
    import signal

    if not engine.wait_saving(600):
        raise RuntimeError("the last storage step was not persisted")
    engine.wait_staged(600)
    meta = engine.shm.read_meta()
    if meta is None or meta.step != step:
        for _ in range(300):  # as the loop's tail stages its final step
            if engine.save_to_memory(step, state):
                break
            time.sleep(0.1)
    meta = engine.shm.read_meta()
    if meta is None or meta.step != step:
        raise RuntimeError(f"could not stage step {step}")
    out.update(killed_at=step, hash=state_hash(state), stage_failures=engine.stage_failures,
               skipped=engine.skipped_stages)
    emit(out)
    if not engine._shard_lock.acquire(timeout=60):
        raise RuntimeError("shard lock busy")
    os.kill(os.getpid(), signal.SIGKILL)


def bench(engine, state, step_fn, batches, device):
    """Checkpoint timings under the names bench.py's ``_bench_checkpoint``
    reports, on this trainer's full state, with the agent's saver in the
    parent process: blocking save (min of 3 after a warm-up), async block
    (min of 2, each drained and checked; drain = dispatch to staged),
    storage persist (save handed off to committed), restore (shm to the
    device), goodput at a 10-step cadence, and the loop's step with a stage
    every step against the bare step."""
    import torch

    from dlrover_tpu_torch.checkpoint.shm_handler import plan_records
    from dlrover_tpu_torch.trainer.dataloader import to_device
    from dlrover_tpu_torch.trainer.loop import ElasticTrainLoop

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    stage = to_device(device)
    bare = []
    for x, y in batches(0, 12):
        x, y = stage((x, y))
        t0 = time.perf_counter()
        state, loss = step_fn(state, x, y)
        float(loss)
        bare.append(time.perf_counter() - t0)
    bare_step_s = statistics.median(bare[2:])
    nbytes = plan_records(state)[2]

    def staged_step():
        meta = engine.shm.read_meta()
        return -1 if meta is None else meta.step

    step = BENCH_STEP
    if not engine.save_to_memory(step, state):  # warm-up: allocates the pinned buffer
        raise RuntimeError("warm-up save_to_memory skipped")
    blocking = []
    for _ in range(3):
        step += 1
        t0 = time.perf_counter()
        if not engine.save_to_memory(step, state):
            raise RuntimeError(f"save_to_memory skipped at {step}")
        blocking.append(time.perf_counter() - t0)
    step += 1  # warm-up of the async path: allocates the snapshot buffers
    if not (engine.save_to_memory(step, state, block=False) and engine.wait_staged(600)):
        raise RuntimeError("warm-up async stage failed")
    async_block, drain = [], []
    for _ in range(2):
        step += 1
        sync()
        t0 = time.perf_counter()
        if not engine.save_to_memory(step, state, block=False):
            raise RuntimeError(f"async save skipped at {step}")
        t1 = time.perf_counter()
        if not engine.wait_staged(600) or staged_step() != step:
            raise RuntimeError(f"async stage of {step} failed")
        t2 = time.perf_counter()
        async_block.append(t1 - t0)
        drain.append(t2 - t0)
    step += 1
    t0 = time.perf_counter()
    if not engine.save_to_storage(step, state):
        raise RuntimeError(f"save_to_storage skipped at {step}")
    t1 = time.perf_counter()
    while engine.storage.latest_step() != step:  # finer than wait_saving's 0.1 s poll
        if time.perf_counter() - t1 > 600 or engine.storage.persist_error(0):
            raise RuntimeError(f"persist of {step} failed")
        time.sleep(0.002)
    persist_s = time.perf_counter() - t1
    t0 = time.perf_counter()
    got, _ = engine.load(state)
    restore_s = time.perf_counter() - t0
    if got != step:
        raise RuntimeError(f"restored step {got}, expected {step}")

    # the loop, staging every step (async), against the bare step above
    counts = {"staged": 0, "skipped_in_flight": 0, "skipped_busy": 0}
    save = engine.save_to_memory

    def counting_save(s, tree, *a, **kw):
        in_flight = engine.staging_in_flight
        ok = save(s, tree, *a, **kw)
        if kw.get("block", True) is False:
            counts["staged" if ok else "skipped_in_flight" if in_flight else "skipped_busy"] += 1
        return ok

    engine.save_to_memory = counting_save
    stamps = []

    def on_step(s, loss):
        float(loss)
        stamps.append(time.perf_counter())

    first = step + 1
    loop = ElasticTrainLoop(engine, step_fn, max_steps=first + LOOP_BENCH_STEPS, memory_every=1,
                            storage_every=0, log_every=10 ** 9, on_step=on_step,
                            input_stage_fn=stage, input_device=device)
    loop.run(state, data_factory=lambda start: batches(start, first + LOOP_BENCH_STEPS))
    engine.save_to_memory = save
    if loop.start_step != first:
        raise RuntimeError(f"loop resumed at {loop.start_step}, expected {first}")
    loop_steps = [b - a for a, b in zip(stamps, stamps[1:])][1:]
    loop_step_s = statistics.median(loop_steps)
    async_block_s = min(async_block)
    save_block_s = min(blocking)

    def gbps(seconds):
        return nbytes / seconds / 1e9

    return {
        "ckpt_bytes": nbytes,
        "save_block_s": save_block_s, "save_block_gbps": gbps(save_block_s),
        "save_block_runs_s": blocking,
        "async_block_s": async_block_s, "async_block_runs_s": async_block,
        "async_drain_s": min(drain), "async_drain_gbps": gbps(min(drain)),
        "persist_s": persist_s, "persist_gbps": gbps(persist_s),
        "restore_s": restore_s, "restore_gbps": gbps(restore_s),
        "restored_from": engine.restored_from,
        "bare_step_s": bare_step_s,
        "goodput_10": 10 * bare_step_s / (10 * bare_step_s + async_block_s),
        "loop_step_s": loop_step_s, "loop_overhead": loop_step_s / bare_step_s - 1,
        "loop_steps": len(loop_steps), "loop_saves": counts,
        "stage_failures": engine.stage_failures,
    }


def checkpoint_phase(work, job, device="cuda", small=False, n_params=None, timeout=600,
                     run_bench=True):
    """Phase 5. This process runs the saver (the agent's part); trainers run
    as child processes under DLROVER_JOB_NAME ``job`` with storage and
    sockets under ``work``. Raises on the first failed check; returns the
    phase's facts and the checkpoint numbers (None without ``run_bench``).
    The environment and socket directory it sets are restored on return."""
    from dlrover_tpu_torch.common import multi_process

    names = ("DLROVER_JOB_NAME", "DLROVER_IPC_DIR", "DLROVER_IPC_NAMESPACE")
    saved_env = {name: os.environ.get(name) for name in names}
    saved_dir = multi_process.SOCKET_TMP_DIR
    os.environ["DLROVER_JOB_NAME"] = job
    os.environ["DLROVER_IPC_DIR"] = multi_process.SOCKET_TMP_DIR = os.path.join(work, "sockets")
    os.environ.pop("DLROVER_IPC_NAMESPACE", None)
    try:
        return _checkpoint_phase(work, job, device, small, n_params, timeout, run_bench)
    finally:
        for name, value in saved_env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        multi_process.SOCKET_TMP_DIR = saved_dir


def _checkpoint_phase(work, job, device, small, n_params, timeout, run_bench):
    import signal

    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver, lock_name
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler
    from dlrover_tpu_torch.checkpoint.storage import PosixCheckpointStorage
    from dlrover_tpu_torch.common import multi_process

    ckpt, ref_ckpt = os.path.join(work, "ckpt"), os.path.join(work, "ref")

    if n_params is not None:
        image = 12 * n_params + 16  # fp32 params, mu and nu; step and count
        free = shutil.disk_usage("/dev/shm").free
        log(f"  /dev/shm free {free} bytes; one image {image} bytes (+ its JSON meta); "
            f"two images at once (the reference trainer stages its own); cuts: none")
        if free < 2.1 * image:
            raise AssertionError("/dev/shm cannot hold two images of the train state")

    def child(role, namespace=None, expect_kill=False, root=ckpt):
        env = dict(os.environ)
        if namespace:
            env["DLROVER_IPC_NAMESPACE"] = namespace
        cmd = [sys.executable, os.path.abspath(__file__), "--trainer", role, "--ckpt", root,
               "--device", device] + (["--small"] if small else [])
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        ok_rc = -signal.SIGKILL if expect_kill else 0
        if proc.returncode != ok_rc or not lines:
            raise AssertionError(f"trainer {role} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        result = json.loads(lines[-1][len("RESULT "):])
        log(f"  trainer {role}: {time.perf_counter() - t0:.1f} s, exit {proc.returncode}")
        return result

    def check(cond, msg):
        if not cond:
            raise AssertionError(msg)

    AsyncCheckpointSaver.start_async_saving_ckpt()
    try:
        ref = child("reference", namespace=f"{job}_ref", root=ref_ckpt)
        log(f"  uninterrupted losses {ref['losses']}")
        check(ref["steps"] == TPURUN_STEPS and ref["restored_step"] == -1, f"reference run {ref}")

        killed = child("kill", expect_kill=True)
        shm = SharedMemoryHandler(0)
        meta = shm.read_meta()
        tracker = PosixCheckpointStorage(ckpt).latest_step()
        lock = multi_process.SharedLock(lock_name(0))
        deadline = time.monotonic() + 30
        while lock.locked() and time.monotonic() < deadline:
            time.sleep(0.1)
        lock_free = not lock.locked()
        lock.close()
        log(f"  killed at step {killed['killed_at']}: shm step {meta and meta.step}, "
            f"storage tracker {tracker}, shard lock free {lock_free}")
        check(meta is not None and meta.step == KILL_AT, f"shm holds {meta and meta.step}")
        check(tracker == STORAGE_EVERY, f"storage tracker {tracker}")
        check(lock_free, "the dead trainer's shard lock was not freed")

        resumed = child("resume")
        diffs = [abs(resumed["losses"][str(s)] - ref["losses"][str(s)])
                 for s in range(KILL_AT + 1, LOOP_STEPS)]
        bit_equal = all(resumed["losses"][str(s)] == ref["losses"][str(s)]
                        for s in range(KILL_AT + 1, LOOP_STEPS))
        log(f"  resumed from {resumed['restored_from']} at step {resumed['restored_step']}, "
            f"hash equal {resumed.get('restored_hash') == killed['hash']}; losses "
            f"{resumed['losses']}; max diff vs uninterrupted {max(diffs):.3e}, "
            f"bit-equal {bit_equal}; launches {resumed['launches']}")
        check(resumed["restored_step"] == KILL_AT, f"resumed at {resumed['restored_step']}")
        check(resumed["restored_from"] in ("prefetch", "memory"), "not restored from shm")
        check(resumed.get("restored_hash") == killed["hash"], "restored state differs from the killed one")
        check(max(diffs) <= RESUME_LOSS_TOL, f"resumed losses differ by {max(diffs)}")
        check(resumed["tracker"] == HASH_AT, f"storage tracker {resumed['tracker']}")
        n = LOOP_STEPS - KILL_AT - 1
        if device == "cuda":
            per_step = {"fwd": 24, "bwd_dkdv": 12, "bwd_dq": 12}
            check(resumed["launches"] == {k: v * n for k, v in per_step.items()},
                  f"loop launches {resumed['launches']} over {n} steps")
        failures = ref["stage_failures"] + killed["stage_failures"] + resumed["stage_failures"]
        check(failures == 0, f"{failures} async stages failed")

        shm.unlink()
        restored = child("restore")
        log(f"  after unlinking shm: restored step {restored['step']} from "
            f"{restored['restored_from']}, hash equal {restored['hash'] == resumed['hashes'][str(HASH_AT)]}")
        check(restored["step"] == HASH_AT and restored["restored_from"] == "storage",
              f"storage rung restored {restored['step']} from {restored['restored_from']}")
        check(restored["hash"] == resumed["hashes"][str(HASH_AT)], "storage restore differs")

        numbers = child("bench") if run_bench else None
        if numbers is not None:
            check(numbers["stage_failures"] == 0, "async stages failed in the bench")
        # this process's saver: the shard lock's hold (the copy out of shm)
        # and the write of each persist, and the stages the trainers skipped
        persists = list(AsyncCheckpointSaver._instance.persist_stats)
        skipped = {role: r["skipped"] for role, r in
                   (("reference", ref), ("kill", killed), ("resume", resumed))}
        log(f"  persists (step, lock hold s, write s): "
            f"{[(p['step'], round(p['hold_s'], 4), round(p['write_s'], 3)) for p in persists]}")
        log(f"  stages skipped: {skipped}")
        facts = {"resume_max_loss_diff": max(diffs), "resume_bit_equal": bit_equal,
                 "restored_from": resumed["restored_from"], "storage_rung_step": restored["step"],
                 "loop_launches": resumed["launches"], "loop_steps": n,
                 "reference_losses": ref["losses"], "persists": persists,
                 "skipped_stages": skipped}
        if numbers is not None:
            numbers["persist_lock_hold_s"] = [p["hold_s"] for p in persists]
            numbers["persist_write_s"] = [p["write_s"] for p in persists]
            numbers["skipped_stages"] = skipped
        return facts, numbers
    finally:
        AsyncCheckpointSaver.shutdown()
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrover_{job}"):
                os.unlink(os.path.join("/dev/shm", name))


# -- phase 6: the flagship command under its own agent -----------------------
#
# The user's command, ``elastic_run --standalone ... -m gpt_elastic``, runs as
# a child of this process: the launcher spawns the standalone master, its
# agent runs the saver and supervises the worker. Once the worker has
# staged step TPURUN_KILL_AFTER or a later one (and is computing the next),
# this process SIGKILLs the worker, found through the agent's pidfile.

TPURUN_KILL_AFTER = 10
# the phase fails if the staged step that meets the kill's condition comes
# later than this: with the persist off the shard lock, stages land within a
# few steps of step 10
TPURUN_KILL_BY = 18
TPURUN_LOSS_TOL = 1e-2
FLAGSHIP = ["-m", "dlrover_tpu_torch.launcher.elastic_run", "--standalone", "--nnodes", "1",
            "--nproc_per_node", "1", "-m", "dlrover_tpu_torch.examples.gpt_elastic"]


class _JobOutput:
    """Both pipes of the job, read line by line on two threads: every line,
    the example's records (``gpt_elastic {json}``) and the agent's recovery
    records (``agent recovery: {json}``)."""

    def __init__(self, proc):
        import threading

        self.lock = threading.Lock()
        self.lines, self.records, self.recoveries = [], [], []
        self.threads = [threading.Thread(target=self._read, args=(pipe,), daemon=True)
                        for pipe in (proc.stdout, proc.stderr)]
        for t in self.threads:
            t.start()

    def _read(self, pipe):
        for raw in iter(pipe.readline, ""):
            line = raw.rstrip("\n")
            with self.lock:
                self.lines.append(line)
                if line.startswith("gpt_elastic "):
                    self.records.append(json.loads(line[len("gpt_elastic "):]))
                m = re.search(r"agent recovery: (\{.*\})", line)
                if m:
                    self.recoveries.append(json.loads(m.group(1)))

    def events(self, kind, pid=None):
        with self.lock:
            return [r for r in self.records if r["event"] == kind and pid in (None, r["pid"])]

    def grep(self, pattern):
        with self.lock:
            return [m for m in (re.search(pattern, ln) for ln in self.lines) if m]

    def join(self, timeout=30):
        for t in self.threads:
            t.join(timeout)


def _proc_alive(pid):
    from dlrover_tpu_torch.agent.worker import _proc_stat

    info = _proc_stat(pid)
    return info is not None and info[0] != "Z"


def _proc_children(ppid):
    """(pid, command line) of the live children of ``ppid``."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat", "rb") as f:
                stat = f.read()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(stat[stat.rindex(b")") + 2:].split()[1]) == ppid:
            out.append((int(name), cmd))
    return out


def _group_members(pgids):
    """Live pids whose process group is one of ``pgids``."""
    found = []
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                if os.getpgid(int(name)) in pgids and _proc_alive(int(name)):
                    found.append(int(name))
            except OSError:
                continue
    return found


def _nvidia_fds(pid):
    """The /dev/nvidia* files ``pid`` holds open: a process with a CUDA
    context holds the device node (``nvidia-smi`` cannot name the pids of
    a process in a container: it reports them in the host's pid
    namespace)."""
    held = set()
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                held.add(target)
    except OSError:
        pass
    return sorted(held)


def _gpu_owners(device, agent_pid, master_pid, worker_pid):
    """Who holds the GPU while the job runs: the worker must, the agent
    (which runs the saver) and the master must not."""
    owners = {"agent": _nvidia_fds(agent_pid), "master": _nvidia_fds(master_pid),
              "worker": _nvidia_fds(worker_pid)}
    if device == "cuda":
        apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
        owners["nvidia_smi_compute_apps"] = apps
    return owners


def _uninterrupted_losses(work, job, device, small, total_steps, timeout):
    """Losses of the example run alone (no agent, no fault) to the same
    step: the reference when phase 5's reference trainer is not at hand."""
    env = dict(os.environ, DLROVER_JOB_NAME=job, CKPT_DIR=os.path.join(work, "ref_ckpt"),
               TOTAL_STEPS=str(total_steps), DLROVER_IPC_DIR=os.path.join(work, "ref_sockets"))
    for name in ("DLROVER_MASTER_ADDR", "DLROVER_IPC_NAMESPACE"):
        env.pop(name, None)
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.examples.gpt_elastic"] + (
        ["--device", "cpu", "--small"] if small else [])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    finally:
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrover_{job}_"):
                os.unlink(os.path.join("/dev/shm", name))
    if proc.returncode != 0:
        raise AssertionError(f"uninterrupted example exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return {str(r["step"]): r["loss"] for r in
            (json.loads(ln[len("gpt_elastic "):]) for ln in proc.stdout.splitlines()
             if ln.startswith("gpt_elastic ")) if r["event"] == "step"}


# /proc/<pid>/status fields the memory report reads, where the kernel has
# them: the resident set, its peak, and its anonymous, file-backed (the
# libraries torch maps) and shared-memory parts; and from /proc/<pid>/statm
# the resident pages and those of them backed by a file or shared memory
# ("StatmShared"), for kernels whose status has no split
MEM_FIELDS = ("VmRSS", "VmHWM", "RssAnon", "RssFile", "RssShmem")


class _Watch:
    """Samples, every 0.1 s on a thread, the agent's memory
    (``MEM_FIELDS``) and its warm spares: when each was first seen, when it
    wrote its ready marker (the marker's mtime), the /dev/nvidia* files it
    holds while it is still a spare (the marker exists before and after the
    sample) and its memory then."""

    def __init__(self, agent_pid):
        import threading

        self.agent_pid = agent_pid
        self.lock = threading.Lock()
        self.spares = {}
        self.agent_mem = []  # (wall-clock, {field: kB})
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def _mem_kb(pid):
        """{field: kB} of ``MEM_FIELDS`` that /proc/<pid>/status has."""
        found = {}
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    if key in MEM_FIELDS:
                        found[key] = int(rest.split()[0])
        except (OSError, ValueError, IndexError):
            pass
        try:
            with open(f"/proc/{pid}/statm") as f:
                fields = f.read().split()
            page_kb = os.sysconf("SC_PAGE_SIZE") // 1024
            found["StatmResident"] = int(fields[1]) * page_kb
            found["StatmShared"] = int(fields[2]) * page_kb
        except (OSError, ValueError, IndexError):
            pass
        return found

    @staticmethod
    def _ready_file(pid):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                for item in f.read().split(b"\0"):
                    if item.startswith(b"DLROVER_WARM_READY_FILE="):
                        return item.split(b"=", 1)[1].decode()
        except OSError:
            pass
        return None

    def _sample(self):
        now = time.time()
        mem = self._mem_kb(self.agent_pid)
        if mem:
            with self.lock:
                self.agent_mem.append((now, mem))
        for pid, cmd in _proc_children(self.agent_pid):
            if "dlrover_tpu_torch.agent.warm_worker" not in cmd:
                continue
            with self.lock:
                rec = self.spares.setdefault(pid, {"pid": pid, "seen": now, "ready": None,
                                                   "ready_file": None, "nvidia_fds": [],
                                                   "samples": 0, "mem_kb": {}})
            if rec["ready_file"] is None:
                rec["ready_file"] = self._ready_file(pid)
            marker = rec["ready_file"]
            if not marker or not os.path.exists(marker):
                continue
            try:
                ready = os.stat(marker).st_mtime
            except OSError:
                continue
            fds = _nvidia_fds(pid)
            mem = self._mem_kb(pid)
            if os.path.exists(marker):  # still a spare after the sample
                with self.lock:
                    rec["ready"] = rec["ready"] or ready
                    rec["nvidia_fds"] = sorted(set(rec["nvidia_fds"]) | set(fds))
                    rec["samples"] += 1
                    for key, kb in mem.items():
                        rec["mem_kb"][key] = max(rec["mem_kb"].get(key, 0), kb)

    def _run(self):
        while not self._stop.wait(0.1):
            try:
                self._sample()
            except Exception as e:  # noqa: BLE001 — a sampler must not end the phase
                log(f"  watch: sample failed: {e!r}")

    def ready_spares(self):
        """The spares whose marker exists now: ready and not adopted."""
        with self.lock:
            return [dict(r) for r in self.spares.values()
                    if r["ready_file"] and os.path.exists(r["ready_file"])]

    def stop(self):
        self._stop.set()
        self._thread.join(10)


def _no_spare_entry(argv) -> int:
    """``chip_smoke.py --tpurun-no-spare <launcher arguments>``: the
    launcher's ``run`` with ``ElasticLaunchConfig(warm_spare=False)``, the
    caller's way to turn the spare off (there is no flag for it)."""
    from dlrover_tpu_torch.launcher import elastic_run

    ns = elastic_run.parse_args(argv)
    config = elastic_run.config_from_args(ns)
    config.warm_spare = False
    return elastic_run.run(ns, config)


def _median(values):
    return statistics.median(values) if values else None


def tpurun_phase(work, job, device="cuda", small=False, total_steps=TPURUN_STEPS,
                 reference=None, timeout=600, card=None, warm_spare=True, job_log=None):
    """Phase 6: the flagship command, a worker SIGKILL, and its recovery
    under the job's own agent. With ``warm_spare`` (run A) the command runs
    as a user types it and the recovery must adopt the warm spare; without
    (run B) the same launcher runs with ``ElasticLaunchConfig(warm_spare=
    False)`` and the recovery must be a cold start. Raises on the first
    failed check; returns the phase's facts and the ``tpurun`` timings.
    ``reference`` maps step (as a string) to the loss of an uninterrupted
    run of the same configuration; without it the example runs once alone
    first. ``job_log``, when given, is a file that receives every line of
    the job's output."""
    import signal

    from dlrover_tpu_torch.agent.training_agent import ElasticTrainingAgent
    from dlrover_tpu_torch.agent.worker import read_pidfile
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    def check(cond, msg):
        if not cond:
            raise AssertionError(msg)

    if reference is None:
        reference = _uninterrupted_losses(work, f"{job}_ref", device, small, total_steps, timeout)
    ipc_dir = os.path.join(work, "sockets")
    env = dict(os.environ, DLROVER_JOB_NAME=job, CKPT_DIR=os.path.join(work, "ckpt"),
               TOTAL_STEPS=str(total_steps), DLROVER_IPC_DIR=ipc_dir)
    for name in ("DLROVER_MASTER_ADDR", "DLROVER_IPC_NAMESPACE", "DLROVER_NODE_ID",
                 "DLROVER_NODE_RANK"):
        env.pop(name, None)
    extra = ["--device", "cpu", "--small"] if small else []
    if warm_spare:
        cmd = [sys.executable] + FLAGSHIP + extra
    else:
        cmd = [sys.executable, os.path.abspath(__file__), "--tpurun-no-spare"] + FLAGSHIP[2:] + extra
    saved_ns = os.environ.get("DLROVER_IPC_NAMESPACE")
    os.environ["DLROVER_IPC_NAMESPACE"] = job  # names this process's view of the job's shm
    try:
        shm = SharedMemoryHandler(0)
    finally:
        if saved_ns is None:
            os.environ.pop("DLROVER_IPC_NAMESPACE", None)
        else:
            os.environ["DLROVER_IPC_NAMESPACE"] = saved_ns
    t_launch = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    out = _JobOutput(proc)
    watch = _Watch(proc.pid)
    deadline = time.monotonic() + timeout
    pids = {"agent": proc.pid}
    owners = []
    at_kill = {}

    def wait_for(what, cond, poll=0.01):
        while True:
            got = cond()
            if got:
                return got
            if proc.poll() is not None or time.monotonic() > deadline:
                why = "timed out" if proc.poll() is None else f"the job exited {proc.returncode}"
                meta = shm.read_meta()
                tail = [ln for ln in out.lines if "skip save_to_memory" not in ln][-60:]
                raise AssertionError(f"{why} while waiting for {what} (shm holds step "
                                     f"{meta and meta.step}):\n" + "\n".join(tail))
            time.sleep(poll)

    try:
        pids["master"] = wait_for("the standalone master", lambda: next(
            (p for p, c in _proc_children(proc.pid) if "dlrover_tpu_torch.master.main" in c), None),
            poll=0.05)
        boot0 = wait_for("the first worker's boot", lambda: out.events("boot"))[0]
        recorded = read_pidfile(job)
        check(recorded is not None and recorded[0] == boot0["pid"],
              f"pidfile {recorded} does not name the worker {boot0['pid']}")
        pids["worker0"] = boot0["pid"]
        wait_for("the first step", lambda: out.events("step", boot0["pid"]), poll=0.05)
        owners.append(_gpu_owners(device, proc.pid, pids["master"], boot0["pid"]))

        def staged_and_computing_next():
            # A stage (0.2 s on the card) outlasts a step (about 0.1 s), so
            # about every other step is staged: kill when the staged step is
            # at most one behind the last finished one, so that only that
            # step, in flight to shm, is redone.
            steps = out.events("step", boot0["pid"])
            last = steps[-1]["step"] if steps else -1
            if last < TPURUN_KILL_AFTER or (warm_spare and not watch.ready_spares()):
                return None
            meta = shm.read_meta()
            if meta is not None and meta.step >= max(TPURUN_KILL_AFTER, last - 1):
                return meta, last
            return None

        meta, last = wait_for(f"a staged step >= {TPURUN_KILL_AFTER}", staged_and_computing_next)
        worker_pid = read_pidfile(job)[0]
        check(worker_pid == boot0["pid"], f"pidfile names {worker_pid}, not {boot0['pid']}")
        at_kill = {"staged": meta.step, "trained": last, "spares": watch.ready_spares()}
        t_kill = time.time()
        os.kill(worker_pid, signal.SIGKILL)
        log(f"  SIGKILLed worker pid {worker_pid} with step {meta.step} staged, step {last} "
            f"trained; ready spares {[r['pid'] for r in at_kill['spares']]}")
        boot1 = wait_for("the restarted worker's boot", lambda: (
            out.events("boot")[1:] or None))[0]
        pids["worker1"] = boot1["pid"]
        wait_for("the restarted worker's first step", lambda: out.events("step", boot1["pid"]),
                 poll=0.05)
        owners.append(_gpu_owners(device, proc.pid, pids["master"], boot1["pid"]))
        rc = proc.wait(max(1.0, deadline - time.monotonic()))
    finally:
        t_end = time.time()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)
        watch.stop()
        spare_pids = list(watch.spares)
        for name in ("worker0", "worker1", "master"):
            if name in pids and _proc_alive(pids[name]):
                os.killpg(os.getpgid(pids[name]), signal.SIGKILL)
        out.join()
        shm.close()
    time.sleep(0.5)  # the agent's last kills are reaped by now
    leaked = [p for p in list(pids.values()) + spare_pids if _proc_alive(p)] + _group_members(
        {pids[n] for n in ("worker0", "worker1") if n in pids} | set(spare_pids))
    for p in leaked:
        try:
            os.kill(p, signal.SIGKILL)
        except OSError:
            pass
    segments = [n for n in os.listdir("/dev/shm") if n.startswith(f"dlrover_{job}_")]
    for name in segments:
        os.unlink(os.path.join("/dev/shm", name))
    log("  job output (last lines):\n    " + "\n    ".join(out.lines[-12:]))
    if job_log:
        with open(job_log, "w") as f:
            f.write("\n".join(out.lines) + "\n")

    check(rc == 0, f"tpurun exited {rc}")
    check(out.grep(r"job master exiting: succeeded"), "the master did not exit with SUCCEEDED")
    master_rc = out.grep(r"standalone master pid=\d+ exited rc=(-?\d+)")
    check(master_rc and master_rc[-1].group(1) == "0", "the standalone master did not exit 0")
    boots = out.events("boot")
    check(len(boots) == 2 and len(out.recoveries) == 1,
          f"{len(boots)} worker boots and {len(out.recoveries)} recoveries, expected 2 and 1")
    rec = out.recoveries[0]
    check(rec["pid"] == worker_pid and rec["signal"] == signal.SIGKILL,
          f"the agent saw {rec}, not the SIGKILL of {worker_pid}")
    check([b["restart_count"] for b in boots] == [0, 1],
          f"RESTART_COUNT seen {[b['restart_count'] for b in boots]}")
    staged = rec.get("persisted_step", -1)
    check(TPURUN_KILL_AFTER <= staged <= TPURUN_KILL_BY,
          f"breakpoint save persisted step {staged}: a stage at or after step "
          f"{TPURUN_KILL_AFTER} should land by step {TPURUN_KILL_BY}")
    check(boot1["tracker"] == staged,
          f"storage held step {boot1['tracker']} at the restart, not the staged {staged}")
    (resume,) = out.events("resume", boot1["pid"])
    check(resume["restored_step"] == staged and resume["restored_from"] in ("prefetch", "memory"),
          f"restored step {resume['restored_step']} from {resume['restored_from']}, "
          f"expected {staged} from shm")
    steps0 = {r["step"]: r for r in out.events("step", boot0["pid"])}
    steps1 = {r["step"]: r for r in out.events("step", boot1["pid"])}
    redone = sorted(set(steps0) & set(steps1))
    check(sorted(steps0)[: staged + 1] == list(range(staged + 1)) and max(steps0) <= staged + 1,
          f"first worker's steps {sorted(steps0)}")
    check(sorted(steps1) == list(range(staged + 1, total_steps)),
          f"restarted worker's steps {sorted(steps1)}")
    check(set(redone) <= {staged + 1}, f"steps {redone} were redone")
    diffs = {}
    for s, r in list(steps0.items()) + list(steps1.items()):
        check(math.isfinite(r["loss"]), f"non-finite loss at step {s}")
        diffs[s] = max(diffs.get(s, 0.0), abs(r["loss"] - reference[str(s)]))
    max_diff = max(diffs.values())
    check(max_diff <= TPURUN_LOSS_TOL, f"losses differ from the uninterrupted run by {max_diff}")
    if device == "cuda":
        per_step = {"fwd": 24, "bwd_dkdv": 12, "bwd_dq": 12}
        bad = [(s, r["launches"]) for s, r in list(steps0.items()) + list(steps1.items())
               if r["launches"] != per_step]
        check(not bad, f"steps with other flash launches than {per_step}: {bad[:3]}")
        check(boot1["lib_cached"] is True, "the restarted worker built the kernel library again")
    for seen in owners:
        check(not seen["agent"] and not seen["master"],
              f"the agent or the master holds the GPU: {seen}")
        check(device != "cuda" or seen["worker"], f"the worker holds no GPU device: {seen}")
        check(len(seen.get("nvidia_smi_compute_apps", [])) <= 2,
              f"more CUDA contexts than this process and the worker: {seen}")
    check(not leaked, f"processes of the job still alive: {leaked}")
    check(not segments, f"shm segments of the job left behind: {segments}")

    # the warm spare: adopted in run A, absent in run B
    how = rec.get("how")
    spawns = [(int(m.group(1)), float(m.group(2)))
              for m in out.grep(r"spawned warm spare pid=(\d+) at ([\d.]+)")]
    spares = {pid: dict(r) for pid, r in watch.spares.items()}
    for r in spares.values():
        r["ready_s"] = r["ready"] - r["seen"] if r["ready"] else None
    later = [(p, t) for p, t in spawns if t > rec["respawned"]]
    job_end = max(r["t"] for r in steps1.values())
    if warm_spare:
        check(how == "warm", f"the recovery was {how}, not warm")
        check(at_kill["spares"], "no ready warm spare before the kill")
        check(boot1["adopted"] and boot1["pid"] in [r["pid"] for r in at_kill["spares"]],
              f"the restarted worker {boot1['pid']} is not the spare of the kill "
              f"{[r['pid'] for r in at_kill['spares']]}")
        check(spares.get(boot1["pid"], {}).get("samples", 0) > 0,
              "the adopted spare was never sampled before its promotion")
        held = {p: r["nvidia_fds"] for p, r in spares.items() if r["nvidia_fds"]}
        check(not held, f"a spare held /dev/nvidia* before its promotion: {held}")
        # the next spare, SPARE_SPAWN_DELAY_S after the worker start; the agent
        # spawns none once the job has ended
        delay = ElasticTrainingAgent.SPARE_SPAWN_DELAY_S
        if job_end - rec["respawned"] > delay + 1.0:
            check(later and abs(later[0][1] - rec["respawned"] - delay) < 2.0,
                  f"no spare spawned {delay} s after the worker start {rec['respawned']}: "
                  f"{spawns}")
    else:
        check(how == "cold", f"the recovery was {how}, not cold")
        check(not spawns and not spares, f"warm spares with warm_spare=False: {spawns}")
        check(not boot1["adopted"], "the restarted worker was an adopted spare")

    up = out.grep(r"standalone master at \S+ up in ([\d.]+) s")
    rdzv = out.grep(r"world ready: round=0 .*\(rendezvous ([\d.]+) s\)")
    spawn0 = out.grep(rf"started worker pid={boot0['pid']} restart=0 \((\w+)\) .* at ([\d.]+)")
    first0 = steps0[0]
    first1 = steps1[staged + 1]
    (resume0,) = out.events("resume", boot0["pid"])
    first_split = {r["pid"]: {k: v for k, v in r.items() if k.endswith("_s") or k == "staged"}
                   for r in out.events("first_step")}

    def boot_split(b):
        return {"import_s": b["t_imported"] - b["t_start"], "cuda_init_s": b["t_cuda"] - b["t_imported"],
                "engine_s": b["t_engine"] - b["t_cuda"], "lib_load_s": b["t_lib"] - b["t_engine"],
                "model_build_s": b["t_model"] - b["t_lib"]}

    restore_end = resume["t_loop"] + resume["restore_s"]
    recovery = {
        "how": how,
        "detect_s": rec["detected"] - t_kill,
        "breakpoint_persist_s": rec["persisted"] - rec["detected"],
        "respawn_s": resume["t_loop"] - rec["persisted"],
        "restore_s": resume["restore_s"],
        "first_step_s": first1["t"] - restore_end,
        "total_s": first1["t"] - t_kill,
        "respawn_split": {"agent_s": rec["respawned"] - rec["persisted"],
                          "rendezvous_s": rec["rdzv_s"],
                          # warm: the hand-off (contract line to the script);
                          # cold: a fresh interpreter up to the script
                          "start_s": boot1["t_start"] - rec["respawned"],
                          **boot_split(boot1)},
        "first_step_split": first_split.get(boot1["pid"]),
    }
    if boot1["adopted"]:
        recovery["spare"] = {k: boot1[k] for k in ("spare_import_s", "spare_age_s",
                                                    "contract_to_script_s")}

    # the persists: the shard lock's hold (the copy out of shm) and the write
    persists = [{"step": int(m.group(1)), "hold_s": float(m.group(2)), "write_s": float(m.group(3))}
                for m in out.grep(r"persisted step (\d+): shard lock held ([\d.]+) s "
                                  r"\(snapshot\), write ([\d.]+) s")]
    last0, last1 = steps0[max(steps0)], steps1[max(steps1)]
    skipped = {name: r.get("skipped") for name, r in (("worker0", last0), ("worker1", last1))}

    # the loop's step while a spare imports (spawned, not ready yet), against
    # the other steps of the same worker; the first step of each worker is
    # left out
    windows = [(r["seen"], r["ready"]) for r in spares.values() if r["ready"]]
    step_split = {}
    for name, steps in (("worker0", steps0), ("worker1", steps1)):
        during, other = [], []
        ordered = [steps[s] for s in sorted(steps)]
        for prev, cur in zip(ordered, ordered[1:]):
            dt = cur["t"] - prev["t"]
            hit = any(prev["t"] < b and cur["t"] > a for a, b in windows)
            (during if hit else other).append(dt)
        step_split[name] = {"while_spare_imports": {"median": _median(during), "n": len(during)},
                            "other": {"median": _median(other), "n": len(other)}}
    def gb(mem):
        return {key: kb / 2**20 for key, kb in mem.items()}

    def peak(samples):
        out = {}
        for mem in samples:
            for key, kb in mem.items():
                out[key] = max(out.get(key, 0), kb)
        return out

    # the agent before the first persist (its first step's end: step 0 is a
    # storage step) and at its peak: the persist buffers are the difference
    agent_before = peak([m for t, m in watch.agent_mem if t < first0["t"]])
    agent_peak = peak([m for _, m in watch.agent_mem])
    timings = {
        "card": card, "model": "gpt2-small" if not small else "small", "warm_spare": warm_spare,
        "n_params": boot0["n_params"], "steps": total_steps, "killed_with_staged_step": staged,
        "kill": {"staged": at_kill["staged"], "trained": at_kill["trained"],
                 "lag_steps": at_kill["trained"] - at_kill["staged"]},
        "monitor_interval_s": 5.0,
        "cold_start": {
            "how": spawn0[0].group(1) if spawn0 else None,
            "master_start_s": float(up[0].group(1)) if up else None,
            "first_rendezvous_s": float(rdzv[0].group(1)) if rdzv else None,
            "start_s": boot0["t_start"] - float(spawn0[0].group(2)) if spawn0 else None,
            **boot_split(boot0),
            "first_step_s": first0["t"] - (resume0["t_loop"] + resume0["restore_s"]),
            "first_step_split": first_split.get(boot0["pid"]),
            "launch_to_first_step_s": first0["t"] - t_launch,
        },
        "recovery": recovery,
        "persists": persists,
        "skipped_stages": skipped,
        "storage_wait_s": {"worker0": last0.get("storage_wait_s"),
                           "worker1": last1.get("storage_wait_s")},
        "agent_mem_gb_before_first_persist": gb(agent_before),
        "agent_mem_gb_peak": gb(agent_peak),
        "spares": [{"pid": r["pid"], "ready_s": r["ready_s"], "mem_gb": gb(r["mem_kb"]),
                    "nvidia_fds": r["nvidia_fds"], "samples": r["samples"]}
                   for r in spares.values()],
        "spare_spawns_after_recovery_s": [t - rec["respawned"] for _, t in later],
        "step_s": step_split,
        "job_s": t_end - t_launch,
    }
    facts = {"restored_step": staged, "restored_from": resume["restored_from"], "how": how,
             "redone_steps": redone, "max_loss_diff": max_diff, "gpu_owners": owners,
             "pids": pids, "spares": sorted(spares)}
    return facts, timings


def main(argv=()) -> int:
    import argparse

    argv = list(argv)
    if argv[:1] == ["--tpurun-no-spare"]:
        return _no_spare_entry(argv[1:])

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trainer", choices=("reference", "kill", "resume", "restore", "bench"),
                        help="run one trainer process of the checkpoint phase")
    parser.add_argument("--ckpt", help="checkpoint directory of the trainer")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true", help="2-layer model (tests)")
    parser.add_argument("--job-log-dir", help="write each tpurun run's whole output here")
    args = parser.parse_args(argv)
    if args.trainer:
        return trainer(args)
    return smoke(args.job_log_dir)


def smoke(job_log_dir=None) -> int:
    import torch

    from dlrover_tpu_torch.common.platform import strict_fp32
    from dlrover_tpu_torch.models import gpt
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import train_step

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(f"probe: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    strict_fp32()

    t0 = time.perf_counter()
    fa._lib()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s ({_build.library_path('flash_attention')})")
    binary = binary_report(_build)

    gen = torch.Generator(device="cuda").manual_seed(0)
    log(f"kernels at {MAIN_SHAPE}")
    checks, times = kernel_phase(fa, MAIN_SHAPE, gen, timed=True)
    ragged = {name: [] for name in checks}
    for ragged_shape in RAGGED_SHAPES:
        log(f"kernels at {ragged_shape}")
        for name, rows in kernel_phase(fa, ragged_shape, gen, timed=False)[0].items():
            ragged[name] += rows

    log("main path: GPT-2 small flash train step")
    result = main_path(fa, gpt, train_step)
    log("main path: " + json.dumps(result))
    torch.cuda.empty_cache()  # the trainers of phase 5 are other processes

    log("checkpoint and elastic loop: GPT-2 small through ElasticTrainLoop, SIGKILL, resume")
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        facts, numbers = checkpoint_phase(
            work, f"chip_smoke_{os.getpid()}_{int(time.time())}", n_params=result["n_params"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("checkpoint and elastic loop: " + json.dumps(facts))
    numbers["main_path_step_s"] = result["step_s"]

    tpurun_times = {}
    for run, warm in (("A", True), ("B", False)):
        log(f"tpurun run {run}: the flagship command with the warm spare "
            f"{'on (as typed)' if warm else 'off (ElasticLaunchConfig(warm_spare=False))'}, "
            f"a worker SIGKILL and its recovery under its own agent")
        work = tempfile.mkdtemp(prefix="chip_smoke_tpurun_")
        try:
            tpurun_facts, tpurun_times[run] = tpurun_phase(
                work, f"chip_smoke_tpurun_{run}_{os.getpid()}_{int(time.time())}",
                reference=facts["reference_losses"], card=card, warm_spare=warm,
                job_log=job_log_dir and os.path.join(job_log_dir, f"tpurun_{run}.log"))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        log(f"tpurun run {run}: " + json.dumps(tpurun_facts))
    recoveries = {run: t["recovery"] for run, t in tpurun_times.items()}
    log("tpurun: recovery, warm (A) against cold (B): " + json.dumps(recoveries))

    shape = {k: MAIN_SHAPE[k] for k in ("B", "T", "H", "D", "causal")}
    kernels = []
    for name, (nbytes, flops) in bounds(**shape).items():
        b_ms, b_by = bound_ms(nbytes, flops)
        worst = max(checks[name] + ragged[name], key=lambda c: c[1] / c[2])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": result["launches"][name],
            "max_abs_err": max(c[1] for c in checks[name] + ragged[name]),
            "tol": worst[2], "max_err_over_tol": worst[1] / worst[2],
            "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times[name]["library_ms"],
            "library_call": times[name]["library_call"],
            "shape": shape,
            # the D=64 instance the main path runs; registers at entry (the
            # wgmma kernels' consumers raise theirs with setmaxnreg)
            **{key: binary[(name, shape["D"])][key]
               for key in ("registers", "spill_stores", "hgmma", "utmaldg")},
        })
    print(json.dumps({"checkpoint": numbers}), flush=True)
    print(json.dumps({"tpurun": tpurun_times}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
