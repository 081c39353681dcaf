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
   T=1024, H=12, D=64, causal), at phase 9's (B=16) and at ragged shapes (T=1000; D=128
   non-causal at batch 1, D=64 causal; causal q_len 384 < kv_len 1000;
   causal q_len > kv_len at a ragged kv_len, D=64 and D=128), and times
   kernel, plain version and ``scaled_dot_product_attention`` (the
   yardstick, never called by the port) with CUDA events at the training
   shape and at phase 9's;
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
   GPU (no /dev/nvidia* open in the agent, the master or a spare, from
   its spawn to its hand-off, at most this process's and the worker's
   contexts in ``nvidia-smi``); every spare must be seen ready or be
   stopped by its agent, which logs why; afterwards
   no process (worker, spare, agent, master) and no shm segment of the job
   may be left. The time to recover is split into detection, breakpoint
   persist, respawn (hand-off or interpreter, imports, CUDA init, engine,
   library, model build), shm restore and the first step after the resume
   (forward, backward, optimizer, loss fetch, first stage), and printed
   for both runs side by side with the persists, the skipped stages, the
   staged step's lag at the kill, the agent's peak RSS, the spare's RSS and
   the step time while a spare imports;
7. two nodes on one card: the port's master (``python3 -m
   dlrover_tpu_torch.master.main --num_workers 2 --port_file F``) and two
   agents started as a user starts them on two nodes, ``python3 -m
   dlrover_tpu_torch.launcher.elastic_run --nnodes 2 --node_rank r
   --nproc_per_node 1 -m dlrover_tpu_torch.examples.gpt_elastic``, with one
   ``DLROVER_MASTER_ADDR`` and ``DLROVER_JOB_NAME``, an IPC namespace each
   and warm spares on, 30 steps of GPT-2 small at a global batch of 8 (4 a
   rank); each stage is also pushed to the peer's agent (peer replicas are
   on by default in a world of two). Both workers must report backend gloo (they share the GPU) and a
   world of 2, and only they may hold /dev/nvidia*. Once both have staged
   step 10 or later, this process SIGKILLs rank 1's worker: node 1's agent
   must restart it after the failure and node 0's agent its own worker
   (after its failure in the next collective, or on the membership
   change); both must resume at one agreed step (from memory, or from
   storage when their staged steps differ), every step's loss must be
   bit-equal on both ranks and within 1e-2 of phase 5's uninterrupted world
   of one, every step must launch 24/12/12 flash kernels, both ranks must
   end with equal state hashes, the agents and the master must exit 0 with
   SUCCEEDED, and no process and no shm segment of either namespace may be
   left. It reports the median step against phase 6's world of one, the
   all-reduce's share of a step, both nodes' recovery in phase 6's
   columns, and each process's peak RSS;
8. sharded input on two nodes: phase 7's job, with the workers running
   this script's trainer role (``chip_smoke.py --trainer shards --data
   F``) instead of the example: each writes (once, from seed 0) a token
   file of 512 samples of 1025 uint16 tokens, builds the example's GPT-2
   small and data-parallel step from seed-0 weights, registers the file
   with the master through ``ShardingClient`` (batch 4, shuffled table
   shards of two batches: 64 shards of 8 samples) and trains 30 steps
   through ``ElasticTrainLoop`` (a stage every step, a persist every 5th)
   from an ``ElasticShardLoader`` that reads the rows of the file, logging
   each step's sample indices. Once both have staged step 10 or later,
   this process SIGKILLs rank 1's worker. Beyond phase 7's checks (gloo and
   a world of 2, 24/12/12 launches a step, losses bit-equal across the
   ranks, one agreed resume step, exit 0 with SUCCEEDED, nothing left
   behind): every worker's client carries its node's id, the ranks'
   indices are disjoint at every step and come only from shards the master
   handed that worker, no index is trained in two committed steps, and the
   losses are within 1e-3 of a world of one that this process trains
   afterwards, on the GPU the job has freed, on the committed global
   batches in their order. Once both nodes have resumed it reads the
   master's shard checkpoint and reports the samples the killed workers'
   open and prefetched shards leave out of the run, with the ``get_task``
   RPC's seconds, the training thread's wait for a batch, the median step
   against phase 7's and both nodes' recovery in phase 7's columns;
9. the Llama family: Llama-125M at ``bench.py``'s width (vocab 32000, 12
   layers, 12 heads over 4 KV heads of 64, embed 768, SwiGLU 2048; flash,
   remat) and its MoE variant (4 experts, top-2, every 2nd block) each take
   10 steps at batch 16, seq 1024 on seeded tokens from seed-0 weights
   through ``init_train_state`` / ``build_train_step``, the MoE's
   load-balance term in its loss. Each variant's losses must be finite,
   the first within 0.5 of ln(vocab), each step must launch 24/12/12 flash
   kernels, and flash and dense attention must give the same token losses
   on a 2x256 slice (for the MoE, before each row's first token whose
   experts moved), and each block's attention, flash against dense on the
   block's input from the flash forward, must agree at all 512 tokens
   within the same limits; the MoE's aux terms must be finite and positive and
   every expert's ``w_gate`` must get a gradient; its state after step 8,
   staged to shm through ``CheckpointEngine`` and restored into a model
   built afresh, must be hash-equal and give the uninterrupted run's step-9
   loss. It reports each variant's parameter count, median step, tokens/s
   and peak memory, and the dense model's MFU;
10. the restore chain on two nodes of one card: phase 7's job (the
   example, a world of two over gloo, warm spares on), with peer replicas
   (on by default in a world of several hosts) and the durable tier
   (``DLROVER_DURABLE_DIR``, every 5th step, the newest 2 kept), every
   step staged as in phase 7, 30 steps. (a) Once a durable generation has
   committed, node 0's worker is stopped (SIGSTOP, counted only while its
   shard lock is free, so that no stage is in flight) at a staged step
   >= 10 (by step 24) that is no storage step and newer than storage's
   newest; node 1, which stages the same steps, then stages that step and
   waits in its next collective; node 0's worker stays stopped until
   node 0's agent holds node 1's replica of that step; then node 1's
   agent, worker and spare die by SIGKILL, node 0's worker continues,
   node 1's shm segments are unlinked and a new agent of node rank 1
   starts in a fresh IPC namespace: its worker must restore that step from node 0's memory
   (``peer``, the refill ``refilled``, a log line naming peer 0), node 0
   from its own shm; phase 7's checks hold (one agreed resume step,
   losses bit-equal across the ranks and within 1e-2 of phase 5's world
   of one, 24/12/12 launches a step, exit 0 and SUCCEEDED, nothing left
   behind), and every durable drain must write from the saver's buffer.
   (b) After the job, with at least two durable generations committed,
   every shm segment of the job unlinked and the flash storage deleted,
   the flagship command as a world of one on the same durable root and
   lineage must restore the newest committed generation (every shard's
   crc32 checked) and train on within 1e-2 of phase 5's losses at
   24/12/12 launches a step. It reports each replica push's GB/s and
   shard-lock hold, the fetch seconds, both nodes' recovery, the peak
   ``VmRSS`` of every process and the peak bytes in ``/dev/shm``, each
   durable drain's source, lock hold and write against phase 5's async
   stage block, the generation's bytes and the whole-pool restore's
   seconds.

Phase 6 also times each async stage of its workers from the step to the
image in shm (seen by the 0.1 s sampler that watches the spares), beside
a persist of the agent or alone.

The output ends with the checkpoint numbers, the ``tpurun`` timings, the
two-node numbers, the sharded-input numbers, the Llama numbers, the
restore-chain numbers and the kernel table as one JSON line each, the card's name and power limit, and ``{"ok": true,
"device": {...}}`` as the last line.

    python3 chip_smoke.py --multi-gpu-world

runs only the example as a world of one rank per GPU of a machine with
several (NCCL; ``multi_gpu_world``) for ``MULTI_GPU_STEPS`` steps,
restarts it whole to resume from memory, holds it against a world of one
and prints one JSON line; ``--device cpu --small`` rehearses it on the
CPU as a world of two over gloo.
"""

import contextlib
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
# phase 9's shape: Llama-125M at batch 16, K/V repeated to the 12 query heads
LLAMA_SHAPE = dict(B=16, T=1024, H=12, D=64, causal=True)
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
# flash launches of one GPT-2 small train step (12 layers, remat: the
# forward runs again in the backward)
FLASH_PER_STEP = {"fwd": 24, "bwd_dkdv": 12, "bwd_dq": 12}
# Kernel vs plain version, same bf16 inputs, plain at the kernel's own tiles:
# sums run in another order and p is rounded to bf16 at other points, so a
# bf16 output may differ by one rounding step at its largest magnitude
# (2**-7 relative), and never by more than 2e-2 below magnitude 2.56.
LSE_TOL = 1e-3


def bf16_tol(ref):
    return max(2e-2, 2.0**-7 * float(ref.abs().max()))


def log(msg):
    print(msg, flush=True)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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


def flash_vs_dense(model, tokens, targets):
    """The trained weights of ``model`` (a GPT or a Llama) through the flash
    kernels and through the plain dense attention must give the same
    per-token losses on a 2x256 slice. The model runs in bf16 and the two
    paths round at different points (the dense path rounds the logits and
    probabilities to bf16, the kernels keep them in fp32), so a token's loss
    may move by a few 1e-2: the mean may differ by 2e-2, a token by 0.25.
    In a MoE model such a rounding can also move a token's top-2 experts,
    and then its output and those of the tokens after it differ by far
    more; so the max is taken over the tokens of each row before its first
    token whose top-2 set differs in some MoE block (a token's attention
    sees only the tokens before it; its second choice's place in an
    expert's queue counts the row's first choices, which matters only
    where the row fills the expert), and the moved tokens are counted."""
    import torch

    from dlrover_tpu_torch.models import llama

    dense = type(model)(dataclasses.replace(model.config, attention_impl="dense"),
                        device=model.device)
    dense.load_state_dict(model.state_dict())
    part = min(256, tokens.shape[1])
    small_in, small_tgt = tokens[:2, :part], targets[:2, :part]
    routes = {id(model): [], id(dense): []}

    def top2(key):
        def hook(mlp, args):
            logits = torch.einsum("bsd,de->bse", args[0].float(), mlp.w_router)
            routes[key].append(logits.topk(2, dim=-1).indices.sort(dim=-1).values)
        return hook

    hooks = [b.mlp.register_forward_pre_hook(top2(id(m)))
             for m in (model, dense) for b in m.blocks if isinstance(b.mlp, llama.MoeMlp)]
    try:
        with torch.no_grad():
            flash_tl = model(small_in, targets=small_tgt)
            dense_tl = dense(small_in, targets=small_tgt)
    finally:
        for h in hooks:
            h.remove()
    _check(flash_tl.shape == (2, part) and bool(torch.isfinite(flash_tl).all()),
           f"bad flash token losses {tuple(flash_tl.shape)}")
    moved = torch.zeros((2, part), dtype=torch.bool, device=flash_tl.device)
    for a, b in zip(routes[id(model)], routes[id(dense)]):
        moved |= (a != b).any(-1)
    first = torch.where(moved.any(1), moved.float().argmax(1), part)
    before = torch.arange(part, device=moved.device)[None, :] < first[:, None]
    diff = (flash_tl - dense_tl).abs()
    out = {"mean_diff": float((flash_tl.mean() - dense_tl.mean()).abs()),
           "max_diff": float(diff.max()), "tokens": 2 * part,
           "tokens_moved": int(moved.sum()), "tokens_before_a_move": int(before.sum()),
           "max_diff_before_a_move": float(diff[before].max()) if bool(before.any()) else None}
    log(f"  flash vs dense token losses: {json.dumps(out)}")
    _check(out["mean_diff"] <= 2e-2 and out["tokens_before_a_move"] > 0
           and out["max_diff_before_a_move"] <= 0.25,
           f"flash and dense attention paths disagree: {out}")
    if isinstance(model, llama.Llama):
        out["block_attention"] = block_attention_flash_vs_dense(model, dense, small_in)
    return out


def block_attention_flash_vs_dense(model, dense, tokens):
    """Each block's attention, flash against dense, on that block's input
    as the flash model's forward of ``tokens`` gives it: every token of the
    slice is compared, since no routing lies between a block's input and
    its attention. What is compared is the attention itself, softmax(QK^T)V
    before the output projection: the kernel's output and the plain dense
    path's on the same q, k and v (the two blocks share their weights),
    held to the main path's limits, mean 2e-2 and max 0.25, over every
    element of every block."""
    import torch

    from dlrover_tpu_torch.models import llama

    inputs, outs = [], {"flash": [], "dense": []}
    hooks = [b.register_forward_pre_hook(lambda mod, args: inputs.append(args[0]))
             for b in model.blocks]
    impls = {"flash": llama.flash_attention, "dense": llama.dense_attention}

    def recording(name):
        def attention(*args, **kwargs):
            out = impls[name](*args, **kwargs)
            outs[name].append(out)
            return out
        return attention

    try:
        with torch.no_grad():
            model(tokens)
        for h in hooks:
            h.remove()
        hooks = []
        llama.flash_attention, llama.dense_attention = recording("flash"), recording("dense")
        with torch.no_grad():
            for x, fb, db in zip(inputs, model.blocks, dense.blocks):
                fb.attn(fb.norm_1(x))
                db.attn(db.norm_1(x))
    finally:
        for h in hooks:
            h.remove()
        llama.flash_attention, llama.dense_attention = impls["flash"], impls["dense"]
    diffs = [(f.float() - d.float()).abs() for f, d in zip(outs["flash"], outs["dense"])]
    out = {"blocks": len(diffs), "tokens": int(tokens.numel()),
           "mean_abs_diff": max(float(d.mean()) for d in diffs),
           "max_abs_diff": max(float(d.max()) for d in diffs),
           "max_abs_diff_by_block": [float(d.max()) for d in diffs],
           "max_abs_value": max(float(f.float().abs().max()) for f in outs["flash"])}
    log(f"  flash vs dense attention of each block on its input: {json.dumps(out)}")
    _check(len(diffs) == len(model.blocks) == len(inputs)
           and all(f.shape[:2] == tuple(tokens.shape) for f in outs["flash"])
           and out["mean_abs_diff"] <= 2e-2 and out["max_abs_diff"] <= 0.25,
           f"a block's flash and dense attention disagree: {out}")
    return out


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

    cmp = flash_vs_dense(model, tokens, targets)

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
        "flash_vs_dense": cmp,
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


@contextlib.contextmanager
def _job_ipc(work, job):
    """DLROVER_JOB_NAME ``job`` and the port's sockets under ``work`` for
    the body; the environment and the socket directory are restored
    after it."""
    from dlrover_tpu_torch.common import multi_process

    names = ("DLROVER_JOB_NAME", "DLROVER_IPC_DIR", "DLROVER_IPC_NAMESPACE")
    saved_env = {name: os.environ.get(name) for name in names}
    saved_dir = multi_process.SOCKET_TMP_DIR
    os.environ["DLROVER_JOB_NAME"] = job
    os.environ["DLROVER_IPC_DIR"] = multi_process.SOCKET_TMP_DIR = os.path.join(work, "sockets")
    os.environ.pop("DLROVER_IPC_NAMESPACE", None)
    try:
        yield
    finally:
        for name, value in saved_env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        multi_process.SOCKET_TMP_DIR = saved_dir


def checkpoint_phase(work, job, device="cuda", small=False, n_params=None, timeout=600,
                     run_bench=True):
    """Phase 5. This process runs the saver (the agent's part); trainers run
    as child processes under DLROVER_JOB_NAME ``job`` with storage and
    sockets under ``work``. Raises on the first failed check; returns the
    phase's facts and the checkpoint numbers (None without ``run_bench``).
    The environment and socket directory it sets are restored on return."""
    with _job_ipc(work, job):
        return _checkpoint_phase(work, job, device, small, n_params, timeout, run_bench)


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

    AsyncCheckpointSaver.start_async_saving_ckpt()
    try:
        ref = child("reference", namespace=f"{job}_ref", root=ref_ckpt)
        log(f"  uninterrupted losses {ref['losses']}")
        _check(ref["steps"] == TPURUN_STEPS and ref["restored_step"] == -1, f"reference run {ref}")

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
        _check(meta is not None and meta.step == KILL_AT, f"shm holds {meta and meta.step}")
        _check(tracker == STORAGE_EVERY, f"storage tracker {tracker}")
        _check(lock_free, "the dead trainer's shard lock was not freed")

        resumed = child("resume")
        diffs = [abs(resumed["losses"][str(s)] - ref["losses"][str(s)])
                 for s in range(KILL_AT + 1, LOOP_STEPS)]
        bit_equal = all(resumed["losses"][str(s)] == ref["losses"][str(s)]
                        for s in range(KILL_AT + 1, LOOP_STEPS))
        log(f"  resumed from {resumed['restored_from']} at step {resumed['restored_step']}, "
            f"hash equal {resumed.get('restored_hash') == killed['hash']}; losses "
            f"{resumed['losses']}; max diff vs uninterrupted {max(diffs):.3e}, "
            f"bit-equal {bit_equal}; launches {resumed['launches']}")
        _check(resumed["restored_step"] == KILL_AT, f"resumed at {resumed['restored_step']}")
        _check(resumed["restored_from"] in ("prefetch", "memory"), "not restored from shm")
        _check(resumed.get("restored_hash") == killed["hash"], "restored state differs from the killed one")
        _check(max(diffs) <= RESUME_LOSS_TOL, f"resumed losses differ by {max(diffs)}")
        _check(resumed["tracker"] == HASH_AT, f"storage tracker {resumed['tracker']}")
        n = LOOP_STEPS - KILL_AT - 1
        if device == "cuda":
            per_step = FLASH_PER_STEP
            _check(resumed["launches"] == {k: v * n for k, v in per_step.items()},
                  f"loop launches {resumed['launches']} over {n} steps")
        failures = ref["stage_failures"] + killed["stage_failures"] + resumed["stage_failures"]
        _check(failures == 0, f"{failures} async stages failed")

        shm.unlink()
        restored = child("restore")
        log(f"  after unlinking shm: restored step {restored['step']} from "
            f"{restored['restored_from']}, hash equal {restored['hash'] == resumed['hashes'][str(HASH_AT)]}")
        _check(restored["step"] == HASH_AT and restored["restored_from"] == "storage",
              f"storage rung restored {restored['step']} from {restored['restored_from']}")
        _check(restored["hash"] == resumed["hashes"][str(HASH_AT)], "storage restore differs")

        numbers = child("bench") if run_bench else None
        if numbers is not None:
            _check(numbers["stage_failures"] == 0, "async stages failed in the bench")
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
# this process SIGKILLs the worker, found through the agent's pidfile; it
# checks that condition again on the worker frozen by SIGSTOP, which cannot
# finish another step meanwhile.

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


def _reap_leftovers(pids, groups, namespaces):
    """After a job has ended: (the processes of ``pids`` still alive and
    the live members of the process groups ``groups``, each SIGKILLed; the
    shm segments of the IPC ``namespaces``, each unlinked). A finished job
    leaves neither."""
    import signal

    time.sleep(0.5)  # the agents' last kills are reaped by now
    leaked = [p for p in pids if _proc_alive(p)] + _group_members(set(groups))
    for p in leaked:
        try:
            os.kill(p, signal.SIGKILL)
        except OSError:
            pass
    segments = [n for n in os.listdir("/dev/shm")
                if any(n.startswith(f"dlrover_{ns}_") for ns in namespaces)]
    for name in segments:
        os.unlink(os.path.join("/dev/shm", name))
    return leaked, segments


def _gpu_owners(device, procs):
    """Who holds the GPU while the job runs: the /dev/nvidia* files of
    each process of ``procs`` ({name: pid}), and on the card nvidia-smi's
    compute apps. A worker must hold it, an agent (which runs the saver)
    and the master must not."""
    owners = {name: _nvidia_fds(pid) for name, pid in procs.items()}
    if device == "cuda":
        apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
        owners["nvidia_smi_compute_apps"] = apps
    return owners


def _example_world(work, job, n, total_steps, example_args, timeout, gpu_per_rank=False):
    """Run the example as a world of ``n`` processes with the agent's env
    contract and no agent or master (rank r on GPU r with
    ``gpu_per_rank``); each rank's records. Rank r's job name is
    ``{job}_{r}``: the caller unlinks its shm segments. Each rank writes
    its output to ``{job}_rank{r}.out`` and ``.err`` in ``work``, so no
    rank blocks on a full pipe; the first rank to fail ends the world."""
    from dlrover_tpu_torch.agent.rendezvous import find_free_port

    coordinator = f"127.0.0.1:{find_free_port('127.0.0.1')}"
    procs, paths = [], []
    for r in range(n):
        env = dict(os.environ, DLROVER_JOB_NAME=f"{job}_{r}", CKPT_DIR=os.path.join(work, f"{job}_ckpt"),
                   TOTAL_STEPS=str(total_steps), DLROVER_IPC_DIR=os.path.join(work, f"{job}_sockets{r}"))
        for name in ("DLROVER_MASTER_ADDR", "DLROVER_IPC_NAMESPACE"):
            env.pop(name, None)
        if n > 1:
            env.update(DLROVER_COORDINATOR_ADDRESS=coordinator, DLROVER_NUM_PROCESSES=str(n),
                       DLROVER_PROCESS_ID=str(r))
        if gpu_per_rank:
            env["CUDA_VISIBLE_DEVICES"] = str(r)
        paths.append(tuple(os.path.join(work, f"{job}_rank{r}.{ext}") for ext in ("out", "err")))
        with open(paths[-1][0], "w") as out, open(paths[-1][1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dlrover_tpu_torch.examples.gpt_elastic"] + example_args,
                stdout=out, stderr=err, env=env, cwd=os.path.dirname(os.path.abspath(__file__))))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        killed = [p for p in procs if p.poll() is None]
        for proc in killed:
            proc.kill()
            proc.wait(30)
    failed = [r for r, p in enumerate(procs) if p not in killed and p.returncode != 0]
    if failed or killed:
        r = failed[0] if failed else procs.index(killed[0])
        why = f"exited {procs[r].returncode}" if failed else f"timed out after {timeout} s"
        with open(paths[r][1]) as f:
            raise AssertionError(f"example world {job} (rank {r}) {why}:\n{f.read()[-4000:]}")
    records = []
    for out_path, _ in paths:
        with open(out_path) as f:
            records.append([json.loads(ln[len("gpt_elastic "):]) for ln in f
                            if ln.startswith("gpt_elastic ")])
    return records


def _unlink_job_segments(prefixes):
    for name in os.listdir("/dev/shm"):
        if any(name.startswith(f"dlrover_{p}") for p in prefixes):
            os.unlink(os.path.join("/dev/shm", name))


def _step_losses(records):
    return {x["step"]: x["loss"] for x in records if x["event"] == "step"}


def _uninterrupted_losses(work, job, device, small, total_steps, timeout, n=1):
    """Losses of the example run as a world of ``n`` processes with no
    agent, no master and no fault, to the same step: {step (as a string):
    loss}, which every rank must report bit-equal. The reference when an
    earlier phase's is not at hand."""
    try:
        records = _example_world(work, job, n, total_steps,
                                 ["--device", "cpu", "--small"] if small else [], timeout)
    finally:
        _unlink_job_segments([f"{job}_{r}_" for r in range(n)])
    losses = [_step_losses(recs) for recs in records]
    if any(x != losses[0] for x in losses):
        raise AssertionError("the uninterrupted world's ranks disagree")
    return {str(step): loss for step, loss in losses[0].items()}


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
    holds while it is still a spare (the agent's ``spare_pidfile`` names it
    before and after the sample: from its spawn to its hand-off or its end)
    and its memory then. With ``job``, a callable that names the job's
    processes ({name: pid}), also each name's peak ``VmRSS`` and ``VmHWM``
    and the peak of their ``VmRSS`` sum. With ``shm``, a view of a shm
    image (closed by :meth:`stop`), also the wall-clock time each staged
    step was first seen there (``landed``). With ``shm_prefixes``, also the
    peak of the bytes that the segments of ``/dev/shm`` whose names start
    with one of them hold (``shm_peak_bytes``)."""

    def __init__(self, agent_pid, spare_pidfile, job=None, shm=None, shm_prefixes=None):
        import threading

        self.agent_pid = agent_pid
        self.spare_pidfile = spare_pidfile
        self.job = job
        self.shm = shm
        self.landed = {}
        self.lock = threading.Lock()
        self.spares = {}
        self.agent_mem = []  # (wall-clock, {field: kB})
        self.job_peak_kb = {}  # name: {"VmRSS": kB, "VmHWM": kB}
        self.job_total_peak_kb = 0
        self.shm_prefixes = shm_prefixes
        self.shm_peak_bytes = 0
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

    def _is_spare(self, pid):
        try:
            with open(self.spare_pidfile) as f:
                return int(f.read().split()[0]) == pid
        except (OSError, ValueError, IndexError):
            return False

    def _sample(self):
        now = time.time()
        mem = self._mem_kb(self.agent_pid)
        if mem:
            with self.lock:
                self.agent_mem.append((now, mem))
        if self.job is not None:
            total = 0
            for name, pid in self.job().items():
                mem = self._mem_kb(pid)
                total += mem.get("VmRSS", 0)
                with self.lock:
                    peak = self.job_peak_kb.setdefault(name, {})
                    for key in ("VmRSS", "VmHWM"):
                        if key in mem:
                            peak[key] = max(peak.get(key, 0), mem[key])
            self.job_total_peak_kb = max(self.job_total_peak_kb, total)
        for pid, cmd in _proc_children(self.agent_pid):
            if "dlrover_tpu_torch.agent.warm_worker" not in cmd:
                continue
            with self.lock:
                rec = self.spares.setdefault(pid, {"pid": pid, "seen": now, "ready": None,
                                                   "ready_file": None, "nvidia_fds": [],
                                                   "samples": 0, "mem_kb": {}})
            if rec["ready_file"] is None:
                rec["ready_file"] = self._ready_file(pid)
            if not self._is_spare(pid):
                continue
            try:
                ready = os.stat(rec["ready_file"]).st_mtime if rec["ready_file"] else None
            except OSError:
                ready = None
            fds = _nvidia_fds(pid)
            mem = self._mem_kb(pid)
            if self._is_spare(pid):  # still a spare after the sample
                with self.lock:
                    rec["ready"] = rec["ready"] or ready
                    rec["nvidia_fds"] = sorted(set(rec["nvidia_fds"]) | set(fds))
                    rec["samples"] += 1
                    for key, kb in mem.items():
                        rec["mem_kb"][key] = max(rec["mem_kb"].get(key, 0), kb)
        meta = self.shm.read_meta() if self.shm is not None else None
        if meta is not None:
            self.landed.setdefault(meta.step, now)
        if self.shm_prefixes:
            held = 0
            for name in os.listdir("/dev/shm"):
                if name.startswith(tuple(self.shm_prefixes)):
                    try:
                        held += os.stat(os.path.join("/dev/shm", name)).st_blocks * 512
                    except OSError:
                        continue
            self.shm_peak_bytes = max(self.shm_peak_bytes, held)

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
        if self.shm is not None:
            self.shm.close()


def _spares_stopped(out):
    """{pid: reason} of the warm spares the agent killed, from its log."""
    return {int(m.group(1)): m.group(2) for m in out.grep(r"killed warm spare pid=(\d+): (.*)")}


def _log_time(line):
    """Wall-clock seconds of a log line's ``[YYYY-mm-dd HH:MM:SS,mmm]``
    stamp (the port's log format, local time), or None."""
    m = re.search(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3})\]", line)
    if not m:
        return None
    return time.mktime(time.strptime(m.group(1), "%Y-%m-%d %H:%M:%S")) + int(m.group(2)) / 1e3


def _stage_timings(landed, steps, lines, until=None):
    """How long each async stage of one worker took to land in shm, beside
    the agent's persists: for each step of ``steps`` ({step: step record})
    whose stage was seen in ``landed`` ({step: wall-clock}) before
    ``until`` (the worker's end), the time from the step's record (written
    after the loop queued the stage; the image may land first) to the
    image, and whether the agent was copying out of shm or writing a
    persist then (from the ``persisted step`` lines of the agent's log
    ``lines``). The summaries leave out
    the worker's first two stages, which allocate and fault in the pinned
    buffer."""
    persists = []
    for ln in lines:
        m = re.search(r"persisted step (\d+): shard lock held ([\d.]+) s \(snapshot\), "
                      r"write ([\d.]+) s", ln)
        end = m and _log_time(ln)
        if end:
            persists.append((end - float(m.group(3)) - float(m.group(2)), end))
    rows = []
    for s, rec in sorted(steps.items()):
        if s in landed and rec["t"] - 1.0 <= landed[s] <= (until or math.inf):
            start, end = rec["t"], landed[s]
            busy = any(a < end and b > start for a, b in persists)
            rows.append({"step": s, "lag_s": end - start, "beside_persist": busy})

    def summary(beside):
        lags = [x["lag_s"] for x in rows[2:] if x["beside_persist"] == beside]
        return {"n": len(lags), "median": _median(lags), "max": max(lags) if lags else None}

    return {"beside_persist": summary(True), "alone": summary(False),
            "not_landed": [s for s in sorted(steps) if s not in {x["step"] for x in rows}],
            "persist_windows_s": [b - a for a, b in persists], "rows": rows}


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


def _shm_view(namespace, host_rank, name=""):
    """This process's view of ``host_rank``'s shm image in the IPC
    ``namespace``, or of the segment ``name`` there (the handler takes its
    segment's name from the environment, which is restored)."""
    from dlrover_tpu_torch.checkpoint.shm_handler import SharedMemoryHandler

    saved = os.environ.get("DLROVER_IPC_NAMESPACE")
    os.environ["DLROVER_IPC_NAMESPACE"] = namespace
    try:
        return SharedMemoryHandler(host_rank, name=name)
    finally:
        if saved is None:
            os.environ.pop("DLROVER_IPC_NAMESPACE", None)
        else:
            os.environ["DLROVER_IPC_NAMESPACE"] = saved


def _lock_client(namespace, sockets, host_rank):
    """A socket client of ``host_rank``'s shard lock in the IPC
    ``namespace`` whose sockets are in ``sockets`` (its path is fixed when
    it is made; the environment and the module's directory are restored)."""
    from dlrover_tpu_torch.checkpoint.saver import lock_name
    from dlrover_tpu_torch.common import multi_process

    saved = os.environ.get("DLROVER_IPC_NAMESPACE"), multi_process.SOCKET_TMP_DIR
    os.environ["DLROVER_IPC_NAMESPACE"] = namespace
    multi_process.SOCKET_TMP_DIR = sockets
    try:
        return multi_process.LocalSocketClient("lock_" + lock_name(host_rank))
    finally:
        if saved[0] is None:
            os.environ.pop("DLROVER_IPC_NAMESPACE", None)
        else:
            os.environ["DLROVER_IPC_NAMESPACE"] = saved[0]
        multi_process.SOCKET_TMP_DIR = saved[1]


def _wait_stopped(pid, timeout=2.0):
    """Until ``pid`` is stopped (state T), at most ``timeout``: a SIGSTOP
    is delivered after ``kill`` returns."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] in ("T", "t"):
                    return
        except (OSError, IndexError):
            return
        time.sleep(0.005)


def _job_tail(outs, n):
    """The last ``n`` lines of each ``(name, _JobOutput)`` of ``outs``,
    the per-step skip warnings left out, each after its name."""
    tail = []
    for name, out in outs:
        lines = [ln for ln in out.lines if "skip save_to_memory" not in ln][-n:]
        tail += [f"[{name}] {ln}" if name else ln for ln in lines]
    return "\n".join(tail)


def _wait_for(what, cond, procs, deadline, dump, poll=0.05):
    """``cond()``'s first true value, polled every ``poll`` s; raises with
    ``dump()`` once one of ``procs`` has exited or the monotonic
    ``deadline`` has passed."""
    while True:
        got = cond()
        if got:
            return got
        dead = [p for p in procs if p.poll() is not None]
        if dead or time.monotonic() > deadline:
            why = "timed out" if not dead else f"pid {dead[0].pid} exited {dead[0].returncode}"
            raise AssertionError(f"{why} while waiting for {what}:\n{dump()}")
        time.sleep(poll)


def _boot_split(b):
    """A worker's start from its ``boot`` record: the imports, the CUDA
    context, the world, the checkpoint engine, the kernel library and the
    model."""
    return {"import_s": b["t_imported"] - b["t_start"], "cuda_init_s": b["t_cuda"] - b["t_imported"],
            "world_s": b["t_world"] - b["t_cuda"], "engine_s": b["t_engine"] - b["t_world"],
            "lib_load_s": b["t_lib"] - b["t_engine"], "model_build_s": b["t_model"] - b["t_lib"]}


def _first_step_split(out, pid):
    """The parts of worker ``pid``'s first step (its ``first_step``
    record), or None."""
    return next(({k: v for k, v in r.items() if k.endswith("_s") or k == "staged"}
                 for r in out.events("first_step", pid)), None)


def _recovery_split(rec, out, boot, t_kill):
    """The recovery from a kill at ``t_kill`` to the first step of the
    restarted worker ``boot``, split by phase, from its agent's ``agent
    recovery:`` record ``rec`` and the worker's records in ``out``."""
    (resume,) = out.events("resume", boot["pid"])
    first = out.events("step", boot["pid"])[0]
    restore_end = resume["t_loop"] + resume["restore_s"]
    return {
        "how": rec["how"],
        "detect_s": rec["detected"] - t_kill,
        "breakpoint_persist_s": rec["persisted"] - rec["detected"],
        "respawn_s": resume["t_loop"] - rec["persisted"],
        "restore_s": resume["restore_s"],
        "first_step_s": first["t"] - restore_end,
        "total_s": first["t"] - t_kill,
        "respawn_split": {"agent_s": rec["respawned"] - rec["persisted"],
                          "rendezvous_s": rec["rdzv_s"],
                          # warm: the hand-off (contract line to the script);
                          # cold: a fresh interpreter up to the script
                          "start_s": boot["t_start"] - rec["respawned"],
                          **_boot_split(boot)},
        "first_step_split": _first_step_split(out, boot["pid"]),
    }


def _gb(kb):
    """{field: kB} in GiB."""
    return {key: v / 2**20 for key, v in kb.items()}


def _step_seconds(steps):
    """Each step's seconds from consecutive ``step`` records, the first
    two left out (the example splits them with device synchronisations)."""
    ts = [x["t"] for x in steps]
    return [b - a for a, b in zip(ts[1:], ts[2:])]


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
    from dlrover_tpu_torch.agent.worker import read_pidfile, spare_pidfile

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
    shm = _shm_view(job, 0)
    t_launch = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    out = _JobOutput(proc)
    watch = _Watch(proc.pid, spare_pidfile(job), shm=_shm_view(job, 0))
    deadline = time.monotonic() + timeout
    pids = {"agent": proc.pid}
    owners = []
    at_kill = {}

    def dump():
        meta = shm.read_meta()
        return f"(shm holds step {meta and meta.step})\n" + _job_tail([("", out)], 60)

    def wait_for(what, cond, poll=0.01):
        return _wait_for(what, cond, [proc], deadline, dump, poll)

    try:
        pids["master"] = wait_for("the standalone master", lambda: next(
            (p for p, c in _proc_children(proc.pid) if "dlrover_tpu_torch.master.main" in c), None),
            poll=0.05)
        boot0 = wait_for("the first worker's boot", lambda: out.events("boot"))[0]
        recorded = read_pidfile(job)
        _check(recorded is not None and recorded[0] == boot0["pid"],
              f"pidfile {recorded} does not name the worker {boot0['pid']}")
        pids["worker0"] = boot0["pid"]
        wait_for("the first step", lambda: out.events("step", boot0["pid"]), poll=0.05)
        owners.append(_gpu_owners(device, {"agent": proc.pid, "master": pids["master"],
                                            "worker": boot0["pid"]}))

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

        worker_pid = read_pidfile(job)[0]
        _check(worker_pid == boot0["pid"], f"pidfile names {worker_pid}, not {boot0['pid']}")
        while True:
            wait_for(f"a staged step >= {TPURUN_KILL_AFTER}", staged_and_computing_next)
            # Freeze the worker and look again: a step that finished between
            # the look and the kill (a step takes 0.06-0.1 s) would be redone.
            os.kill(worker_pid, signal.SIGSTOP)
            time.sleep(0.05)  # the records it printed reach this process
            frozen = staged_and_computing_next()
            if frozen is not None:
                meta, last = frozen
                break
            os.kill(worker_pid, signal.SIGCONT)
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
        owners.append(_gpu_owners(device, {"agent": proc.pid, "master": pids["master"],
                                            "worker": boot1["pid"]}))
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
    leaked, segments = _reap_leftovers(
        list(pids.values()) + spare_pids,
        {pids[n] for n in ("worker0", "worker1") if n in pids} | set(spare_pids), [job])
    log("  job output (last lines):\n    " + "\n    ".join(out.lines[-12:]))
    if job_log:
        with open(job_log, "w") as f:
            f.write("\n".join(out.lines) + "\n")

    _check(rc == 0, f"tpurun exited {rc}")
    _check(out.grep(r"job master exiting: succeeded"), "the master did not exit with SUCCEEDED")
    master_rc = out.grep(r"standalone master pid=\d+ exited rc=(-?\d+)")
    _check(master_rc and master_rc[-1].group(1) == "0", "the standalone master did not exit 0")
    boots = out.events("boot")
    _check(len(boots) == 2 and len(out.recoveries) == 1,
          f"{len(boots)} worker boots and {len(out.recoveries)} recoveries, expected 2 and 1")
    rec = out.recoveries[0]
    _check(rec["pid"] == worker_pid and rec["signal"] == signal.SIGKILL,
          f"the agent saw {rec}, not the SIGKILL of {worker_pid}")
    _check([b["restart_count"] for b in boots] == [0, 1],
          f"RESTART_COUNT seen {[b['restart_count'] for b in boots]}")
    staged = rec.get("persisted_step", -1)
    _check(TPURUN_KILL_AFTER <= staged <= TPURUN_KILL_BY,
          f"breakpoint save persisted step {staged}: a stage at or after step "
          f"{TPURUN_KILL_AFTER} should land by step {TPURUN_KILL_BY}")
    _check(boot1["tracker"] == staged,
          f"storage held step {boot1['tracker']} at the restart, not the staged {staged}")
    (resume,) = out.events("resume", boot1["pid"])
    _check(resume["restored_step"] == staged and resume["restored_from"] in ("prefetch", "memory"),
          f"restored step {resume['restored_step']} from {resume['restored_from']}, "
          f"expected {staged} from shm")
    steps0 = {r["step"]: r for r in out.events("step", boot0["pid"])}
    steps1 = {r["step"]: r for r in out.events("step", boot1["pid"])}
    redone = sorted(set(steps0) & set(steps1))
    _check(sorted(steps0)[: staged + 1] == list(range(staged + 1)) and max(steps0) <= staged + 1,
          f"first worker's steps {sorted(steps0)}")
    _check(sorted(steps1) == list(range(staged + 1, total_steps)),
          f"restarted worker's steps {sorted(steps1)}")
    _check(set(redone) <= {staged + 1}, f"steps {redone} were redone")
    diffs = {}
    for s, r in list(steps0.items()) + list(steps1.items()):
        _check(math.isfinite(r["loss"]), f"non-finite loss at step {s}")
        diffs[s] = max(diffs.get(s, 0.0), abs(r["loss"] - reference[str(s)]))
    max_diff = max(diffs.values())
    _check(max_diff <= TPURUN_LOSS_TOL, f"losses differ from the uninterrupted run by {max_diff}")
    if device == "cuda":
        per_step = FLASH_PER_STEP
        bad = [(s, r["launches"]) for s, r in list(steps0.items()) + list(steps1.items())
               if r["launches"] != per_step]
        _check(not bad, f"steps with other flash launches than {per_step}: {bad[:3]}")
        _check(boot1["lib_cached"] is True, "the restarted worker built the kernel library again")
    for seen in owners:
        _check(not seen["agent"] and not seen["master"],
              f"the agent or the master holds the GPU: {seen}")
        _check(device != "cuda" or seen["worker"], f"the worker holds no GPU device: {seen}")
        _check(len(seen.get("nvidia_smi_compute_apps", [])) <= 2,
              f"more CUDA contexts than this process and the worker: {seen}")
    _check(not leaked, f"processes of the job still alive: {leaked}")
    _check(not segments, f"shm segments of the job left behind: {segments}")

    # the warm spare: adopted in run A, absent in run B
    how = rec.get("how")
    spawns = [(int(m.group(1)), float(m.group(2)))
              for m in out.grep(r"spawned warm spare pid=(\d+) at ([\d.]+)")]
    spares = {pid: dict(r) for pid, r in watch.spares.items()}
    stopped = _spares_stopped(out)
    for r in spares.values():
        r["ready_s"] = r["ready"] - r["seen"] if r["ready"] else None
        r["stopped"] = stopped.get(r["pid"])
    unready = {p: r["samples"] for p, r in spares.items() if not r["ready"] and not r["stopped"]}
    _check(not unready, f"spares neither seen ready nor stopped by the agent (samples): {unready}")
    later = [(p, t) for p, t in spawns if t > rec["respawned"]]
    job_end = max(r["t"] for r in steps1.values())
    if warm_spare:
        _check(how == "warm", f"the recovery was {how}, not warm")
        _check(at_kill["spares"], "no ready warm spare before the kill")
        _check(boot1["adopted"] and boot1["pid"] in [r["pid"] for r in at_kill["spares"]],
              f"the restarted worker {boot1['pid']} is not the spare of the kill "
              f"{[r['pid'] for r in at_kill['spares']]}")
        _check(spares.get(boot1["pid"], {}).get("ready"),
              "the adopted spare was never sampled ready before its promotion")
        held = {p: r["nvidia_fds"] for p, r in spares.items() if r["nvidia_fds"]}
        _check(not held, f"a spare held /dev/nvidia* before its promotion: {held}")
        # the next spare, SPARE_SPAWN_DELAY_S after the worker start; the agent
        # spawns none once the job has ended
        delay = ElasticTrainingAgent.SPARE_SPAWN_DELAY_S
        if job_end - rec["respawned"] > delay + 1.0:
            _check(later and abs(later[0][1] - rec["respawned"] - delay) < 2.0,
                  f"no spare spawned {delay} s after the worker start {rec['respawned']}: "
                  f"{spawns}")
    else:
        _check(how == "cold", f"the recovery was {how}, not cold")
        _check(not spawns and not spares, f"warm spares with warm_spare=False: {spawns}")
        _check(not boot1["adopted"], "the restarted worker was an adopted spare")

    up = out.grep(r"standalone master at \S+ up in ([\d.]+) s")
    rdzv = out.grep(r"world ready: round=0 .*\(rendezvous ([\d.]+) s\)")
    spawn0 = out.grep(rf"started worker pid={boot0['pid']} restart=0 \((\w+)\) .* at ([\d.]+)")
    first0 = steps0[0]
    (resume0,) = out.events("resume", boot0["pid"])
    recovery = _recovery_split(rec, out, boot1, t_kill)
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
            **_boot_split(boot0),
            "first_step_s": first0["t"] - (resume0["t_loop"] + resume0["restore_s"]),
            "first_step_split": _first_step_split(out, boot0["pid"]),
            "launch_to_first_step_s": first0["t"] - t_launch,
        },
        "recovery": recovery,
        "persists": persists,
        "skipped_stages": skipped,
        "storage_wait_s": {"worker0": last0.get("storage_wait_s"),
                           "worker1": last1.get("storage_wait_s")},
        "agent_mem_gb_before_first_persist": _gb(agent_before),
        "agent_mem_gb_peak": _gb(agent_peak),
        "spares": [{"pid": r["pid"], "ready_s": r["ready_s"], "mem_gb": _gb(r["mem_kb"]),
                    "nvidia_fds": r["nvidia_fds"], "samples": r["samples"],
                    "stopped": r["stopped"]}
                   for r in spares.values()],
        "spare_spawns_after_recovery_s": [t - rec["respawned"] for _, t in later],
        "step_s": step_split,
        # each async stage's time to land in shm, beside a persist or alone
        "stages": {name: _stage_timings(watch.landed, steps, out.lines, until)
                   for name, steps, until in (("worker0", steps0, t_kill),
                                              ("worker1", steps1, None))},
        "job_s": t_end - t_launch,
    }
    facts = {"restored_step": staged, "restored_from": resume["restored_from"], "how": how,
             "redone_steps": redone, "max_loss_diff": max_diff, "gpu_owners": owners,
             "pids": pids, "spares": sorted(spares)}
    return facts, timings


# -- phase 7: two nodes on one card -------------------------------------------
#
# The port's master (``master.main --num_workers 2``) and two agents started
# as a user starts them on two nodes, ``elastic_run --nnodes 2 --node_rank r``,
# each with its own IPC namespace; both workers share the one GPU, so their
# world forms over gloo. Once both have staged step TWO_NODE_KILL_AFTER or a
# later one, this process SIGKILLs rank 1's worker.

TWO_NODE_KILL_AFTER = 10
TWO_NODE = ["-m", "dlrover_tpu_torch.launcher.elastic_run", "--nnodes", "2", "--node_rank", None,
            "--nproc_per_node", "1"]
EXAMPLE = ["-m", "dlrover_tpu_torch.examples.gpt_elastic"]


def _two_node_job(work, job, entry, device, small, total_steps, kill_after, timeout, job_log,
                  after_resume=None, replace_node=False, env=None, kill_gate=None, kill_by=None):
    """The master and two agents running ``entry`` (a trainer that prints
    the example's records) as two nodes, a SIGKILL of rank 1's worker once
    both nodes staged step ``kill_after`` (stopped first by SIGSTOP, and
    killed only once it has printed the record of every step it staged),
    the recovery of both and the end of the job. ``after_resume(addr)``, when given, runs once both
    restarted workers have taken a step; its value is returned. ``env``
    adds to every process's environment.

    With ``replace_node`` the kill takes node 1 whole (phase 10): once both
    nodes have staged one step S >= ``kill_after`` that is no storage step
    and newer than the newest committed one, node 0's worker is stopped
    (SIGSTOP; node 1's then waits in its next all-reduce) until node 0's
    agent holds node 1's replica of S; then node 1's agent, worker and
    spare die by SIGKILL, node 0's worker continues, node 1's shm segments are
    unlinked and a new agent of node rank 1 starts in a fresh IPC namespace,
    whose worker must restore S from node 0's memory (``peer``, the refill
    ``refilled``). ``kill_gate()``, when given, must also be true for a
    step to be S, and node 1 must not have trained past ``kill_by`` without
    one.

    Raises on the first failed check of what phases 7, 8 and 10 share: exit
    codes and SUCCEEDED, gloo and a world of 2, one restart a node (one new
    node), one agreed resume step from one rung, 24/12/12 flash launches a
    step on the card, losses finite and bit-equal across the ranks, the
    steps each worker ran, equal final state hashes, only workers on the
    GPU, nothing left behind. Returns the job's records and facts."""
    import signal

    from dlrover_tpu_torch.agent.worker import read_pidfile, spare_pidfile
    from dlrover_tpu_torch.checkpoint.storage import PosixCheckpointStorage

    namespaces = [f"{job}_n{r}" for r in (0, 1)]
    ckpt_dir = os.path.join(work, "ckpt")
    sockets = os.path.join(work, "sockets")
    base = dict(os.environ, DLROVER_JOB_NAME=job, CKPT_DIR=ckpt_dir,
                TOTAL_STEPS=str(total_steps), DLROVER_IPC_DIR=sockets)
    for name in ("DLROVER_MASTER_ADDR", "DLROVER_IPC_NAMESPACE", "DLROVER_NODE_ID",
                 "DLROVER_NODE_RANK"):
        base.pop(name, None)
    base.update(env or {})
    extra = ["--device", "cpu", "--small"] if small else []
    cwd = os.path.dirname(os.path.abspath(__file__))
    shms = [_shm_view(ns, r) for r, ns in enumerate(namespaces)]
    # node 0's agent holds node 1's replica in a segment of its own
    replica = _shm_view(namespaces[0], 1, name="ckpt_replica_1") if replace_node else None
    # a client of node 0's shard lock, to see whether a stage holds it
    lock0 = _lock_client(namespaces[0], sockets, 0) if replace_node else None
    port_file = os.path.join(work, "master.port")
    deadline = time.monotonic() + timeout
    t_launch = time.time()
    master = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.master.main", "--num_workers", "2",
         "--port_file", port_file, "--job_name", job],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=base,
        start_new_session=True, cwd=cwd)
    mout = _JobOutput(master)
    # the agents, their outputs and watches: node 0, node 1 and, with
    # replace_node, the new node 1 (index 2)
    agents, outs, watches = [], [], []
    pids = {"master": master.pid}
    owners, at_kill = [], {}
    killed = after = frozen = None
    killed_spares = set()
    node_out = [0, 1]  # index of each node's live agent in agents/outs

    def workers():
        found = {}
        for r, i in enumerate(node_out):
            rec = read_pidfile(namespaces[i])
            if rec is not None:
                found[f"worker_n{r}"] = rec[0]
        return found

    def job_pids():
        """{role: pid} of the job's processes now; a spare adopted as a
        worker counts as the worker from then on."""
        found = {f"agent_n{i}": a.pid for i, a in enumerate(agents)}
        found.update(master=master.pid, **workers())
        taken = set(found.values())
        found.update({f"spare_{p}": p for w in watches for p in list(w.spares) if p not in taken})
        return found

    def dump():
        return _job_tail([("master", mout)] + [(f"agent {i}", o) for i, o in enumerate(outs)], 25)

    def wait_for(what, cond, poll=0.05):
        live = [a for i, a in enumerate(agents) if i in node_out]
        return _wait_for(what, cond, [master] + live, deadline, dump, poll)

    def gpu_owners(boots_now):
        return _gpu_owners(device, {**{f"agent_n{i}": a.pid for i, a in enumerate(agents)},
                                    "master": master.pid,
                                    **{f"worker_n{r}": boots_now[r]["pid"] for r in (0, 1)}})

    def boots(i, restart=None):
        return [b for b in outs[i].events("boot") if restart in (None, b["restart_count"])]

    def steps_of(i, pid):
        return outs[i].events("step", pid)

    def start_agent(r, ns):
        cmd = [sys.executable] + [str(r) if a is None else a for a in TWO_NODE] + entry + extra
        agents.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(base, DLROVER_MASTER_ADDR=addr, DLROVER_IPC_NAMESPACE=ns),
            start_new_session=True, cwd=cwd))
        outs.append(_JobOutput(agents[-1]))
        # node 0's watch also samples the memory of the job's processes and
        # the bytes of its shm segments
        watches.append(_Watch(agents[-1].pid, spare_pidfile(ns), job=None if watches else job_pids,
                              shm_prefixes=None if watches else [f"dlrover_{job}_"]))
        pids[f"agent_n{len(agents) - 1}"] = agents[-1].pid

    try:
        wait_for("the master's port", lambda: os.path.exists(port_file))
        with open(port_file) as f:
            addr = f"127.0.0.1:{int(f.read())}"
        for r, ns in enumerate(namespaces):
            start_agent(r, ns)
        first = [wait_for(f"node {r}'s first worker", lambda r=r: boots(r, 0))[0] for r in (0, 1)]
        for r in (0, 1):
            wait_for(f"node {r}'s first step", lambda r=r: steps_of(r, first[r]["pid"]))
        owners.append(gpu_owners(first))
        storage = PosixCheckpointStorage(ckpt_dir)

        def both_staged():
            steps = steps_of(1, first[1]["pid"])
            last = steps[-1]["step"] if steps else -1
            if last < kill_after:
                return None
            metas = [shm.read_meta() for shm in shms]
            if any(m is None for m in metas):
                return None
            if replace_node:
                _check(kill_by is None or last <= kill_by,
                       f"no step met the kill's condition by step {kill_by}:\n{dump()}")
                if kill_gate is not None and not kill_gate():
                    return None
                tracker = storage.latest_step()
                tracker = -1 if tracker is None else tracker
                # a memory-only stage: storage never gets this step
                if (metas[0].step == metas[1].step >= kill_after and metas[0].step > tracker
                        and metas[0].step % STORAGE_EVERY):
                    return [m.step for m in metas], last, metas[0].step, tracker
                return None
            if all(m.step >= max(kill_after, last - 1) for m in metas):
                return [m.step for m in metas], last, None, None
            return None

        what = f"both nodes staging a step >= {kill_after}"
        while True:
            staged, last, held, tracker = wait_for(
                what + (" newer than storage's" if replace_node else ""), both_staged, 0.01)
            if not replace_node:
                # node 1's worker stops before its kill; it stages a step
                # before it prints the step's record, so a stop between the
                # two would hide a staged step from the checks below: then
                # it runs on to the next candidate
                frozen = read_pidfile(namespaces[1])[0]
                os.kill(frozen, signal.SIGSTOP)
                time.sleep(0.2)  # what it printed reaches this process
                meta = shms[1].read_meta()
                if meta is not None and meta.step <= steps_of(1, first[1]["pid"])[-1]["step"]:
                    break
                os.kill(frozen, signal.SIGCONT)
                frozen = None
                continue
            # node 0's worker stops (and node 1's with it, in its next
            # collective) until node 1's push of the step has landed in node
            # 0's agent. The stop counts only while node 0's shard lock is
            # free: then no stage of node 0 is in flight, its image is the
            # step S held, and node 1, which stages the steps node 0 stages
            # (the stage gate is a collective), stages S and nothing after
            # it. Else, or when S is a storage step or not newer than
            # storage's, it runs on to the next candidate.
            frozen = read_pidfile(namespaces[0])[0]
            os.kill(frozen, signal.SIGSTOP)
            _wait_stopped(frozen)
            tracker = storage.latest_step()
            tracker = -1 if tracker is None else tracker
            meta = None if lock0.call("locked") else shms[0].read_meta()
            if meta is not None and meta.step >= kill_after and meta.step > tracker \
                    and meta.step % STORAGE_EVERY:
                held = meta.step

                def node1_step():
                    m = shms[1].read_meta()
                    return m.step if m is not None and m.step >= held else None

                step1 = wait_for(f"node 1 staging step {held}", node1_step)
                _check(step1 == held, f"node 1 staged step {step1} past node 0's {held}")
                staged = [held, held]
                break
            os.kill(frozen, signal.SIGCONT)
            frozen = None
        replica_wait_s = None
        if replace_node:
            t_frozen = time.time()

            def replica_step():
                # the replica in node 0's segment, and node 1's agent's log
                # line of the push (written once the PUT has returned)
                meta = replica.read_meta()
                return (meta is not None and meta.step == held
                        and outs[1].grep(rf"replica push of step {held}: \d+ bytes .* ok=True"))

            wait_for(f"node 0 holding node 1's replica of step {held}", replica_step)
            replica_wait_s = time.time() - t_frozen
        killed = read_pidfile(namespaces[1])[0]
        _check(killed == first[1]["pid"], f"node 1's pidfile names {killed}, not {first[1]['pid']}")
        at_kill = {"staged": staged, "trained_rank1": last,
                   "shm_gb": sum(os.stat(os.path.join("/dev/shm", n)).st_size
                                 for n in os.listdir("/dev/shm")
                                 if any(n.startswith(f"dlrover_{ns}_") for ns in namespaces)) / 2**30,
                   "trained_rank0": (steps_of(0, first[0]["pid"]) or [{"step": -1}])[-1]["step"],
                   "ready_spares": [[s["pid"] for s in w.ready_spares()] for w in watches]}
        if replace_node:
            victims = [agents[1].pid, killed]
            try:
                with open(spare_pidfile(namespaces[1])) as f:
                    victims.append(int(f.read().split()[0]))
            except (OSError, ValueError, IndexError):
                pass  # no spare at the moment
            victims += [p for p in watches[1].spares if _proc_alive(p) and p not in victims]
            t_kill = time.time()
            for pid in victims:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            killed_spares = set(victims[2:])
            agents[1].wait(30)
            watches[1].stop()
            os.kill(frozen, signal.SIGCONT)
            frozen = None
            at_kill.update(replica_step=held, storage_step=tracker, killed=victims,
                           replica_wait_s=replica_wait_s)
            shms[1].close()
            _unlink_job_segments([f"{namespaces[1]}_"])
            namespaces.append(f"{job}_n1r")
            t_new_agent = time.time()
            start_agent(1, namespaces[2])
            node_out[1] = 2
            log(f"  SIGKILLed node 1 (agent, worker, spare: {victims}) with steps {staged} staged "
                f"and node 1's step {held} held by node 0; a new agent for node rank 1 in "
                f"{namespaces[2]}: {at_kill}")
            second = [wait_for("node 0's restarted worker", lambda: boots(0, 1))[0],
                      wait_for("the new node 1's worker", lambda: boots(2, 0))[0]]
        else:
            t_kill = time.time()
            os.kill(killed, signal.SIGKILL)
            frozen = None
            log(f"  SIGKILLed rank 1's worker pid {killed} with steps {staged} staged: {at_kill}")
            second = [wait_for(f"node {r}'s restarted worker", lambda r=r: boots(r, 1))[0]
                      for r in (0, 1)]
        for r in (0, 1):
            wait_for(f"node {r}'s first step after the resume",
                     lambda r=r: steps_of(node_out[r], second[r]["pid"]))
        owners.append(gpu_owners(second))
        if after_resume is not None:
            after = after_resume(addr)
        rcs = [a.wait(max(1.0, deadline - time.monotonic())) for a in agents]
        master_rc = master.wait(max(1.0, deadline - time.monotonic()))
    finally:
        t_end = time.time()
        if frozen is not None:
            try:
                os.kill(frozen, signal.SIGCONT)
            except ProcessLookupError:
                pass
        for p in agents + [master]:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(30)
        for w in watches:
            w.stop()
        spare_pids = [p for w in watches for p in w.spares]
        seen = [b["pid"] for o in outs for b in o.events("boot")]
        for pid in seen + spare_pids:
            if _proc_alive(pid):
                try:
                    os.killpg(os.getpgid(pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        for o in outs + [mout]:
            o.join()
        for shm in shms + ([replica] if replica is not None else []):
            shm.close()
        if lock0 is not None:
            lock0.close()
        if job_log:  # a failed job's output too
            with open(job_log, "w") as f:
                for name, o in [("master", mout)] + [(f"agent {i}", o) for i, o in enumerate(outs)]:
                    f.write("".join(f"[{name}] {ln}\n" for ln in o.lines))
    leaked, segments = _reap_leftovers(list(pids.values()) + seen + spare_pids,
                                       set(seen) | set(spare_pids), namespaces)

    live = [outs[i] for i in node_out]
    expect_rcs = [0, -signal.SIGKILL, 0] if replace_node else [0, 0]
    _check(rcs == expect_rcs, f"the agents exited {rcs}, not {expect_rcs}:\n{dump()}")
    _check(master_rc == 0 and mout.grep(r"job master exiting: succeeded"),
          f"the master exited {master_rc}, not with SUCCEEDED")
    all_boots = [b for o in outs for b in o.events("boot")]
    restarts = [[b["restart_count"] for b in o.events("boot")] for o in outs]
    _check(restarts == ([[0, 1], [0], [0]] if replace_node else [[0, 1], [0, 1]]),
          f"worker boots {[(b['pid'], b['restart_count']) for b in all_boots]}")
    for b in all_boots:
        _check(b["backend"] == "gloo" and b["world"] == 2,
              f"worker {b['pid']} reports backend {b['backend']} and world {b['world']}")
    recs = [o.recoveries for o in outs]
    _check([len(r) for r in recs] == ([1, 0, 0] if replace_node else [1, 1]), f"recoveries {recs}")
    rec0 = recs[0][0]
    rec1 = None if replace_node else recs[1][0]
    if not replace_node:
        _check(rec1["reason"] == "worker failure" and rec1["pid"] == killed
              and rec1["signal"] == signal.SIGKILL, f"node 1's agent saw {rec1}, not the SIGKILL")
    _check(rec0["pid"] == first[0]["pid"] and rec0["reason"] in ("worker failure", "membership"),
          f"node 0's agent restarted {rec0}")
    resumes = [live[r].events("resume", second[r]["pid"]) for r in (0, 1)]
    _check(all(len(x) == 1 for x in resumes), f"resume records {resumes}")
    resumed = [x[0]["restored_step"] for x in resumes]
    _check(resumed[0] == resumed[1] >= 0, f"the nodes resumed at steps {resumed}")
    sources = [x[0]["restored_from"] for x in resumes]
    _check(len({"storage" if s == "storage" else "memory" for s in sources}) == 1,
          f"the nodes restored from {sources}")
    if replace_node:
        _check(sources[1] == "peer" and resumes[1][0].get("peer_refill") == "refilled"
              and sources[0] in ("prefetch", "memory"),
              f"the new node 1 restored from {sources[1]} (refill "
              f"{resumes[1][0].get('peer_refill')}), node 0 from {sources[0]}")
        _check(resumed[0] == held, f"the nodes resumed step {resumed[0]}, not the replicated {held}")
    steps, launches = {}, {k: 0 for k in FLASH_PER_STEP}
    bad_launches = []
    for r in (0, 1):
        for inc, boot in enumerate((first[r], second[r])):
            steps[(inc, r)] = {x["step"]: x for x in steps_of(r if inc == 0 else node_out[r],
                                                              boot["pid"])}
            for x in steps[(inc, r)].values():
                for k in launches:
                    launches[k] += x["launches"][k]
                if device == "cuda" and x["launches"] != FLASH_PER_STEP:
                    bad_launches.append((r, x["step"], x["launches"]))
    _check(not bad_launches,
          f"steps with other flash launches than {FLASH_PER_STEP}: {bad_launches[:3]}")
    for inc in (0, 1):
        common = set(steps[(inc, 0)]) & set(steps[(inc, 1)])
        differ = [s for s in common if steps[(inc, 0)][s]["loss"] != steps[(inc, 1)][s]["loss"]]
        _check(not differ, f"ranks' losses differ at steps {differ} (incarnation {inc})")
    for r in (0, 1):
        _check(sorted(steps[(1, r)]) == list(range(resumed[r] + 1, total_steps)),
              f"node {r}'s restarted worker ran steps {sorted(steps[(1, r)])}")
        _check(sorted(steps[(0, r)])[: resumed[r] + 1] == list(range(resumed[r] + 1)),
              f"node {r}'s first worker ran steps {sorted(steps[(0, r)])}")
    for by_step in steps.values():
        for s, x in by_step.items():
            _check(math.isfinite(x["loss"]), f"non-finite loss at step {s}")
    dones = [live[r].events("done", second[r]["pid"]) for r in (0, 1)]
    _check(all(len(d) == 1 for d in dones) and dones[0][0]["state_hash"] == dones[1][0]["state_hash"],
          f"final state hashes {[[d['state_hash'] for d in x] for x in dones]}")
    for seen_owners in owners:
        held_gpu = {k: v for k, v in seen_owners.items() if v and k.startswith(("agent", "master"))}
        _check(not held_gpu, f"an agent or the master holds the GPU: {seen_owners}")
        _check(device != "cuda" or all(v for k, v in seen_owners.items() if k.startswith("worker")),
              f"a worker holds no GPU device: {seen_owners}")
    spares = {p: r for w in watches for p, r in w.spares.items()}
    held_fds = {p: r["nvidia_fds"] for p, r in spares.items() if r["nvidia_fds"]}
    _check(not held_fds, f"a spare held /dev/nvidia* before its promotion: {held_fds}")
    stopped = {p: why for o in outs for p, why in _spares_stopped(o).items()}
    unready = {p: r["samples"] for p, r in spares.items()
               if not r["ready"] and p not in stopped and p not in killed_spares}
    _check(not unready, f"spares neither seen ready nor stopped by the agent (samples): {unready}")
    _check(not leaked, f"processes of the job still alive: {leaked}")
    _check(not segments, f"shm segments of the job left behind: {segments}")
    return {"outs": live, "all_outs": outs, "first": first, "second": second, "recs": (rec0, rec1),
            "resumed": resumed[0], "sources": sources, "steps": steps, "launches": launches,
            "at_kill": at_kill, "t_kill": t_kill, "t_launch": t_launch, "t_end": t_end,
            "t_new_agent": t_new_agent if replace_node else None,
            "watch": watches[0], "owners": owners, "pids": pids, "spares": sorted(spares),
            "ranks": [[b["rank"] for b in o.events("boot")] for o in outs],
            "backend": all_boots[0]["backend"], "state_hash": dones[0][0]["state_hash"],
            "after": after, "resume_records": [x[0] for x in resumes]}


def _two_node_numbers(j, card, small, total_steps):
    """What phases 7 and 8 report of a two-node job ``j``: the step, the
    kill, both nodes' recovery, memory, persists and skipped stages."""
    outs, first, second = j["outs"], j["first"], j["second"]
    return {
        "card": card, "model": "gpt2-small" if not small else "small", "steps": total_steps,
        "world": 2, "backend": j["backend"], "global_batch": 8 if not small else 4,
        "ranks_by_node": j["ranks"], "kill": j["at_kill"], "resumed_step": j["resumed"],
        "restored_from": j["sources"],
        "median_step_s": _median([t for r in (0, 1) for boot in (first[r], second[r])
                                  for t in _step_seconds(outs[r].events("step", boot["pid"]))]),
        "recovery": {f"node{r}": {"reason": rec["reason"], "persisted_step": rec.get("persisted_step"),
                                  **_recovery_split(rec, outs[r], second[r], j["t_kill"])}
                     for r, rec in enumerate(j["recs"])},
        "mem_gb_peak": {name: _gb(kb) for name, kb in j["watch"].job_peak_kb.items()},
        "mem_gb_total_peak_rss": j["watch"].job_total_peak_kb / 2**20,
        "persists": [{"node": r, "step": int(m.group(1)), "hold_s": float(m.group(2)),
                      "write_s": float(m.group(3))} for r in (0, 1) for m in outs[r].grep(
                          r"persisted step (\d+): shard lock held ([\d.]+) s \(snapshot\), "
                          r"write ([\d.]+) s")],
        "skipped_stages": [x["skipped"] for o in outs for x in o.events("done")],
        "launches": j["launches"],
        "job_s": j["t_end"] - j["t_launch"],
    }


def two_node_phase(work, job, device="cuda", small=False, total_steps=TPURUN_STEPS,
                   reference=None, loss_tol=TPURUN_LOSS_TOL, kill_after=TWO_NODE_KILL_AFTER,
                   timeout=600, card=None, job_log=None, world_of_one_step_s=None):
    """Phase 7: the flagship example on two nodes that share one GPU, a
    SIGKILL of rank 1's worker, and the recovery of both nodes. Raises on
    the first failed check; returns the phase's facts and its numbers.
    ``reference`` maps step (as a string) to the loss of an uninterrupted
    run of the same global batch (a world of one on the card, within
    ``loss_tol``); without it an uninterrupted world of two runs first.
    ``job_log``, when given, is a file that receives every line of the
    master's and both agents' output."""
    if reference is None:
        reference = _uninterrupted_losses(work, f"{job}_ref", device, small, total_steps,
                                          timeout, n=2)
    j = _two_node_job(work, job, EXAMPLE, device, small, total_steps, kill_after, timeout,
                      job_log)
    diffs = {}
    for by_step in j["steps"].values():
        for s, x in by_step.items():
            diffs[s] = max(diffs.get(s, 0.0), abs(x["loss"] - reference[str(s)]))
    max_diff = max(diffs.values())
    _check(max_diff <= loss_tol, f"losses differ from the uninterrupted run by {max_diff}")

    def share(x):
        parts = {k: v for k, v in x.items() if k.endswith("_s")}
        return {"all_reduce_s": parts.get("all_reduce_s"), "step_s": sum(parts.values()),
                "share": parts.get("all_reduce_s", 0.0) / sum(parts.values())}

    numbers = _two_node_numbers(j, card, small, total_steps)
    numbers["median_step_s"] = {"world_of_two": numbers["median_step_s"],
                                "world_of_one": world_of_one_step_s}
    numbers["all_reduce"] = [share(x) for o in j["outs"] for x in o.events("second_step")]
    numbers["first_step_all_reduce_ms"] = [1e3 * x.get("all_reduce_s", 0.0)
                                           for o in j["outs"] for x in o.events("first_step")]
    facts = {"resumed_step": j["resumed"], "restored_from": j["sources"], "max_loss_diff": max_diff,
             "node0_restart": j["recs"][0]["reason"], "gpu_owners": j["owners"],
             "pids": j["pids"], "spares": j["spares"], "state_hash": j["state_hash"]}
    return facts, numbers


# -- phase 8: sharded input on two nodes --------------------------------------
#
# Phase 7's job with another trainer: the workers run ``chip_smoke.py
# --trainer shards``, which registers a token file as a dataset with the
# port's master and feeds ElasticTrainLoop from an ElasticShardLoader; each
# step's sample indices come from shards the master hands to the worker's
# node. After the job this process trains a world of one on the committed
# global batches, read from the workers' records, in their order.

SHARD_DATASET = "tokens"
SHARD_SAMPLES = 512
SHARD_MINIBATCHES = 2  # a shard is two of a rank's batches: 8 samples (4 at the small size)
# Phase 8 against its world of one: the same batches in the same order, so
# only the sums' order differs (8e-5 to 1.1e-4 on the card); a loader that
# fed other rows of these random tokens moves a batch's mean loss by about
# 5e-3 to 1e-2
SHARD_LOSS_TOL = 1e-3


def write_tokens(path, vocab, seq):
    """The phase's dataset: SHARD_SAMPLES samples of ``seq + 1`` uint16
    tokens from seed 0 (512 x 1025 x 2 B, about 1 MiB, at GPT-2 small),
    written once and atomically (both ranks may write it)."""
    import numpy as np

    if os.path.exists(path):
        return
    tokens = np.random.default_rng(0).integers(0, vocab, (SHARD_SAMPLES, seq + 1), dtype=np.uint16)
    tmp = f"{path}.{os.getpid()}.tmp"
    tokens.tofile(tmp)
    os.replace(tmp, path)


def read_tokens(path, seq):
    import numpy as np

    return np.fromfile(path, dtype=np.uint16).reshape(SHARD_SAMPLES, seq + 1)


def shard_trainer(args) -> int:
    """One worker of phase 8 (``--trainer shards --data FILE``), run by the
    agent as its entrypoint with the agent's env contract (``CKPT_DIR`` and
    ``TOTAL_STEPS`` as for the example). It builds the example's model and
    data-parallel step, registers ``FILE`` (written from seed 0 if absent)
    as a dataset of SHARD_SAMPLES samples through ``ShardingClient`` and
    trains from an ``ElasticShardLoader`` through ``ElasticTrainLoop`` (a
    stage every step, a persist every 5th). It prints the example's records
    (``gpt_elastic {json}``), each ``step`` with the sample indices it trained
    and the training thread's wait for its batch, and one ``shard`` record
    for each task the master handed out (with the RPC's seconds and the
    client's node id) and ``shard_done`` for each reported done."""
    import threading

    t_start = time.time()
    import numpy as np
    import torch

    from dlrover_tpu_torch.agent.sharding import ShardingClient
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.common.platform import resolve_device, strict_fp32
    from dlrover_tpu_torch.examples import gpt_elastic
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel.mesh import build_mesh, choose_mesh_shape, local_batch_slice
    from dlrover_tpu_torch.rpc.client import MasterClient
    from dlrover_tpu_torch.trainer.dataloader import ElasticShardLoader, to_device
    from dlrover_tpu_torch.trainer.elastic import elastic_context
    from dlrover_tpu_torch.trainer.loop import ElasticTrainLoop

    lock = threading.Lock()

    def emit(event, **fields):  # one write a line: the prefetch thread prints too
        line = "gpt_elastic " + json.dumps({"event": event, "pid": os.getpid(), **fields}) + "\n"
        with lock:
            sys.stdout.write(line)
            sys.stdout.flush()

    t_imported = time.time()
    total_steps = int(os.environ.get("TOTAL_STEPS", str(TPURUN_STEPS)))
    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32()
        torch.empty(1, device=device)
    t_cuda = time.time()
    ctx = elastic_context(device=device)
    mesh = build_mesh(choose_mesh_shape(ctx.world_device_count(), prefer_fsdp=False))
    t_world = time.time()
    engine = CheckpointEngine(os.environ.get("CKPT_DIR", os.path.join(
        tempfile.gettempdir(), "shard_trainer_ckpt")))
    t_engine = time.time()
    if device.type == "cuda":
        fa._lib()
    t_lib = time.time()
    cfg, state, inner_step, _ = gpt_elastic.build(args.small, device, mesh, ctx.process_id)
    t_model = time.time()
    batch = local_batch_slice(4 if args.small else 8, mesh)  # this rank's rows of the global batch
    write_tokens(args.data, cfg.vocab_size, cfg.max_seq_len)
    tokens = read_tokens(args.data, cfg.max_seq_len)
    client = MasterClient.singleton()  # the node's id from the agent's env contract

    class Shards(ShardingClient):
        def fetch_task(self):
            t0 = time.perf_counter()
            task = super().fetch_task()
            rpc_s = time.perf_counter() - t0
            if task is not None:
                emit("shard", node_id=client.node_id, task_id=task.task_id,
                     start=task.shard.start, end=task.shard.end,
                     indices=list(task.shard.indices), rpc_s=rpc_s, t=time.time())
            return task

        def report_task_done(self, task, success=True):
            super().report_task_done(task, success)
            emit("shard_done", task_id=task.task_id, t=time.time())

    shards = Shards(SHARD_DATASET, client=client, batch_size=batch, dataset_size=SHARD_SAMPLES,
                    shuffle=True, num_minibatches_per_shard=SHARD_MINIBATCHES,
                    storage_type="table")
    shards.register_dataset()

    def fetch(indices):
        rows = torch.from_numpy(tokens[indices].astype(np.int64))
        return rows[:, :-1], rows[:, 1:], list(indices)

    loader = ElasticShardLoader(shards, fetch, batch)
    stage = to_device(device)
    handoff = getattr(sys.modules.get("dlrover_tpu_torch.agent.warm_worker"), "HANDOFF", None)
    emit("boot", restart_count=ctx.restart_count, process_id=ctx.process_id,
         world_size=ctx.num_processes, world=mesh.dp, rank=ctx.process_id, backend=ctx.backend,
         node_id=client.node_id, device=str(device), t_start=t_start, t_imported=t_imported,
         t_cuda=t_cuda, t_world=t_world, t_engine=t_engine, t_lib=t_lib, t_model=t_model,
         adopted=handoff is not None, batch=batch)
    launches = dict(fa.launches)
    live = {}

    def step_fn(st, x, y, indices):
        live["wait_s"] = time.perf_counter() - live["t_ready"]
        live["indices"] = indices
        return inner_step(st, x, y)

    def on_step(step, loss):
        loss = float(loss)  # synchronises: the stamp is the step's end
        now = time.time()
        if step == loop.start_step:
            emit("resume", restored_step=loop.start_step - 1, restored_from=engine.restored_from,
                 restore_s=loop.last_restore_s, t_loop=t_loop)
        per_step = {k: fa.launches[k] - launches[k] for k in launches}
        launches.update(fa.launches)
        emit("step", step=step, rank=ctx.process_id, loss=loss, t=now, launches=per_step,
             indices=live["indices"], wait_s=live["wait_s"], skipped=dict(engine.skipped_stages))
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} at step {step}")
        live["t_ready"] = time.perf_counter()

    def data(start):
        # shards resume from the master, not from the step: the loader
        # pulls the node's next shards whatever step the world resumed at
        live["t_ready"] = time.perf_counter()
        return loader

    loop = ElasticTrainLoop(engine, step_fn, ctx=ctx, max_steps=total_steps, memory_every=1,
                            storage_every=STORAGE_EVERY, log_every=10, on_step=on_step,
                            input_stage_fn=lambda b: (*stage(b[:2]), b[2]), input_device=device)
    t_loop = time.time()
    state = loop.run(state, data_factory=data)
    engine.close()
    ctx.shutdown()
    emit("done", steps=total_steps, rank=ctx.process_id, skipped=dict(engine.skipped_stages),
         state_hash=state_hash(state))
    return 0


def _world_of_one(small, device, data, global_batches):
    """{step: loss} of the example's seed-0 model trained in this process,
    as a world of one, on ``global_batches`` ([(step, sample indices)] in
    order) read from the token file ``data``."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.examples import gpt_elastic

    cfg, state, step_fn, _ = gpt_elastic.build(small, torch.device(device))
    tokens = read_tokens(data, cfg.max_seq_len)
    losses = {}
    for step, indices in global_batches:
        rows = torch.from_numpy(tokens[indices].astype(np.int64)).to(device)
        state, loss = step_fn(state, rows[:, :-1], rows[:, 1:])
        losses[step] = float(loss)
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    return losses


def shard_phase(work, job, device="cuda", small=False, total_steps=TPURUN_STEPS,
                loss_tol=SHARD_LOSS_TOL, kill_after=TWO_NODE_KILL_AFTER, timeout=600,
                card=None, job_log=None, world_of_two_step_s=None):
    """Phase 8: phase 7's job with the workers training from master-assigned
    dataset shards (``shard_trainer``), a SIGKILL of rank 1's worker and the
    recovery of both nodes. Raises on the first failed check; returns the
    phase's facts and its numbers. Beyond phase 7's shared checks: every
    worker's client carries its node's id; the ranks' indices are disjoint
    at every step and come only from shards the master handed that
    worker, whose task ids no other node was handed; no index is trained in
    two committed steps (the first workers' steps up to the resume, then
    the restarted workers'); the losses are within ``loss_tol`` of a world
    of one that this process trains afterwards on the committed global
    batches. Once both nodes have resumed, it reads the master's shard
    checkpoint to count the samples that the killed workers' open shards
    leave out of the run."""
    from dlrover_tpu_torch.rpc.client import MasterClient

    data = os.path.join(work, "tokens.u16")
    entry = [os.path.abspath(__file__), "--trainer", "shards", "--data", data]

    def read_checkpoint(addr):
        return json.loads(MasterClient(addr, node_id=-1).get_shard_checkpoint(SHARD_DATASET))

    j = _two_node_job(work, job, entry, device, small, total_steps, kill_after, timeout, job_log,
                      after_resume=read_checkpoint)
    outs, first, second, steps = j["outs"], j["first"], j["second"], j["steps"]
    resumed = j["resumed"]
    issued = {}  # pid: {index: task id} of the shards each worker was handed
    tasks_by_node = {}
    rpc_s = []
    for r in (0, 1):
        for boot in (first[r], second[r]):
            _check(boot["node_id"] == r, f"node {r}'s worker {boot['pid']} has node id "
                                         f"{boot['node_id']}")
            got = issued.setdefault(boot["pid"], {})
            for x in outs[r].events("shard", boot["pid"]):
                _check(x["node_id"] == r, f"a shard for node {x['node_id']} in node {r}'s worker")
                for i in x["indices"] or range(x["start"], x["end"]):
                    got[i] = x["task_id"]
                rpc_s.append(x["rpc_s"])
    committed = {}  # step: [rank 0's indices, rank 1's indices]
    for r in (0, 1):
        for inc, boot in enumerate((first[r], second[r])):
            for s, x in steps[(inc, r)].items():
                unissued = [i for i in x["indices"] if i not in issued[boot["pid"]]]
                _check(not unissued, f"node {r} trained indices {unissued} at step {s} that the "
                                     f"master never handed its worker")
                for i in x["indices"]:
                    tasks_by_node.setdefault(issued[boot["pid"]][i], set()).add(r)
                if (inc == 0 and s <= resumed) or inc == 1:
                    committed.setdefault(s, [None, None])[r] = x["indices"]
    shared = {t: n for t, n in tasks_by_node.items() if len(n) > 1}
    _check(not shared, f"tasks handed to both nodes: {shared}")
    _check(sorted(committed) == list(range(total_steps)) and all(
        a is not None and b is not None for a, b in committed.values()),
        f"committed steps {sorted(committed)}")
    overlap = {s: sorted(set(a) & set(b)) for s, (a, b) in committed.items() if set(a) & set(b)}
    _check(not overlap, f"the ranks trained the same indices at steps {overlap}")
    trained = [i for s in sorted(committed) for part in committed[s] for i in part]
    twice = sorted({i for i in trained if trained.count(i) > 1})
    _check(not twice, f"indices trained in two committed steps: {twice}")

    # the world of one on the committed global batches, on the freed device
    t0 = time.time()
    reference = _world_of_one(small, device, data, [(s, committed[s][0] + committed[s][1])
                                                    for s in sorted(committed)])
    world_of_one_s = time.time() - t0
    diffs = {}
    for (inc, r), by_step in steps.items():
        for s, x in by_step.items():
            if (inc == 0 and s <= resumed) or inc == 1:
                diffs[s] = max(diffs.get(s, 0.0), abs(x["loss"] - reference[s]))
    max_diff = max(diffs.values())
    _check(max_diff <= loss_tol, f"losses differ from the world of one by {max_diff}")

    # what the killed workers' shards leave out: each first worker's shards,
    # less what the committed steps trained, split by where the master has
    # them after the resume (still in its doing set, or reported done)
    ckpt = j["after"]
    doing = {(start, end) for start, end, _ in ckpt["doing"]}
    trained_set = set(trained)
    left = {"open_in_doing": 0, "reported_done": 0}
    for r in (0, 1):
        pid = first[r]["pid"]
        for x in outs[r].events("shard", pid):
            lost = [i for i in (x["indices"] or range(x["start"], x["end"]))
                    if i not in trained_set]
            key = "open_in_doing" if (x["start"], x["end"]) in doing else "reported_done"
            left[key] += len(lost)
    waits = [x["wait_s"] for by_step in steps.values()
             for x in sorted(by_step.values(), key=lambda x: x["step"])[1:]]
    numbers = _two_node_numbers(j, card, small, total_steps)
    numbers["median_step_s"] = {"shards": numbers["median_step_s"],
                                "phase7_world_of_two": world_of_two_step_s}
    numbers.update({
        "dataset": {"samples": SHARD_SAMPLES, "shard_samples": first[0]["batch"] * SHARD_MINIBATCHES,
                    "tokens_per_sample": os.path.getsize(data) // (2 * SHARD_SAMPLES)},
        "get_task_rpc_s": {"median": _median(rpc_s), "max": max(rpc_s), "n": len(rpc_s)},
        "batch_wait_s": {"median": _median(waits), "max": max(waits), "n": len(waits),
                         "first_step": [sorted(by.values(), key=lambda x: x["step"])[0]["wait_s"]
                                        for by in steps.values()]},
        "samples_left_out": dict(left, total=left["open_in_doing"] + left["reported_done"]),
        "master_checkpoint_after_resume": {"todo": len(ckpt["todo"]), "doing": len(ckpt["doing"]),
                                           "epoch": ckpt["epoch"]},
        "world_of_one_s": world_of_one_s,
        "max_loss_diff_vs_world_of_one": max_diff,
    })
    facts = {"resumed_step": resumed, "restored_from": j["sources"], "max_loss_diff": max_diff,
             "node0_restart": j["recs"][0]["reason"], "samples_left_out": numbers["samples_left_out"],
             "committed_samples": len(trained), "pids": j["pids"], "state_hash": j["state_hash"]}
    return facts, numbers


# -- phase 9: the Llama family ------------------------------------------------

# Llama-125M as bench.py:1081-1085 trains it: vocab 32000, 12 layers, 12 heads
# over 4 KV heads of 64, embed 768, SwiGLU 2048, flash, remat; batch 16, seq
# 1024. Its MoE variant (bench.py:1097) makes every 2nd block's MLP 4 experts
# with top-2 routing.
LLAMA_125M = dict(vocab_size=32000, max_seq_len=1024, num_layers=12, num_heads=12,
                  num_kv_heads=4, head_dim=64, embed_dim=768, mlp_dim=2048,
                  attention_impl="flash", use_remat=True)
LLAMA_BATCH = (16, 1024)
LLAMA_SMALL = dict(vocab_size=256, max_seq_len=32, num_layers=2, num_heads=4, num_kv_heads=2,
                   head_dim=16, embed_dim=64, mlp_dim=128, attention_impl="flash",
                   use_remat=True)
LLAMA_SMALL_BATCH = (4, 32)
LLAMA_MOE = dict(num_experts=4, moe_every=2)
LLAMA_STEPS = 10
# the step from the restored MoE state against the uninterrupted run's
LLAMA_RESUME_TOL = 1e-5
# checks that need the card's kernels; the CPU twin leaves them out by name
LLAMA_CARD_ONLY = ("launches",)


def llama_phase(work, job, device="cuda", small=False, steps=LLAMA_STEPS):
    """Phase 9: Llama-125M and its MoE variant, each ``steps`` steps from
    seed-0 weights on one seeded batch through ``init_train_state`` /
    ``build_train_step`` (AdamW from ``default_optimizer()``, the MoE
    load-balance term at ``aux_loss_weight`` 0.01). The MoE state after step
    ``steps - 2`` is staged to shm through a standalone ``CheckpointEngine``
    under DLROVER_JOB_NAME ``job`` (sockets and storage under ``work``), and
    restored into a model built afresh. Raises on the first failed check;
    returns the phase's numbers. The environment and socket directory it
    sets are restored on return, and the job's shm segments unlinked."""
    try:
        with _job_ipc(work, job):
            return _llama_phase(work, device, small, steps)
    finally:
        _unlink_job_segments([job])


def _llama_phase(work, device, small, steps):
    import numpy as np
    import torch

    from dlrover_tpu_torch.models import llama

    cuda = torch.device(device).type == "cuda"
    base, (batch, seq) = (LLAMA_SMALL, LLAMA_SMALL_BATCH) if small else (LLAMA_125M, LLAMA_BATCH)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, base["vocab_size"], (batch, seq))).to(device)
    targets = torch.roll(tokens, -1, dims=1)
    skipped = [] if cuda else list(LLAMA_CARD_ONLY)
    if skipped:
        log(f"  checks left out without the card: {skipped}")
    out = {"card": card_line() if cuda else "CPU", "batch": batch, "seq_len": seq,
           "steps": steps, "skipped_checks": skipped}
    for label, over in (("dense", {}), ("moe", LLAMA_MOE)):
        cfg = llama.LlamaConfig(**base, **over)
        log(f"  {label}: {cfg}")
        out[label] = _llama_variant(cfg, tokens, targets, device, steps, work)
        log(f"  {label}: " + json.dumps(out[label]))
        if cuda:
            torch.cuda.empty_cache()
    return out


def _llama_variant(cfg, tokens, targets, device, steps, work):
    import torch

    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import train_step

    cuda = torch.device(device).type == "cuda"
    moe = cfg.num_experts > 0
    batch, seq = tokens.shape

    def build(seed):
        model = llama.Llama(cfg, device=device, seed=seed)
        tx = train_step.default_optimizer()
        state = train_step.init_train_state(model, tokens, tx, device=device, seed=seed)
        return model, state, train_step.build_train_step(model, tx, llama.llama_loss)

    model, state, step_fn = build(0)
    n_params = sum(p.numel() for p in state.params.values())
    engine = staged = None
    if moe:
        image = 12 * n_params + 16  # fp32 params, mu and nu; step and count
        free = shutil.disk_usage("/dev/shm").free
        log(f"  /dev/shm free {free} bytes; the MoE image {image} bytes")
        _check(free > 1.1 * image, "/dev/shm cannot hold the MoE train state")
        engine = CheckpointEngine(os.path.join(work, "ckpt"), standalone=True,
                                  prefetch_restore=False)
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses, step_s, per_step = [], [], []
        for i in range(steps):
            before = dict(fa.launches)
            t0 = time.perf_counter()
            state, loss = step_fn(state, tokens, targets)
            loss = float(loss)  # synchronises
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            per_step.append({k: fa.launches[k] - before[k] for k in before})
            if moe and i == steps - 2:
                t0 = time.perf_counter()
                _check(engine.save_to_memory(i, state), f"the stage of step {i} was skipped")
                staged = dict(step=i, hash=state_hash(state), stage_s=time.perf_counter() - t0)
        launches = dict(fa.launches)
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        log(f"  losses {losses}")
        log(f"  step seconds {step_s}")
        log(f"  launches {launches} over {steps} steps")
        _check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
        _check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
               f"first loss {losses[0]} is not near ln(vocab) {math.log(cfg.vocab_size)}")
        expect = {"fwd": 2 * cfg.num_layers, "bwd_dkdv": cfg.num_layers,
                  "bwd_dq": cfg.num_layers}  # forward twice: remat recomputes it
        if cuda:
            bad = [(i, n) for i, n in enumerate(per_step) if n != expect]
            _check(not bad, f"steps with other flash launches than {expect}: {bad[:3]}")

        cmp = flash_vs_dense(model, tokens, targets)

        steady = statistics.median(step_s[1:])
        result = {
            "model": f"llama-{'moe-' if moe else ''}{n_params / 1e6:.0f}M", "n_params": n_params,
            "first_step_s": step_s[0], "step_s": steady, "tokens_per_s": batch * seq / steady,
            "peak_mem_gb": peak, "losses": losses, "launches": launches, "flash_vs_dense": cmp,
        }
        if not moe:
            # bench.py:926-928; the MoE prints none (bench.py:1124-1129: the 6N
            # count would charge its inactive experts as work)
            flops_per_token = 6 * n_params + 12 * cfg.num_layers * cfg.embed_dim * seq
            result["mfu"] = (flops_per_token * batch * seq / steady / PEAK_BF16_FLOPS
                             if cuda else None)
            return result

        # the load-balance terms of the last step, and a gradient for every
        # expert (one more forward and backward on the batch)
        aux = [float(a) for a in model.aux_losses]
        n_moe = sum(cfg.is_moe_block(i) for i in range(cfg.num_layers))
        _check(len(aux) == n_moe and all(math.isfinite(a) for a in aux) and sum(aux) > 0,
               f"MoE aux terms {aux} ({n_moe} MoE blocks)")
        w_gates = [b.mlp.w_gate for b in model.blocks if isinstance(b.mlp, llama.MoeMlp)]
        loss = llama.llama_loss(model(tokens), targets) + 0.01 * sum(model.aux_losses)
        grads = torch.autograd.grad(loss, w_gates)
        expert_grad = [[float(g[e].abs().max()) for e in range(cfg.num_experts)] for g in grads]
        log(f"  aux {aux}; max |grad w_gate| per MoE block and expert {expert_grad}")
        _check(all(x > 0 and math.isfinite(x) for row in expert_grad for x in row),
               "an expert's w_gate got no gradient")

        # the staged state, restored into a model built afresh, steps as the
        # uninterrupted run's last step did
        del model, state, step_fn, grads, loss, w_gates
        model, fresh, step_fn = build(1)
        t0 = time.perf_counter()
        step, restored = engine.load(fresh)
        restore_s = time.perf_counter() - t0
        restored_hash = state_hash(restored)
        _, resumed_loss = step_fn(restored, tokens, targets)
        resumed_loss = float(resumed_loss)
        log(f"  staged step {staged['step']} in {staged['stage_s']:.3f} s; restored step {step} "
            f"from {engine.restored_from} in {restore_s:.3f} s, hash equal "
            f"{restored_hash == staged['hash']}; next loss {resumed_loss} against {losses[-1]}")
        _check(step == staged["step"] and engine.restored_from == "memory",
               f"restored step {step} from {engine.restored_from}")
        _check(restored_hash == staged["hash"], "the restored MoE state differs from the staged one")
        _check(abs(resumed_loss - losses[-1]) <= LLAMA_RESUME_TOL,
               f"the step from the restored state gives {resumed_loss}, the run {losses[-1]}")
        result.update(aux=aux, expert_w_gate_grad_max=expert_grad, checkpoint={
            "step": staged["step"], "image_bytes": image, "stage_s": staged["stage_s"],
            "restore_s": restore_s, "hash_equal": True, "resumed_loss": resumed_loss,
            "resumed_loss_bit_equal": resumed_loss == losses[-1]})
        return result
    finally:
        if engine is not None:
            engine.close()


# -- phase 10: the restore chain on two nodes of one card ----------------------
#
# Phase 7's job with peer replicas (on by default in a world of two) and the
# durable tier: node 1 is replaced whole and restores from node 0's memory;
# then, with every shm segment and the flash storage gone, a world of one
# restores the newest committed durable generation.

CHAIN_STEPS = 30
CHAIN_KILL_AFTER = 10
# node 1 dies at a step that leaves a durable step (25) after the resume
CHAIN_KILL_BY = 24
# a generation that lost a host's shard (node 1 dies mid-drain) never meets
# its barrier, and rank 0's writer waits it out before the next one: 30 s,
# not the default 120 s, keeps that inside the phase
CHAIN_DURABLE = {"DLROVER_DURABLE_EVERY": "5", "DLROVER_DURABLE_KEEP": "2",
                 "DLROVER_DURABLE_COMMIT_TIMEOUT_S": "30"}
_PUSH = r"replica push of step (\d+): (\d+) bytes in ([\d.]+) s, ok=True \(shard lock held ([\d.]+) s\)"
_FETCH = r"recovered shard of rank (\d+) from peer (\d+) at (\S+) in ([\d.]+) s"
_DRAIN = (r"durable shard of step (\d+) written from the (saver buffer|shm): (\d+) bytes in "
          r"([\d.]+) s \(shard lock held ([\d.]+) s\)")
_COMMITTED = r"durable generation committed: (\S+) gen_(\d+)"
_DURABLE_READ = r"restored step (\d+) from durable tier \S+ \(saved world (\d+), (\d+) bytes, ([\d.]+) s\)"


def restore_chain_phase(work, job, device="cuda", small=False, total_steps=CHAIN_STEPS,
                        reference=None, loss_tol=TPURUN_LOSS_TOL, kill_after=CHAIN_KILL_AFTER,
                        timeout=600, card=None, job_log=None, stage_block_s=None):
    """Phase 10: (a) phase 7's job, every stage replicated to the peer and
    every 5th step drained to the durable tier, where node 1 dies whole
    (agent, worker, spare, shm) once node 0 holds its replica of a staged
    step newer than storage's, and a new node 1 restores that step from
    node 0's memory; (b) after the job, with every shm segment and the
    flash storage deleted, the example as a world of one restores the
    newest committed durable generation and trains on. ``reference`` maps
    step (as a string) to an uninterrupted world of one's loss (run first
    without it). Raises on the first failed check; returns the phase's
    facts and numbers."""
    import signal

    from dlrover_tpu_torch.checkpoint.durable.layout import DurableLayout

    if reference is None:
        reference = _uninterrupted_losses(work, f"{job}_ref", device, small, total_steps,
                                          timeout, n=1)
    durable = os.path.join(work, "durable")
    env = dict(CHAIN_DURABLE, DLROVER_DURABLE_DIR=durable, DLROVER_DURABLE_LINEAGE=job)
    # the kill waits for a committed generation: a generation in flight on
    # node 1 dies with it, and rank 0's writer waits out its barrier
    layout = DurableLayout(durable, job)
    j = _two_node_job(work, job, EXAMPLE, device, small, total_steps, kill_after, timeout,
                      job_log, replace_node=True, env=env,
                      kill_gate=lambda: layout.latest_committed() is not None,
                      kill_by=min(CHAIN_KILL_BY, total_steps - 2))
    diffs = {}
    for by_step in j["steps"].values():
        for s, x in by_step.items():
            diffs[s] = max(diffs.get(s, 0.0), abs(x["loss"] - reference[str(s)]))
    max_diff = max(diffs.values())
    _check(max_diff <= loss_tol, f"losses differ from the uninterrupted run by {max_diff}")
    storage_step = j["at_kill"]["storage_step"]
    _check(j["resumed"] > (-1 if storage_step is None else storage_step),
           f"resumed step {j['resumed']} is not newer than storage's {storage_step}")
    outs, all_outs = j["outs"], j["all_outs"]
    fetches = [(int(m.group(1)), int(m.group(2)), float(m.group(4))) for m in outs[1].grep(_FETCH)]
    _check(any(rank == 1 and holder == 0 for rank, holder, _ in fetches),
           f"no log line of the new node 1 names its shard's recovery from peer 0: {fetches}")
    pushes = [{"node": i, "step": int(m.group(1)), "bytes": int(m.group(2)),
               "push_s": float(m.group(3)), "hold_s": float(m.group(4)),
               "gbps": int(m.group(2)) / float(m.group(3)) / 1e9 if float(m.group(3)) else None}
              for i, o in enumerate(all_outs) for m in o.grep(_PUSH)]
    _check(any(p["node"] == 1 and p["step"] == j["resumed"] for p in pushes),
           f"node 1's push of step {j['resumed']} is not in its agent's log: {pushes}")
    drains = [{"node": i, "step": int(m.group(1)), "source": m.group(2), "bytes": int(m.group(3)),
               "write_s": float(m.group(4)), "hold_s": float(m.group(5))}
              for i, o in enumerate(all_outs) for m in o.grep(_DRAIN)]
    committed = sorted({int(m.group(2)) for o in all_outs for m in o.grep(_COMMITTED)
                        if m.group(1) == job})
    newest = layout.latest_committed()
    _check(len(committed) >= 2 and newest == committed[-1],
           f"durable generations committed {committed}, newest on disk {newest}")
    _check(all(d["source"] == "saver buffer" for d in drains),
           f"a durable drain copied out of shm: {drains}")
    hold_bound = None if stage_block_s is None else 2 * stage_block_s + 0.025
    _check(hold_bound is None or max(d["hold_s"] for d in drains) <= hold_bound,
           f"a durable drain held the shard lock longer than {hold_bound} s: {drains}")

    # (b) a whole-pool loss: no shm, no flash storage, a world of one
    _unlink_job_segments([f"{job}_"])
    shutil.rmtree(os.path.join(work, "ckpt"), ignore_errors=True)
    pool_job = f"{job}_pool"
    pool_env = dict(os.environ, DLROVER_JOB_NAME=pool_job, CKPT_DIR=os.path.join(work, "ckpt"),
                    TOTAL_STEPS=str(total_steps), DLROVER_IPC_DIR=os.path.join(work, "sockets_pool"),
                    DLROVER_DURABLE_DIR=durable, DLROVER_DURABLE_LINEAGE=job, **CHAIN_DURABLE)
    for name in ("DLROVER_MASTER_ADDR", "DLROVER_IPC_NAMESPACE", "DLROVER_NODE_ID",
                 "DLROVER_NODE_RANK"):
        pool_env.pop(name, None)
    extra = ["--device", "cpu", "--small"] if small else []
    t_pool = time.time()
    proc = subprocess.Popen([sys.executable] + FLAGSHIP + extra, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=pool_env,
                            start_new_session=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    pout = _JobOutput(proc)
    try:
        rc = proc.wait(timeout)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)
        pout.join()
        boots = pout.events("boot")
        for b in boots:
            if _proc_alive(b["pid"]):
                os.killpg(os.getpgid(b["pid"]), signal.SIGKILL)
    if job_log:
        with open(job_log, "a") as f:
            f.write("".join(f"[world of one] {ln}\n" for ln in pout.lines))
    leaked, segments = _reap_leftovers([proc.pid] + [b["pid"] for b in boots],
                                       {proc.pid} | {b["pid"] for b in boots}, [pool_job])
    _check(rc == 0, f"the world of one exited {rc}:\n{_job_tail([('', pout)], 40)}")
    (boot,) = boots
    (resume,) = pout.events("resume", boot["pid"])
    _check(resume["restored_from"] == "durable" and resume["restored_step"] == newest,
           f"the world of one restored step {resume['restored_step']} from "
           f"{resume['restored_from']}, not generation {newest} from the durable tier")
    reads = [m for m in pout.grep(_DURABLE_READ) if int(m.group(1)) == newest]
    _check(len(reads) == 1 and int(reads[0].group(2)) == 2,
           f"no log line of the durable read of a world of two's gen_{newest}")
    pool_steps = {x["step"]: x for x in pout.events("step", boot["pid"])}
    _check(sorted(pool_steps) == list(range(newest + 1, total_steps)),
           f"the world of one ran steps {sorted(pool_steps)}")
    pool_diff = max(abs(x["loss"] - reference[str(s)]) for s, x in pool_steps.items())
    _check(pool_diff <= loss_tol, f"the world of one's losses differ by {pool_diff}")
    bad = [(s, x["launches"]) for s, x in pool_steps.items()
           if device == "cuda" and x["launches"] != FLASH_PER_STEP]
    _check(not bad, f"world-of-one steps with other flash launches than {FLASH_PER_STEP}: {bad}")
    _check(not leaked and not segments, f"left behind: processes {leaked}, segments {segments}")

    rec0 = j["recs"][0]
    new_boot, new_resume = j["second"][1], j["resume_records"][1]
    new_first = outs[1].events("step", new_boot["pid"])[0]
    t_kill = j["t_kill"]
    numbers = {
        "card": card, "model": "gpt2-small" if not small else "small", "steps": total_steps,
        "durable": CHAIN_DURABLE, "kill": j["at_kill"],
        "resumed_step": j["resumed"], "restored_from": j["sources"],
        "max_loss_diff": max_diff,
        "replica_pushes": pushes,
        "push_gbps_median": _median([p["gbps"] for p in pushes if p["gbps"]]),
        "fetch_s": [f for _, _, f in fetches],
        "recovery": {
            "node0": {"reason": rec0["reason"], **_recovery_split(rec0, outs[0], j["second"][0],
                                                                  t_kill)},
            "node1_replaced": {
                "new_agent_s": j["t_new_agent"] - t_kill,
                "agent_to_worker_s": new_boot["t_start"] - j["t_new_agent"],
                "boot_split": _boot_split(new_boot),
                "to_restore_s": new_resume["t_loop"] - t_kill,
                "restore_s": new_resume["restore_s"],
                "first_step_s": new_first["t"] - new_resume["t_loop"] - new_resume["restore_s"],
                "total_s": new_first["t"] - t_kill,
                "first_step_split": _first_step_split(outs[1], new_boot["pid"])}},
        "mem_gb_peak": {name: _gb(kb) for name, kb in j["watch"].job_peak_kb.items()},
        "mem_gb_total_peak_rss": j["watch"].job_total_peak_kb / 2**20,
        "dev_shm_gb_peak": j["watch"].shm_peak_bytes / 2**30,
        "durable_drains": drains, "durable_committed": committed,
        "durable_lock_hold_s_max": max(d["hold_s"] for d in drains),
        "stage_block_s": stage_block_s,
        "launches": j["launches"],
        "whole_pool": {"restored_step": newest, "generation_bytes": int(reads[0].group(3)),
                       "read_s": float(reads[0].group(4)), "restore_s": resume["restore_s"],
                       "max_loss_diff": pool_diff, "job_s": time.time() - t_pool,
                       "launches": {k: sum(x["launches"][k] for x in pool_steps.values())
                                    for k in FLASH_PER_STEP}},
        "job_s": j["t_end"] - j["t_launch"],
    }
    facts = {"resumed_step": j["resumed"], "restored_from": j["sources"],
             "storage_step_at_kill": storage_step, "max_loss_diff": max_diff,
             "pool_restored_step": newest, "pool_max_loss_diff": pool_diff,
             "state_hash": j["state_hash"]}
    return facts, numbers


# -- one GPU a rank (``chip_smoke.py --multi-gpu-world``) ------------------------
#
# Phase 7's ranks share the card, so their backend is gloo. On a machine
# with several GPUs this mode gives each rank its own (CUDA_VISIBLE_DEVICES),
# so the backend rule must pick NCCL and the checkpoint engine's metadata
# goes through the gloo group it makes beside the NCCL default group.


def _gpu_count() -> int:
    """GPUs of this machine from ``nvidia-smi -L``, without a CUDA context
    in this process (the workers own the devices)."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(ln.startswith("GPU ") for ln in out.stdout.splitlines()) if out.returncode == 0 else 0


MULTI_GPU_STEPS = 20


def multi_gpu_world(device=None, small=False, timeout=600):
    """The example as a world of one rank per GPU (two CPU processes over
    gloo with ``device="cpu"``), three times: ``world``, N ranks for
    ``steps = MULTI_GPU_STEPS`` steps from scratch; ``resume``, the same
    ranks, job names and checkpoint directory for ``steps + 5`` steps,
    each rank finding its staged step in its own shm segment and the world
    agreeing to restore it from memory; ``one``, one process on the first
    GPU with the whole batch for ``steps + 5`` steps, the reference. Checks
    the backend (``nccl``; ``gloo`` on the CPU), distinct GPU UUIDs, losses
    bit-equal across the ranks and within 1e-2 of the world of one, equal
    final hashes, the resume from memory at step ``steps - 1`` and 24/12/12
    flash launches a step on the GPU. Returns the result, with the median
    step of each run and the all-reduce's part of each rank's second
    step; raises on a failed check."""
    cpu = device == "cpu"
    steps, nproc = MULTI_GPU_STEPS, 2 if cpu else _gpu_count()
    if nproc < 2:
        raise RuntimeError("a world of one rank per GPU needs two GPUs (or device='cpu')")
    example_args = (["--device", "cpu"] if cpu else []) + (["--small"] if small else [])
    work = tempfile.mkdtemp(prefix="chip_smoke_mgw_")
    job = f"mgw_{os.getpid()}"
    try:
        world = _example_world(work, f"{job}_w", nproc, steps, example_args, timeout,
                               gpu_per_rank=not cpu)
        resume = _example_world(work, f"{job}_w", nproc, steps + 5, example_args, timeout,
                                gpu_per_rank=not cpu)
        (one,) = _example_world(work, f"{job}_1", 1, steps + 5, example_args, timeout,
                                gpu_per_rank=not cpu)
    finally:
        _unlink_job_segments([f"{job}_"])
        shutil.rmtree(work, ignore_errors=True)

    def events(recs, kind):
        return [x for x in recs if x["event"] == kind]

    def median_step(recs):
        return statistics.median(_step_seconds(events(recs, "step")))

    reference = _step_losses(one)
    boots = [events(recs, "boot")[0] for recs in world + resume]
    _check(all(b["backend"] == ("gloo" if cpu else "nccl") and b["world"] == nproc for b in boots),
          f"backends {[b['backend'] for b in boots]}, worlds {[b['world'] for b in boots]}")
    uuids = boots[0]["gpu_uuids"]
    _check(cpu or len(set(uuids)) == nproc, f"GPU UUIDs {uuids}")
    max_diff = 0.0
    per_step = FLASH_PER_STEP
    for run in (world, resume):
        first = _step_losses(run[0])
        _check(all(_step_losses(recs) == first for recs in run), "the ranks' losses differ")
        for step, loss in first.items():
            _check(math.isfinite(loss), f"non-finite loss at step {step}")
            max_diff = max(max_diff, abs(loss - reference[step]))
        hashes = {events(recs, "done")[0]["state_hash"] for recs in run}
        _check(len(hashes) == 1, f"final state hashes {hashes}")
        bad = [x["launches"] for recs in run for x in events(recs, "step")
               if not cpu and x["launches"] != per_step]
        _check(not bad, f"steps with other flash launches than {per_step}: {bad[:3]}")
    _check(max_diff <= TPURUN_LOSS_TOL, f"losses differ from the world of one by {max_diff}")
    resumes = [events(recs, "resume")[0] for recs in resume]
    _check(all(x["restored_step"] == steps - 1 and x["restored_from"] in ("prefetch", "memory")
              for x in resumes),
          f"resumed {[(x['restored_step'], x['restored_from']) for x in resumes]}")
    _check(sorted(_step_losses(resume[0])) == list(range(steps, steps + 5)),
          f"resumed steps {sorted(_step_losses(resume[0]))}")

    def second(recs):
        (x,) = events(recs, "second_step")
        parts = {k: v for k, v in x.items() if k.endswith("_s")}
        return {"all_reduce_s": parts.get("all_reduce_s"), "step_s": sum(parts.values())}

    return {
        "card": "CPU" if cpu else card_line(), "ranks": nproc, "backend": boots[0]["backend"],
        "gpu_uuids": uuids, "steps": steps, "global_batch": 4 if small else 8,
        "median_step_s": {"world": statistics.median(median_step(r) for r in world),
                          "world_of_one": median_step(one)},
        "second_step": [second(recs) for recs in world],
        "first_step_all_reduce_s": [events(recs, "first_step")[0].get("all_reduce_s")
                                    for recs in world],
        "resumed": [(x["restored_step"], x["restored_from"]) for x in resumes],
        "restore_s": [x["restore_s"] for x in resumes],
        "max_loss_diff_vs_world_of_one": max_diff,
        "skipped_stages": [events(recs, "done")[0]["skipped"] for recs in world],
    }


def main(argv=()) -> int:
    import argparse

    argv = list(argv)
    if argv[:1] == ["--tpurun-no-spare"]:
        return _no_spare_entry(argv[1:])

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trainer",
                        choices=("reference", "kill", "resume", "restore", "bench", "shards"),
                        help="run one trainer process of the checkpoint phase, or (shards) "
                             "a worker of the sharded-input phase")
    parser.add_argument("--ckpt", help="checkpoint directory of the trainer")
    parser.add_argument("--data", help="token file of the shards trainer")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true", help="2-layer model (tests)")
    parser.add_argument("--job-log-dir", help="write each tpurun run's whole output here")
    parser.add_argument("--multi-gpu-world", action="store_true",
                        help="only run the example as a world of one rank per GPU (NCCL) "
                             "and print its result")
    args = parser.parse_args(argv)
    if args.trainer == "shards":
        return shard_trainer(args)
    if args.trainer:
        return trainer(args)
    if args.multi_gpu_world:
        print(json.dumps({"multi_gpu_world": multi_gpu_world(
            None if args.device == "cuda" else args.device, args.small)}), flush=True)
        return 0
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
    if job_log_dir:
        os.makedirs(job_log_dir, exist_ok=True)
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
    log(f"kernels at {LLAMA_SHAPE}, phase 9's shape")
    llama_checks, llama_times = kernel_phase(fa, LLAMA_SHAPE, gen, timed=True)

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

    log("two nodes on one card: a master, two agents (elastic_run --nnodes 2), a world of two "
        "over gloo, a SIGKILL of rank 1's worker and the recovery of both nodes")
    work = tempfile.mkdtemp(prefix="chip_smoke_two_node_")
    try:
        two_facts, two_numbers = two_node_phase(
            work, f"chip_smoke_2n_{os.getpid()}_{int(time.time())}",
            reference=facts["reference_losses"], card=card,
            world_of_one_step_s=tpurun_times["A"]["step_s"]["worker1"]["other"]["median"],
            job_log=job_log_dir and os.path.join(job_log_dir, "two_node.log"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("two nodes: " + json.dumps(two_facts))

    log("sharded input on two nodes: phase 7's job training from dataset shards the master "
        "hands out, a SIGKILL of rank 1's worker, and a world of one on the committed batches")
    work = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        shard_facts, shard_numbers = shard_phase(
            work, f"chip_smoke_sh_{os.getpid()}_{int(time.time())}", card=card,
            world_of_two_step_s=two_numbers["median_step_s"]["world_of_two"],
            job_log=job_log_dir and os.path.join(job_log_dir, "shards.log"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("sharded input: " + json.dumps(shard_facts))

    log("the Llama family: Llama-125M and its top-2 MoE variant, 10 steps each at batch 16 "
        "x seq 1024, and the MoE state through shm into a model built afresh")
    work = tempfile.mkdtemp(prefix="chip_smoke_llama_")
    try:
        llama_numbers = llama_phase(work, f"chip_smoke_llama_{os.getpid()}_{int(time.time())}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log("the restore chain: phase 7's job with peer replicas and the durable tier; node 1 "
        "replaced whole restores from node 0's memory, then a world of one restores the newest "
        "durable generation after shm and flash storage are gone")
    work = tempfile.mkdtemp(prefix="chip_smoke_chain_")
    try:
        chain_facts, chain_numbers = restore_chain_phase(
            work, f"chip_smoke_rc_{os.getpid()}_{int(time.time())}",
            reference=facts["reference_losses"], card=card,
            stage_block_s=numbers.get("async_block_s"),
            job_log=job_log_dir and os.path.join(job_log_dir, "restore_chain.log"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("restore chain: " + json.dumps(chain_facts))

    shape = {k: MAIN_SHAPE[k] for k in ("B", "T", "H", "D", "causal")}
    kernels = []
    for name, (nbytes, flops) in bounds(**shape).items():
        b_ms, b_by = bound_ms(nbytes, flops)
        rows = checks[name] + ragged[name] + llama_checks[name]
        worst = max(rows, key=lambda c: c[1] / c[2])
        llama_bound = bound_ms(*bounds(**LLAMA_SHAPE)[name])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": result["launches"][name],
            # the same kernel's launches in phase 7's two workers (counted
            # from 0 in each worker process)
            "launches_two_node": two_numbers["launches"][name],
            "launches_shards": shard_numbers["launches"][name],
            # phase 9's launches over each variant's 10 steps
            "launches_llama": llama_numbers["dense"]["launches"][name],
            "launches_moe": llama_numbers["moe"]["launches"][name],
            # phase 10's launches over both nodes' workers, then the world of
            # one's after the whole-pool loss
            "launches_restore_chain": chain_numbers["launches"][name],
            "launches_whole_pool": chain_numbers["whole_pool"]["launches"][name],
            "max_abs_err": max(c[1] for c in rows),
            "tol": worst[2], "max_err_over_tol": worst[1] / worst[2],
            "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times[name]["library_ms"],
            "library_call": times[name]["library_call"],
            "shape": shape,
            # the same kernel at phase 9's shape (B*H 192)
            "at_llama_shape": {
                "shape": LLAMA_SHAPE, "ms": llama_times[name]["ms"],
                "plain_ms": llama_times[name]["plain_ms"],
                "library_ms": llama_times[name]["library_ms"], "bound_ms": llama_bound[0],
                "bound_by": llama_bound[1], "max_abs_err": max(c[1] for c in llama_checks[name])},
            # the D=64 instance the main path runs; registers at entry (the
            # wgmma kernels' consumers raise theirs with setmaxnreg)
            **{key: binary[(name, shape["D"])][key]
               for key in ("registers", "spill_stores", "hgmma", "utmaldg")},
        })
    print(json.dumps({"checkpoint": numbers}), flush=True)
    print(json.dumps({"tpurun": tpurun_times}), flush=True)
    print(json.dumps({"two_node": two_numbers}), flush=True)
    print(json.dumps({"shards": shard_numbers}), flush=True)
    print(json.dumps({"llama": llama_numbers}), flush=True)
    print(json.dumps({"restore_chain": chain_numbers}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
