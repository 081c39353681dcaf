#!/usr/bin/env python3
"""Runs the PyTorch port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result; the failing phase prints ``{"failed_phase": NAME,
"error": ..., "phase_seconds": ...}`` on a line of its own first):

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
   causal q_len > kv_len at a ragged kv_len, D=64 and D=128) and at phase
   11's local shapes (B=4 and 8, H=6, q, k and v views of one buffer) and at
   phase 12's (B=16, H=6: q its own tensor, k and v this rank's kv groups
   repeated to its heads, as Llama under tp makes them) and at phase 13's
   pipeline stage (B=2, H=12, q, k and v views of one buffer), and times
   kernel, plain version and ``scaled_dot_product_attention`` (the
   yardstick, never called by the port) with CUDA events at the training
   shape, at phase 9's, at phase 11's, at phase 12's and at phase 13's;
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
   an uninterrupted run of 24 steps in its own namespace (beside the next
   three trainers); a run that stages
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
   fresh job name, ``CKPT_DIR`` in a temporary directory, ``TOTAL_STEPS=24``
   and the CLI's default intervals: the launcher spawns the standalone
   master, the agent runs the saver and keeps a warm spare, and the worker
   trains GPT-2 small at full width. Run A is the command as typed (the
   spare on, the default); run B is the same launcher with
   ``ElasticLaunchConfig(warm_spare=False)`` (``chip_smoke.py
   --tpurun-no-spare <launcher arguments>``). Once the worker has staged
   step 10 or later (by step 18), this process SIGKILLs it (found through
   the agent's pidfile); to make that moment, it holds the worker's shard
   lock as a persister does around the worker's next storage step, reading
   the worker's place only while it is stopped by SIGSTOP
   (``_kill_window``), so that the staged step is at most one behind the
   last trained one (the harness sets that lag). The launcher must exit 0
   and the master with SUCCEEDED; the agent must restart the worker once
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
   the step time while a spare imports (the restarted worker's: the first
   worker's steps and stages, loaded and stepped by the kill window, are
   printed apart, ``worker0_harness_loaded``);
7. two nodes on one card: the port's master (``python3 -m
   dlrover_tpu_torch.master.main --num_workers 2 --port_file F``) and two
   agents started as a user starts them on two nodes, ``python3 -m
   dlrover_tpu_torch.launcher.elastic_run --nnodes 2 --node_rank r
   --nproc_per_node 1 -m dlrover_tpu_torch.examples.gpt_elastic --layers
   4``, with one ``DLROVER_MASTER_ADDR`` and ``DLROVER_JOB_NAME``, an IPC
   namespace each and warm spares on, 14 steps of GPT-2 small at its full
   width and 4 of its 12 layers (the phase checks the recovery of two
   nodes, not the model) at a global batch of 8 (4 a rank); each stage is also pushed to the peer's agent (peer replicas are
   on by default in a world of two). Both workers must report backend gloo (they share the GPU) and a
   world of 2, and only they may hold /dev/nvidia*. Once both have staged
   step 10 or later, this process SIGKILLs rank 1's worker: node 1's agent
   must restart it after the failure and node 0's agent its own worker
   (after its failure in the next collective, or on the membership
   change); both must resume at one agreed step (from memory, or from
   storage when their staged steps differ), every step's loss must be
   bit-equal on both ranks and within 1e-2 of the example at the same
   depth trained first in this process as an uninterrupted world of one,
   every step must launch 8/4/4 flash kernels, both ranks must
   end with equal state hashes, the agents and the master must exit 0 with
   SUCCEEDED, and no process and no shm segment of either namespace may be
   left. It reports the median step against that world of one's, the
   all-reduce's share of a step, both nodes' recovery in phase 6's
   columns, and each process's peak RSS;
8. sharded input on two nodes: phase 7's job, with the workers running
   this script's trainer role (``chip_smoke.py --trainer shards --data
   F --layers 4``) instead of the example: each writes (once, from seed 0)
   a token file of 512 samples of 1025 uint16 tokens, builds the example's
   model at GPT-2 small's width and 4 of its 12 layers (the phase checks
   shards and batches, not the model) and step on its mesh (fsdp over the
   world) from seed-0 weights,
   registers the file
   with the master through ``ShardingClient`` (batch 4, shuffled table
   shards of two batches: 64 shards of 8 samples) and trains 14 steps
   through ``ElasticTrainLoop`` (a stage every step, a persist every 5th)
   from an ``ElasticShardLoader`` that reads the rows of the file, logging
   each step's sample indices. Once both have staged step 10 or later,
   this process SIGKILLs rank 1's worker. Beyond phase 7's checks (gloo and
   a world of 2, 8/4/4 flash launches a step, losses bit-equal across the
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
   and peak memory, and the dense model's MFU. For phase 12 it keeps each
   variant's parameters after 3 steps, and trains each again as a world of
   one with dense attention for 3 steps: that update's relative L2 error
   from the flash run's (other bf16 roundings of the same function) is the
   yardstick printed beside phase 12's update errors;
10. the restore chain on two nodes of one card: phase 7's job (the
   example at 4 layers, a world of two over gloo, warm spares on), with peer replicas
   (on by default in a world of several hosts) and the durable tier
   (``DLROVER_DURABLE_DIR``, every 5th step, the newest 2 kept), every
   step staged as in phase 7, 17 steps. (a) Once a durable generation has
   committed, node 0's worker is stopped (SIGSTOP, counted only while its
   shard lock is free, so that no stage is in flight) at a staged step
   >= 10 (by step 14) that is no storage step and newer than storage's
   newest; node 1, which stages the same steps, then stages that step and
   waits in its next collective; node 0's worker stays stopped until
   node 0's agent holds node 1's replica of that step; then node 1's
   agent, worker and spare die by SIGKILL, node 0's worker continues,
   node 1's shm segments are unlinked and a new agent of node rank 1
   starts in a fresh IPC namespace: its worker must restore that step from node 0's memory
   (``peer``, the refill ``refilled``, a log line naming peer 0), node 0
   from its own shm; phase 7's checks hold (one agreed resume step,
   losses bit-equal across the ranks and within 1e-2 of phase 7's world
   of one, 8/4/4 launches a step, exit 0 and SUCCEEDED, nothing left
   behind), and every durable drain must write from the saver's buffer.
   (b) After the job, with at least two durable generations committed,
   every shm segment of the job unlinked and the flash storage deleted,
   the flagship command at 4 layers as a world of one on the same durable
   root and lineage must restore the newest committed generation (every
   shard's crc32 checked) and train on within 1e-2 of phase 7's world of
   one at 8/4/4 launches a step. It reports each replica push's GB/s and
   shard-lock hold, the fetch seconds, both nodes' recovery, the peak
   ``VmRSS`` of every process and the peak bytes in ``/dev/shm``, each
   durable drain's source, lock hold and write against phase 5's async
   stage block, the generation's bytes and the whole-pool restore's
   seconds;
11. parallel layouts on one card: the example's model and batches
   (``examples/gpt_elastic.build``, GPT-2 small at full width and 4 of its
   12 layers, global batch 8, seed 0, the head and CE fused in chunks of
   256 tokens, split over the vocabulary under tp) on meshes that split
   the parameters, each rank a process of this script (``--trainer
   layouts --layout NAME``) under the agent's env contract, sharing the
   card over gloo: (a) tp=2, 2 ranks, 3 steps; (b) fsdp=2 x tp=2, 4 ranks,
   3 steps; the two worlds run at once, so that their start-ups and host
   collectives overlap (their step times are taken beside each other). Every rank-step must launch 8/4/4 flash kernels (on each
   rank's 6 heads), the losses must be bit-equal across the ranks and
   within 1e-3 of the same trainer's world of one, each rank's update of its blocks over the run (its last
   parameters less its first) must be within a relative L2 error of 0.5
   of the update of the same blocks by the same model, step and batches
   trained first in this process as a world of one (a skipped or dropped
   update is 1), every parameter and
   moment must be its layout's block (a
   rank's state within 2% of the world of one's over the ranks), each
   rank stages only its blocks through a standalone engine on the mesh,
   the ranks' records together cover every leaf once, ``load_consistent``
   restores the staged step from memory hash-equal and the last step
   again gives the same loss, and one step of the example's own head
   (``ce_chunk=0``: the logits gathered over tp) from the seed-0 weights
   gives the first loss within 1e-3; the workers hold /dev/nvidia* and no
   process or shm segment is left. It prints the median step of each
   layout, the split of one step (fsdp gathers, reduce-scatters, tp
   all-reduces, the gather of the logits over tp, compute), peak device
   memory and state bytes a rank;
12. the Llama family's layouts on one card: phase 9's Llama-125M under tp=2
   (2 ranks) and its MoE under fsdp=2 x ep=2 (4 ranks, 2 experts a rank),
   flash, remat and the split CE, from seed-0 weights on phase 9's batch,
   each rank a process of this script (``--trainer llama_layouts --layout
   NAME``) sharing the card over gloo, 3 steps each, the two worlds at once
   as in phase 11. Phase 9 is their world
   of one (its losses, and its parameters after 3 steps): the losses must
   be bit-equal across the ranks and within 1e-3 of phase 9's, each rank's
   update of its blocks within a relative L2 error of 0.5 of phase 9's on
   the same blocks, every rank-step must launch 24/12/12 flash kernels (on
   each rank's 6 heads, or on all 12 at fsdp x ep) and every rank must hold
   less than the whole state. The MoE's ranks then stage their state and
   drain it as one durable generation (``checkpoint/durable/``; rank 0
   commits), and a world of one in this process calls ``warm_start(root,
   lineage, mesh)`` without a template: each rank's blocks cut out of the
   placed state must hash equal to what the rank held, and the state,
   copied into a model built afresh, must give phase 9's MoE loss of step 4
   within 1e-3 at 24/12/12 launches. It prints the median step of each
   layout and the split of one step (fsdp gathers, reduce-scatters, tp and
   ep all-reduces, the load-balance sums over the data axes, compute),
   peak device memory and state bytes a rank
   against the world of one's, and the warm start's read and placement
   seconds;
13. the pipeline axis and the DP -> PP trade on one card
   (``pipeline_phase``): GPT-2 small's pipelined tree
   (``models/gpt_pipeline.py``, 163,072,512 parameters with its untied
   head; flash, remat, seq 1024, global batch 8, seed 0) trains as a world
   of four at dp=4 (``--trainer pipeline --rung dp4``, its stages
   ``[1, 12, ...]``, each rank's 2 rows one microbatch) for 3 steps and
   stages step 3 to each rank's shm; the replanner
   (``parallel/replan.py``) plans the shrink to 2 devices from the tree's
   bytes, a dp=4 rank's peak and step and a memory cap between dp2's and
   dp1 x pp2's bytes a device, and must choose dp1 x pp2 with accum 4 as a
   trade that beats the accum-only rung; a world of two at dp1 x pp2
   (``--rung dp1pp2``) reads the first two ranks' images through
   ``load_resharded`` (every leaf bit-equal to the staged step), refolds
   the stages and their moments to ``[2, 6, ...]``, keeps its own and
   trains 4 steps with the global batch as 4 microbatches of 2 rows (GPipe
   over pp through gloo). The losses of both worlds must be bit-equal
   across their ranks and within 1e-3 of a world of one in this process,
   each dp1 x pp2 rank's update within 0.5 relative L2 of the world of
   one's, and every rank-step must launch each kernel for each microbatch
   of its stage's layers. It prints the median step of each rung and its
   split (pp sends and receives, the pp sum of the replicated leaves'
   gradients, the data all-reduce, compute), ``load_resharded``'s read and
   place seconds, the plan, peak device memory and state bytes a rank, and
   ``/dev/shm`` free before the phase and its peak use;
14. decode and serving (``serve_phase``; no flash kernel runs in it:
   decode attends over the KV cache with torch ops, as the JAX package
   does). (a) GPT-2 small's width at 4 layers in fp32 (TF32 off): a greedy
   decode of 8 left-padded prompts of 20-120 tokens for 32 tokens, each
   step's logits within 1e-4 of a teacher-forced forward without a cache
   (and of the same rows decoded alone), ``generate`` giving the same
   tokens; then 24 prompts through ``ContinuousBatchingEngine`` (8 slots,
   ``per_row``, overlapped), again in the ``frontier`` layout and in the
   synchronous round, each completion that prompt's one-shot greedy decode
   and the synchronous round identical to the overlapped one. A token that
   differs counts as a failure only where the reference's top-2 gap
   exceeds twice the measured logit difference (the excused tokens are
   printed). (b) The user's command, ``python3 -m
   dlrover_tpu_torch.launcher.serve --ckpt-dir <phase 5's storage>
   --config <GPT-2 small> --batch-size 8 --prompt-width 128
   --max-new-tokens 32 --temperature 0 --port 0``, as a child process: this
   process restores the same checkpoint through the serving restore (a
   params-only template), whose parameters must hash equal to what phase
   5's bench trainer persisted; its bf16 decode must stay within 2**-4 of
   the largest logit of the teacher-forced forward; then 24 concurrent
   completions over HTTP must equal this process's engine on the same
   weights (by the same rule), ``/v1/weights/reload`` must restore the
   same step, a streamed completion must equal its chunks and the engine,
   ``/healthz`` must count the requests, a bad prompt must give 400, and
   SIGTERM must stop the server with exit 0, leaving no process and no shm
   segment. (c) The int8 cache on the same weights, driven by the exact
   cache's tokens: every step's logits within a cosine of 0.999 of the
   exact cache's. (d) Llama-125M on phase 9's dense parameters after 3
   steps: its cache ``[8, 1024, 4, 64]`` a layer (KVH-narrow), a greedy
   decode held to its teacher-forced forward as in (b). It prints the
   ``serving`` line: decode ms a step at 8 slots (bf16 and int8 caches,
   and Llama's), the device's busy share of a step (CUDA events after a
   device sleep, so the step's launches are queued before it starts,
   against the host clock), prefill ms, cache bytes, the server's
   tokens/s, time to first token and latency p50/p95, and the phase's
   seconds.

Every phase prints its seconds as it ends, and the output has them all on
one line (``phase_seconds``) before the kernel line.

Phase 6 also times each async stage of its workers from the step to the
image in shm (seen by the 0.1 s sampler that watches the spares), beside
a persist of the agent or alone (the first worker's apart, as above).

The output ends with the checkpoint numbers, the ``tpurun`` timings, the
two-node numbers, the sharded-input numbers, the Llama numbers, the
restore-chain numbers, the layouts' numbers, the Llama layouts' numbers,
the pipeline's numbers, the serving numbers, the phases' seconds and the
kernel table as one
JSON line each, the card's
name and power limit, and ``{"ok": true, "device": {...}}`` as the last
line.

    python3 chip_smoke.py --multi-gpu-world

runs only the example as a world of one rank per GPU of a machine with
several (NCCL; ``multi_gpu_world``) for ``MULTI_GPU_STEPS`` steps,
restarts it whole to resume from memory, holds it against a world of one
and prints one JSON line; with four GPUs it also runs phase 11's fsdp=2 x
tp=2, the Llama MoE example at the JAX example's mesh (ep=4, 8
experts) and phase 13's pipelined tree at dp2 x pp2 over NCCL, each
against its world of one. ``--device cpu
--small`` rehearses it on the CPU as a world of two over gloo.
"""

import contextlib
import dataclasses
import functools
import hashlib
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
# phase 11's local shapes: GPT-2 small's 12 heads split over tp=2, at the
# batch of a rank of fsdp=2 x tp=2 (4) and of tp=2 (8); q, k and v are views
# of one buffer, as the model's einsum lays them out
LAYOUT_SHAPES = [dict(B=4, T=1024, H=6, D=64, causal=True),
                 dict(B=8, T=1024, H=6, D=64, causal=True)]
# phase 12's local shape of Llama-125M under tp=2: 6 of the 12 query heads at
# batch 16, q from its own einsum, k and v this rank's kv groups of the 4
# (rank 1: heads 6-11, groups 2-3) repeated to its heads, each its own
# tensor, as the model makes them (``llama.kv_groups``, ``llama.repeat_kv``)
LLAMA_TP_SHAPE = dict(B=16, T=1024, H=6, D=64, causal=True, kv_groups=4, heads=12, first_head=6)
# phase 13's stage: a microbatch of 2 rows, all 12 heads, q, k and v views
# of one buffer (the stage's einsum), at both rungs of the trade
PIPELINE_SHAPE = dict(B=2, T=1024, H=12, D=64, causal=True)
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


def flash_per_step(layers):
    """Flash launches of one train step of ``layers`` blocks under remat."""
    return {"fwd": 2 * layers, "bwd_dkdv": layers, "bwd_dq": layers}
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


def kernel_phase(fa, shape, gen, timed, qkv_views=False):
    """Kernels vs plain versions at one shape. Returns per-kernel checks and,
    when ``timed``, the timings. With ``qkv_views``, q, k and v are views of
    one ``[B, T, 3, H, D]`` buffer (row stride ``3*H*D``), the layout of the
    model's ``einsum("btd,dchk->cbthk")``. A shape with ``kv_groups`` is
    Llama's under tp: q its own tensor, k and v the kv groups of query
    heads ``first_head .. first_head + H`` (of ``heads`` over
    ``kv_groups`` groups) repeated to those heads in ``jnp.repeat``'s
    order, through the model's own ``kv_groups`` and ``repeat_kv``."""
    import torch
    import torch.nn.functional as F

    B, H, D, causal = (shape[k] for k in ("B", "H", "D", "causal"))
    t_q, t_kv = shape.get("Tq", shape.get("T")), shape.get("Tkv", shape.get("T"))
    dev = "cuda"

    def rand(t):
        return torch.randn((B, t, H, D), device=dev, generator=gen).to(torch.bfloat16)

    if qkv_views:
        q, k, v = torch.randn((B, t_q, 3, H, D), device=dev, generator=gen).to(
            torch.bfloat16).unbind(2)
        do = rand(t_q)
    elif "kv_groups" in shape:
        from dlrover_tpu_torch.models.llama import kv_groups, repeat_kv

        rep = shape["heads"] // shape["kv_groups"]
        g0, g1, offset = kv_groups(shape["first_head"], H, rep)

        def repeated():
            g = torch.randn((B, t_kv, g1 - g0, D), device=dev, generator=gen).to(torch.bfloat16)
            return repeat_kv(g, rep, offset, H)

        q, k, v, do = rand(t_q), repeated(), repeated(), rand(t_q)
    else:
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

    def plain_ms(fn):
        # the plain versions take milliseconds a call: fewer calls suffice
        return time_ms(fn, warmup=1, samples=5, reps=2)

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    do_t = do.transpose(1, 2)
    times = {
        "fwd": dict(
            ms=time_ms(lambda: fa.flash_fwd_cuda(q, k, v, scale, causal)),
            plain_ms=plain_ms(plain_fwd),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), is_causal=causal)),
            library_call="torch.nn.functional.scaled_dot_product_attention (forward)",
        ),
        "bwd_dkdv": dict(
            ms=time_ms(lambda: fa.flash_bwd_dkdv_cuda(*args)),
            plain_ms=plain_ms(lambda: fa.flash_bwd_dkdv_plain(*plain_args, *blocks)),
        ),
        "bwd_dq": dict(
            ms=time_ms(lambda: fa.flash_bwd_dq_cuda(*args)),
            plain_ms=plain_ms(lambda: fa.flash_bwd_dq_plain(*plain_args, *blocks)),
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
TPURUN_STEPS = 24
STORAGE_EVERY = 5    # storage steps 0, 5, 10; every step is staged to shm
KILL_AT = 7          # the killed trainer dies after staging this step
HASH_AT = 10         # the resumed trainer's last storage step
RESUME_LOSS_TOL = 1e-2
BENCH_STEP = 1000    # first step number of the timed saves
LOOP_BENCH_STEPS = 10


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
    from dlrover_tpu_torch.common.log import write_line

    write_line("RESULT " + json.dumps(result))


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
    # phase 14 serves this step: its parameters' hash
    persisted = {"step": step, "params_sha256": params_sha256(state.params)}
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
        "persisted": persisted,
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
    os.makedirs(work, exist_ok=True)

    if n_params is not None:
        image = 12 * n_params + 16  # fp32 params, mu and nu; step and count
        free = shutil.disk_usage("/dev/shm").free
        log(f"  /dev/shm free {free} bytes; one image {image} bytes (+ its JSON meta); "
            f"two images at once (the reference trainer stages its own); cuts: none")
        if free < 2.1 * image:
            raise AssertionError("/dev/shm cannot hold two images of the train state")

    def start(role, namespace=None, root=ckpt):
        env = dict(os.environ)
        if namespace:
            env["DLROVER_IPC_NAMESPACE"] = namespace
        cmd = [sys.executable, os.path.abspath(__file__), "--trainer", role, "--ckpt", root,
               "--device", device] + (["--small"] if small else [])
        # files, not pipes: a trainer that runs beside others never blocks on
        # a full pipe
        paths = [os.path.join(work, f"trainer_{role}.{ext}") for ext in ("out", "err")]
        with open(paths[0], "w") as out, open(paths[1], "w") as err:
            proc = subprocess.Popen(cmd, stdout=out, stderr=err, env=env,
                                    cwd=os.path.dirname(os.path.abspath(__file__)))
        return role, time.perf_counter(), proc, paths

    def result_of(started, expect_kill=False):
        role, t0, proc, paths = started
        try:
            proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            raise AssertionError(f"trainer {role} timed out after {timeout} s")
        with open(paths[0]) as f_out, open(paths[1]) as f_err:
            out, err = f_out.read(), f_err.read()
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        ok_rc = -signal.SIGKILL if expect_kill else 0
        if proc.returncode != ok_rc or not lines:
            raise AssertionError(f"trainer {role} exited {proc.returncode}:\n{err[-4000:]}")
        log(f"  trainer {role}: {time.perf_counter() - t0:.1f} s, exit {proc.returncode}")
        return json.loads(lines[-1][len("RESULT "):])

    def child(role, expect_kill=False):
        return result_of(start(role), expect_kill)

    AsyncCheckpointSaver.start_async_saving_ckpt()
    reference = None
    try:
        # the uninterrupted reference runs beside the kill, resume and restore
        # trainers: its own IPC namespace (its own in-process saver), shm
        # segment and storage
        reference = start("reference", namespace=f"{job}_ref", root=ref_ckpt)
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
        ref, reference = result_of(reference), None
        log(f"  uninterrupted losses {ref['losses']}")
        _check(ref["steps"] == TPURUN_STEPS and ref["restored_step"] == -1, f"reference run {ref}")
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
        if reference is not None and reference[2].poll() is None:
            reference[2].kill()
            reference[2].wait(30)
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


RECORD = "gpt_elastic "


def _emit_record(event, **fields):
    """One ``gpt_elastic {json}`` record line of this process, written whole
    (``common/log.write_line``: the line and its newline in one write)."""
    from dlrover_tpu_torch.common.log import write_line

    write_line(RECORD + json.dumps({"event": event, "pid": os.getpid(), **fields}))


def _records_in(line):
    """The records of one line of output: each ``gpt_elastic {json}`` in it.
    A writer killed in the middle of a record leaves it without its end and
    its newline, and the next process's record continues the same line; so
    the line is split at each record's start, and a fragment that does not
    parse is left out."""
    out = []
    for part in line.split(RECORD + "{")[1:]:
        try:
            out.append(json.loads("{" + part))
        except ValueError:
            log(f"  a torn record left out: {part[:200]!r}")
    return out


class _JobOutput:
    """Both pipes of the job, read on two threads: every line, the
    example's records (``gpt_elastic {json}``) and the agent's recovery
    records (``agent recovery: {json}``). Each thread reads its pipe's file
    descriptor itself and takes a chunk and its lines under one lock, so
    :meth:`drained` can tell when every byte written so far has been read."""

    def __init__(self, proc):
        import threading

        self.lock = threading.Lock()
        self.lines, self.records, self.recoveries = [], [], []
        self._fds = [proc.stdout.fileno(), proc.stderr.fileno()]
        self.threads = [threading.Thread(target=self._read, args=(fd,), daemon=True)
                        for fd in self._fds]
        for t in self.threads:
            t.start()

    def _read(self, fd):
        import select

        rest = b""
        while True:
            if not select.select([fd], [], [], 0.05)[0]:
                continue
            with self.lock:
                chunk = os.read(fd, 1 << 16)
                *lines, rest = (rest + chunk).split(b"\n")
                if not chunk:
                    lines, rest = ([rest] if rest else []), b""
                for raw in lines:
                    self._line(raw.decode(errors="replace").rstrip("\r"))
            if not chunk:
                return

    def _line(self, line):
        self.lines.append(line)
        self.records.extend(_records_in(line))
        m = re.search(r"agent recovery: (\{.*\})", line)
        if m:
            try:
                self.recoveries.append(json.loads(m.group(1)))
            except ValueError:  # a torn line: the rest of it is still read
                log(f"  a torn recovery record: {line[:200]!r}")

    def drained(self):
        """Every byte written to both pipes so far has been read into lines
        (none is waiting in a pipe): with a writer stopped, its last line is
        here."""
        import fcntl
        import termios

        with self.lock:
            return all(not int.from_bytes(fcntl.ioctl(fd, termios.FIONREAD, b"\0" * 4), "little")
                       for fd in self._fds)

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


def _example_world(work, job, n, total_steps, example_args, timeout, gpu_per_rank=False,
                   entry=None, on_poll=None, extra_env=None):
    """Run the example (or the script ``entry``, a list of arguments after
    the interpreter) as a world of ``n`` processes with the agent's env
    contract and no agent or master (rank r on GPU r with
    ``gpu_per_rank``); each rank's records. Rank r's job name is
    ``{job}_{r}``: the caller unlinks its shm segments. Each rank writes
    its output to ``{job}_rank{r}.out`` and ``.err`` in ``work``, so no
    rank blocks on a full pipe; the first rank to fail ends the world.
    ``on_poll(procs)`` runs every 0.1 s while the world runs; ``extra_env``
    is added to every rank's env."""
    from dlrover_tpu_torch.agent.rendezvous import find_free_port

    coordinator = f"127.0.0.1:{find_free_port('127.0.0.1')}"
    procs, paths = [], []
    for r in range(n):
        env = dict(os.environ, DLROVER_JOB_NAME=f"{job}_{r}", CKPT_DIR=os.path.join(work, f"{job}_ckpt"),
                   TOTAL_STEPS=str(total_steps), DLROVER_IPC_DIR=os.path.join(work, f"{job}_sockets{r}"),
                   **(extra_env or {}))
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
                [sys.executable] + (entry or ["-m", "dlrover_tpu_torch.examples.gpt_elastic"])
                + example_args,
                stdout=out, stderr=err, env=env, cwd=os.path.dirname(os.path.abspath(__file__))))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if on_poll is not None:
                on_poll(procs)
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
            records.append([r for ln in f for r in _records_in(ln)])
    return records


def _gpu_world(work, job, n, total_steps, args, timeout, entry, extra_env=None,
               gpu_per_rank=False):
    """``_example_world`` of ``entry`` that also unlinks the world's shm
    segments and notes which ranks held /dev/nvidia* while they ran:
    (records, {rank: the fds seen}, segments left behind, seconds)."""
    held = {}

    def poll(procs):
        for r, p in enumerate(procs):
            if p.poll() is None and not held.get(r):
                held[r] = _nvidia_fds(p.pid)

    t0 = time.perf_counter()
    try:
        recs = _example_world(work, job, n, total_steps, args, timeout, gpu_per_rank=gpu_per_rank,
                              entry=entry, on_poll=poll, extra_env=extra_env)
        left = [s for s in os.listdir("/dev/shm") if s.startswith(f"dlrover_{job}_")]
    finally:
        _unlink_job_segments([f"{job}_"])
    return recs, held, left, time.perf_counter() - t0


def _at_once(calls):
    """{name: fn()} for ``calls`` ({name: fn}), run at once on threads so
    that one world's start-up and host collectives overlap another's; the
    first failure raises once every call has ended."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        futures = {name: pool.submit(fn) for name, fn in calls.items()}
    return {name: f.result() for name, f in futures.items()}


def _unlink_job_segments(prefixes):
    for name in os.listdir("/dev/shm"):
        if any(name.startswith(f"dlrover_{p}") for p in prefixes):
            os.unlink(os.path.join("/dev/shm", name))


def _step_losses(records):
    return {x["step"]: x["loss"] for x in records if x["event"] == "step"}


def _example_world_of_one(small, device, steps, layers=None):
    """The example's seed-0 model (at ``layers`` blocks) trained in this
    process as a world of one on its global batches for ``steps`` steps:
    ({step (as a string): loss}, the median step's seconds after the
    first)."""
    import torch

    from dlrover_tpu_torch.examples import gpt_elastic

    _, state, step_fn, batches = gpt_elastic.build(small, torch.device(device), layers=layers)
    losses, seconds = {}, []
    for s, (x, y) in enumerate(batches(0, steps)):
        t0 = time.perf_counter()
        state, loss = step_fn(state, x.to(device), y.to(device))
        losses[str(s)] = float(loss)  # waits for the step
        seconds.append(time.perf_counter() - t0)
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    return losses, statistics.median(seconds[1:] or seconds)


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


# parts of a step record that lie inside its forward and backward parts
COLLECTIVE_PARTS = ("gather_s", "reduce_scatter_s", "tp_s", "tp_logits_s", "ep_s", "moe_aux_s",
                    "pp_s", "ring_s", "sp_loss_s")


def _step_parts(x):
    """The ``*_s`` parts of a ``first_step``/``second_step`` record."""
    return {k: v for k, v in x.items() if k.endswith("_s")}


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


_WINDOW_OWNER = f"chip_smoke_window_{os.getpid()}"


# the longest a stopped worker's records take to reach this process
_RECORD_DRAIN_S = 10.0


def _stop_and_drain(pid, out, deadline=None):
    """SIGSTOP ``pid``, wait until it is stopped and until this process has
    read every byte the job's pipes hold (``_JobOutput.drained``): the
    worker writes its records into the launcher's pipe, so its last record
    is then in ``out``, whatever the load on the machine."""
    import signal

    os.kill(pid, signal.SIGSTOP)
    _wait_stopped(pid)
    until = time.monotonic() + _RECORD_DRAIN_S
    while not out.drained():
        if time.monotonic() > min(until, deadline or until):
            raise AssertionError(f"the job's pipes did not drain within {_RECORD_DRAIN_S} s")
        time.sleep(0.001)


@contextlib.contextmanager
def _busy_card(device):
    """Keep the card busy from this process (back-to-back bf16 matmuls on a
    thread) for the body: the worker's steps, which wait on the card, slow
    down while its stages, copies on the host, do not. No-op on the CPU."""
    if device != "cuda":
        yield
        return
    import threading

    import torch

    stop = threading.Event()

    def spin():
        a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
        b = torch.empty_like(a)
        while not stop.is_set():
            for _ in range(8):
                torch.matmul(a, a, out=b)
            torch.cuda.synchronize()

    thread = threading.Thread(target=spin, name="busy-card", daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join(30)


def _kill_window(lock, out, pid, shm, wait_for, device="cuda"):
    """Make phase 6's kill window at a storage step T of the worker (one its
    save waits for the shard lock at) by holding that lock as a persister
    does, with the worker stopped (SIGSTOP) whenever this process reads its
    place: its records reach this process through the launcher's pipe, so
    only a stopped worker's last record, read once the pipes have drained
    (``_stop_and_drain``), says where it is.

    1. Once the stage of storage step 10 has landed (its lock is handed on
       to the saver, so the worker holds none) and the worker has recorded
       that step (so its SAVE event is queued), stop the worker; when the
       saver has persisted that step, take the lock: the worker's stages
       are skipped from then on. Until that stage lands this process keeps
       the card busy (``_busy_card``), so that the worker, whose steps wait
       on the card, records at most step 12 by then.
    2. Step the worker (a short SIGCONT, then SIGSTOP and a look) until its
       last record is T - 3 of a storage step T.
    3. Let go of the lock and continue the worker: its next stage is of T -
       2 (or of T - 1, when it had tried T - 2 already), and this process
       asks for the lock while that stage holds it, so that it takes the
       lock back when the stage lands, ahead of the worker's save at T. The worker then records at
       most T - 1 before its save at T waits for the lock, so the staged
       step stays at most one behind the last recorded one until the kill:
       the harness sets that lag, the kill does not observe it.

    A stage (about 0.2 s on the card) outlasts a step (0.08-0.1 s), so
    without the window the stage of a step lands two or three steps later
    and the kill's condition holds only when a step happens to be slow.
    Returns T with the lock held and the worker running (the caller
    releases the lock after the kill), or None with the lock released and
    the worker running when the worker stepped past the last usable window
    (the caller then waits for the condition as before). It logs where it
    stopped the worker."""
    import signal

    from dlrover_tpu_torch.examples.gpt_elastic import STORAGE_EVERY as every

    def last():
        steps = out.events("step", pid)
        return steps[-1]["step"] if steps else -1

    def staged():
        meta = shm.read_meta()
        return -1 if meta is None else meta.step

    def stop():
        _stop_and_drain(pid, out)
        return last()

    def persisted(step):
        return any(int(m.group(1)) == step for m in out.grep(r"persisted step (\d+): "))

    def step_to(target):
        s = stop()
        while s < target:
            os.kill(pid, signal.SIGCONT)
            time.sleep(0.01)
            s = stop()
        return s

    first = -(-TPURUN_KILL_AFTER // every) * every
    with _busy_card(device):
        wait_for(f"the stage of storage step {first}", lambda: staged() >= first, poll=0.002)
        # the worker queues the saver's SAVE event of a storage step after
        # the save returns, and records the step after that: a worker
        # stopped before its record of that step may not have asked for the
        # persist yet (a stage on the CPU can land first)
        s = step_to(first)
    log(f"  kill window: the worker stopped at step {s} when the stage of step {first} landed")
    try:
        wait_for(f"the persist of step {first}", lambda: persisted(first), poll=0.01)
        _check(lock.call("acquire", _wait_s=60.0, owner=_WINDOW_OWNER, blocking=True,
                         timeout=30.0), "the shard lock was not free within 30 s")
        t = -(-(s + 3) // every) * every  # the first storage step T with T - 3 >= s
        while s < t - 3:
            s = step_to(s + 1)
            if s > t - 3:  # past the window: the next storage step's
                t += every
        if t - 2 > TPURUN_KILL_BY:
            lock.call("release", owner=_WINDOW_OWNER)
            return None
        lock.call("release", owner=_WINDOW_OWNER)
    finally:
        os.kill(pid, signal.SIGCONT)
    # ask for the lock while that stage holds it: this process then gets it
    # when the stage lets go, before the worker's save at T asks
    wait_for(f"the stage of step {t - 2} or {t - 1}",
             lambda: lock.call("locked") or staged() >= t - 2, poll=0.002)
    _check(lock.call("acquire", _wait_s=60.0, owner=_WINDOW_OWNER, blocking=True, timeout=30.0),
           "the shard lock was not free within 30 s")
    if staged() in (t - 2, t - 1):
        return t
    lock.call("release", owner=_WINDOW_OWNER)
    return None


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
    lock = None  # phase 6's client of the worker's shard lock (_kill_window)

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
        lock = _lock_client(job, ipc_dir, 0)
        window = _kill_window(lock, out, boot0["pid"], shm, wait_for, device)
        while True:
            wait_for(f"a staged step >= {TPURUN_KILL_AFTER}", staged_and_computing_next)
            # Freeze the worker and look again: a step that finished between
            # the look and the kill (a step takes 0.06-0.1 s) would be redone.
            _stop_and_drain(worker_pid, out)
            frozen = staged_and_computing_next()
            if frozen is not None:
                meta, last = frozen
                break
            os.kill(worker_pid, signal.SIGCONT)
        at_kill = {"staged": meta.step, "trained": last, "spares": watch.ready_spares(),
                   "window": window}
        t_kill = time.time()
        os.kill(worker_pid, signal.SIGKILL)
        if window is not None:
            lock.call("release", owner=_WINDOW_OWNER)  # the agent's breakpoint save takes it next
        log(f"  SIGKILLed worker pid {worker_pid} with step {meta.step} staged, step {last} "
            f"trained; ready spares {[r['pid'] for r in at_kill['spares']]}; kill window at "
            f"storage step {window}")
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
        if lock is not None:
            lock.close()
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
    # each async stage's time to land in shm, beside a persist or alone
    stages = {name: _stage_timings(watch.landed, steps, out.lines, until)
              for name, steps, until in (("worker0", steps0, t_kill), ("worker1", steps1, None))}
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
                 "lag_steps": at_kill["trained"] - at_kill["staged"],
                 "window_storage_step": at_kill["window"]},
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
        # the job's own steps and stages: the restarted worker's
        "step_s": {"worker1": step_split["worker1"]},
        "stages": {"worker1": stages["worker1"]},
        # the first worker's, until the kill: the kill window (_kill_window)
        # loads the card from the harness and steps the worker by SIGSTOP and
        # SIGCONT, so these are not the job's own
        "worker0_harness_loaded": {"step_s": step_split["worker0"], "stages": stages["worker0"]},
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
# phases 7 and 8 run 14 steps: the kill after step 10, then 3 or 4 resumed
# steps
TWO_NODE_STEPS = 14
# phases 7, 8 and 10 check the recovery of two nodes, not the model: GPT-2
# small's width at 4 of its 12 layers (the small model keeps its 2), each
# against a world of one at the same depth
TWO_NODE_LAYERS = 4
TWO_NODE = ["-m", "dlrover_tpu_torch.launcher.elastic_run", "--nnodes", "2", "--node_rank", None,
            "--nproc_per_node", "1"]
EXAMPLE = ["-m", "dlrover_tpu_torch.examples.gpt_elastic"]


def _example_entry(layers):
    """The example's command at ``layers`` blocks (None: its own depth)."""
    return EXAMPLE + ([] if layers is None else ["--layers", str(layers)])


def _per_step(layers):
    """Flash launches of one train step at ``layers`` blocks (None: 12)."""
    return FLASH_PER_STEP if layers is None else flash_per_step(layers)


def _two_node_job(work, job, entry, device, small, total_steps, kill_after, timeout, job_log,
                  after_resume=None, replace_node=False, env=None, kill_gate=None, kill_by=None,
                  per_step=FLASH_PER_STEP):
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
    node), one agreed resume step from one rung, ``per_step`` flash launches
    a step on the card, losses finite and bit-equal across the ranks, the
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
    steps, launches = {}, {k: 0 for k in per_step}
    bad_launches = []
    for r in (0, 1):
        for inc, boot in enumerate((first[r], second[r])):
            steps[(inc, r)] = {x["step"]: x for x in steps_of(r if inc == 0 else node_out[r],
                                                              boot["pid"])}
            for x in steps[(inc, r)].values():
                for k in launches:
                    launches[k] += x["launches"][k]
                if device == "cuda" and x["launches"] != per_step:
                    bad_launches.append((r, x["step"], x["launches"]))
    _check(not bad_launches,
          f"steps with other flash launches than {per_step}: {bad_launches[:3]}")
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


def two_node_phase(work, job, device="cuda", small=False, total_steps=TWO_NODE_STEPS,
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
    layers = None if small else TWO_NODE_LAYERS
    j = _two_node_job(work, job, _example_entry(layers), device, small, total_steps, kill_after,
                      timeout, job_log, per_step=_per_step(layers))
    diffs = {}
    for by_step in j["steps"].values():
        for s, x in by_step.items():
            diffs[s] = max(diffs.get(s, 0.0), abs(x["loss"] - reference[str(s)]))
    max_diff = max(diffs.values())
    _check(max_diff <= loss_tol, f"losses differ from the uninterrupted run by {max_diff}")

    def share(x):
        parts = _step_parts(x)
        step_s = sum(v for k, v in parts.items() if k not in COLLECTIVE_PARTS)
        collective_s = sum(parts.get(k, 0.0) for k in ("all_reduce_s",) + COLLECTIVE_PARTS)
        return {"all_reduce_s": parts.get("all_reduce_s"), "gather_s": parts.get("gather_s"),
                "reduce_scatter_s": parts.get("reduce_scatter_s"), "step_s": step_s,
                "share": collective_s / step_s}

    numbers = _two_node_numbers(j, card, small, total_steps)
    numbers["layers"] = layers
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
# phase 8 checks shards and batches, not the model: phase 7's depth, its
# world of one the same
SHARD_LAYERS = TWO_NODE_LAYERS
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
    step on the example's mesh (fsdp over the world), registers ``FILE``
    (written from seed 0 if absent)
    as a dataset of SHARD_SAMPLES samples through ``ShardingClient`` and
    trains from an ``ElasticShardLoader`` through ``ElasticTrainLoop`` (a
    stage every step, a persist every 5th). It prints the example's records
    (``gpt_elastic {json}``), each ``step`` with the sample indices it trained
    and the training thread's wait for its batch, and one ``shard`` record
    for each task the master handed out (with the RPC's seconds and the
    client's node id) and ``shard_done`` for each reported done."""

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

    emit = _emit_record  # one write a line: the prefetch thread prints too

    t_imported = time.time()
    total_steps = int(os.environ.get("TOTAL_STEPS", str(TPURUN_STEPS)))
    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32()
        torch.empty(1, device=device)
    t_cuda = time.time()
    ctx = elastic_context(device=device)
    mesh = build_mesh(choose_mesh_shape(ctx.world_device_count(), tp=1))  # the example's fsdp
    t_world = time.time()
    engine = CheckpointEngine(os.environ.get("CKPT_DIR", os.path.join(
        tempfile.gettempdir(), "shard_trainer_ckpt")), mesh=mesh)
    t_engine = time.time()
    if device.type == "cuda":
        fa._lib()
    t_lib = time.time()
    cfg, state, inner_step, _ = gpt_elastic.build(args.small, device, mesh, layers=args.layers)
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
         world_size=ctx.num_processes, world=mesh.size, rank=ctx.process_id, backend=ctx.backend,
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
    final_hash = gpt_elastic.state_hash(state, mesh)  # a collective: before the world goes down
    engine.close()
    ctx.shutdown()
    emit("done", steps=total_steps, rank=ctx.process_id, skipped=dict(engine.skipped_stages),
         state_hash=final_hash)
    return 0


def _world_of_one(small, device, data, global_batches, layers=None):
    """{step: loss} of the example's seed-0 model (at ``layers`` blocks)
    trained in this process, as a world of one, on ``global_batches``
    ([(step, sample indices)] in order) read from the token file
    ``data``."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.examples import gpt_elastic

    cfg, state, step_fn, _ = gpt_elastic.build(small, torch.device(device), layers=layers)
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


def shard_phase(work, job, device="cuda", small=False, total_steps=TWO_NODE_STEPS,
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
    layers = None if small else SHARD_LAYERS
    entry = [os.path.abspath(__file__), "--trainer", "shards", "--data", data] + (
        [] if layers is None else ["--layers", str(layers)])

    def read_checkpoint(addr):
        return json.loads(MasterClient(addr, node_id=-1).get_shard_checkpoint(SHARD_DATASET))

    j = _two_node_job(work, job, entry, device, small, total_steps, kill_after, timeout, job_log,
                      after_resume=read_checkpoint,
                      per_step=_per_step(layers))
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
                                                    for s in sorted(committed)], layers)
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
    numbers["layers"] = layers
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


def llama_phase(work, job, device="cuda", small=False, steps=LLAMA_STEPS, keep_dir=None):
    """Phase 9: Llama-125M and its MoE variant, each ``steps`` steps from
    seed-0 weights on one seeded batch through ``init_train_state`` /
    ``build_train_step`` (AdamW from ``default_optimizer()``, the MoE
    load-balance term at ``aux_loss_weight`` 0.01). The MoE state after step
    ``steps - 2`` is staged to shm through a standalone ``CheckpointEngine``
    under DLROVER_JOB_NAME ``job`` (sockets and storage under ``work``), and
    restored into a model built afresh. With ``keep_dir``, each variant's
    parameters after ``LLAMA_LAYOUT_STEPS`` steps are saved there
    (``{variant}_params_{steps}.pt``): phase 12's world of one; and the
    variant's update against a dense-attention twin's
    (``dense_twin_update``, ``_dense_twin_update``). Raises on
    the first failed check; returns the phase's numbers. The environment and
    socket directory it sets are restored on return, and the job's shm
    segments unlinked."""
    try:
        with _job_ipc(work, job):
            return _llama_phase(work, device, small, steps, keep_dir)
    finally:
        _unlink_job_segments([job])


def _llama_phase(work, device, small, steps, keep_dir=None):
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
        keep = keep_dir and os.path.join(keep_dir, f"{label}_params_{LLAMA_LAYOUT_STEPS}.pt")
        out[label] = _llama_variant(cfg, tokens, targets, device, steps, work, keep)
        if cuda:
            torch.cuda.empty_cache()
        if keep:
            out[label]["dense_twin_update"] = _dense_twin_update(cfg, tokens, targets, device, keep)
            if cuda:
                torch.cuda.empty_cache()
        log(f"  {label}: " + json.dumps(out[label]))
    return out


def _dense_twin_update(cfg, tokens, targets, device, keep):
    """Phase 12's yardstick for its updates: the same model, seed, batch and
    step as a world of one with dense attention instead of the flash
    kernels (the same function, other bf16 roundings), trained
    ``LLAMA_LAYOUT_STEPS`` steps, its update held to the flash run's saved
    at ``keep`` as ``_update_error`` holds a layout rank's; and its
    seconds."""
    import dataclasses

    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.parallel import train_step

    t0 = time.perf_counter()
    model = llama.Llama(dataclasses.replace(cfg, attention_impl="dense"), device=device, seed=0)
    tx = train_step.default_optimizer()
    state = train_step.init_train_state(model, tokens, tx, device=device, seed=0)
    start = {n: p.detach().cpu().clone() for n, p in state.params.items()}
    step_fn = train_step.build_train_step(model, tx, llama.llama_loss)
    for _ in range(LLAMA_LAYOUT_STEPS):
        state, loss = step_fn(state, tokens, targets)
    _check(math.isfinite(float(loss)), f"the dense twin's loss {float(loss)}")
    return dict(_update_error(state.params, start, keep), seconds=time.perf_counter() - t0)


def _llama_variant(cfg, tokens, targets, device, steps, work, keep=None):
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
            if keep and i + 1 == LLAMA_LAYOUT_STEPS:
                torch.save({n: p.detach().cpu() for n, p in state.params.items()}, keep)
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

CHAIN_STEPS = 17
CHAIN_KILL_AFTER = 10
# node 1 dies at a step that leaves a durable step (15) after the resume
CHAIN_KILL_BY = 14
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
    layers = None if small else TWO_NODE_LAYERS
    per_step = _per_step(layers)
    j = _two_node_job(work, job, _example_entry(layers), device, small, total_steps, kill_after,
                      timeout, job_log, replace_node=True, env=env, per_step=per_step,
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
    extra = ["--device", "cpu", "--small"] if small else ["--layers", str(layers)]
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
           if device == "cuda" and x["launches"] != per_step]
    _check(not bad, f"world-of-one steps with other flash launches than {per_step}: {bad}")
    _check(not leaked and not segments, f"left behind: processes {leaked}, segments {segments}")

    rec0 = j["recs"][0]
    new_boot, new_resume = j["second"][1], j["resume_records"][1]
    new_first = outs[1].events("step", new_boot["pid"])[0]
    t_kill = j["t_kill"]
    numbers = {
        "card": card, "model": "gpt2-small" if not small else "small", "layers": layers,
        "steps": total_steps, "durable": CHAIN_DURABLE, "kill": j["at_kill"],
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
                                    for k in per_step}},
        "job_s": j["t_end"] - j["t_launch"],
    }
    facts = {"resumed_step": j["resumed"], "restored_from": j["sources"],
             "storage_step_at_kill": storage_step, "max_loss_diff": max_diff,
             "pool_restored_step": newest, "pool_max_loss_diff": pool_diff,
             "state_hash": j["state_hash"]}
    return facts, numbers


# -- phase 11: parallel layouts on one card -------------------------------------
#
# The flagship's model and batches on meshes that split the parameters: tp
# over the heads, the MLP's columns and the vocabulary, and fsdp x tp; and on
# one that also splits the sequence, sp x tp, through ring attention (no
# flash kernel). The ranks share the card over gloo (``--multi-gpu-world``
# runs fsdp x tp and sp x tp over NCCL, one GPU a rank). Each rank is
# ``chip_smoke.py --trainer layouts``
# under the agent's env contract, with no agent: it stages through a
# standalone engine of its own.

# name: (fsdp, tp, sp, steps)
LAYOUTS = {"tp2": (1, 2, 1, 3), "fsdp2_tp2": (2, 2, 1, 3), "sp2_tp2": (1, 2, 2, 3)}
# the layouts trainers' depth at GPT-2 small's width, by --small (4 of its 12
# layers: the tp sums of 12 layers through the host were most of the phase)
LAYOUT_LAYERS = {False: 4, True: None}
# losses against the world of one: the readings are under 2e-4, and the
# optimizer (warmup over 100 steps to 3e-4) moves the loss far less than
# 1e-2 in 10 steps, so the loss checks the forward more than the update
LAYOUT_LOSS_TOL = 1e-3
# a rank's update of its blocks (final - initial parameters) against the
# world of one's on the same blocks after the same steps, as a relative L2
# error over all blocks and over each leaf: a skipped or dropped update is 1
LAYOUT_UPDATE_TOL = 0.5
LAYOUT_SPLIT_STEP = 1  # the step whose parts the trainers time
# the head fused with the CE in sequence chunks (split over the vocabulary
# under tp: no gather of the logits), by --small
LAYOUT_CE_CHUNK = {False: 256, True: 16}
# a rank's parameters and moments against the world of one's over the ranks
# that split them (sp replicates them):
# the leaves a mesh axis does not split (LayerNorms, wpe under tp, b1 under
# fsdp) are under 1% of GPT-2 small
LAYOUT_BYTES_SLACK = 1.02


def _split_marks(split, device):
    """The train step's ``mark`` for one step: the seconds of each part into
    ``split`` (``{part}_s``), each part ending at a device synchronisation,
    and the collectives' seconds (``mark(part, seconds)``) as they come."""
    import torch

    stamp = [time.perf_counter()]

    def mark(part, seconds=None):
        if seconds is not None:
            split[part + "_s"] = split.get(part + "_s", 0.0) + seconds
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        split[part + "_s"] = split.get(part + "_s", 0.0) + now - stamp[0]
        stamp[0] = now

    return mark


def _local_hash(state) -> str:
    """SHA-256 of this process's blocks (no collective)."""
    from dlrover_tpu_torch.examples import gpt_elastic

    return gpt_elastic.state_hash(state)


def _update_error(params, start, path):
    """How far this rank's update of its blocks (``params`` less ``start``,
    its parameters before the first step) is from the world of one's on the
    same blocks (its whole parameters after as many steps, saved at
    ``path``): the relative L2 error over all blocks, and the leaf where it
    is largest. A skipped or dropped update gives 1. A tensor without a
    layout is its whole leaf."""
    import torch

    whole = torch.load(path, map_location="cpu", mmap=True)
    num = den = 0.0
    worst = (0.0, None)
    for name, p in params.items():
        layout = getattr(p, "shard_layout", None)
        block = () if layout is None else layout.slices()
        want = (whole[name][block] - start[name]).double()
        err = float((p.detach().cpu().double() - start[name] - want).square().sum())
        norm = float(want.square().sum())
        num, den = num + err, den + norm
        worst = max(worst, (math.sqrt(err / norm) if norm else (math.inf if err else 0.0), name))
    return {"rel_err": math.sqrt(num / den), "worst_rel_err": worst[0], "worst_leaf": worst[1]}


def layouts_trainer(args) -> int:
    """One rank of phase 11 (``--trainer layouts --layout NAME``): the
    flagship's model (``examples/gpt_elastic.build``: GPT-2 small at full
    width, or the small model) on the mesh ``LAYOUTS[NAME]`` of the world in
    its env contract, trained on the example's batches (the global batch of
    step s from seed s, this rank's rows). It checks that every parameter
    and moment is its layout's block, prints each step's loss, time and
    flash launches, times the parts of step ``LAYOUT_SPLIT_STEP`` (gather,
    reduce-scatter, tp all-reduce, by device synchronisations), stages
    the state after step ``steps - 2`` to shm through a standalone
    ``CheckpointEngine`` on the mesh, restores it with ``load_consistent``
    after the last step, and steps that step again; then it takes one step
    of the example's own head (``ce_chunk=0``, the logits gathered over tp)
    from the seed-0 weights on the first batch, timing its parts; it prints
    its records, its state's bytes and its peak device memory. Records are
    JSON lines prefixed ``gpt_elastic``, as the example's."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.common.platform import resolve_device, strict_fp32
    from dlrover_tpu_torch.examples import gpt_elastic
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.elastic import elastic_context

    emit = _emit_record

    fsdp, tp, sp, steps = LAYOUTS[args.layout]
    attention = "ring" if sp > 1 else "flash"
    steps = int(os.environ.get("TOTAL_STEPS", str(steps)))
    # the world of one's parameters after each layout's steps
    # (``_layouts_world_of_one``), which a rank holds its update to
    updates_dir = os.environ["LAYOUT_UPDATES_DIR"]
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        strict_fp32()
        torch.empty(1, device=device)
        fa._lib()
    ctx = elastic_context(device=device)
    mesh = build_mesh(MeshConfig(dp=-1, fsdp=fsdp, tp=tp, sp=sp))
    cfg, state, step_fn, batches = gpt_elastic.build(args.small, device, mesh,
                                                     layers=LAYOUT_LAYERS[args.small],
                                                     ce_chunk=LAYOUT_CE_CHUNK[args.small],
                                                     attention=attention)
    emit("boot", rank=ctx.process_id, world=mesh.size, mesh=mesh.shape, coord=mesh.coord,
         backend=ctx.backend, device=str(device))
    start = {n: p.detach().cpu().clone() for n, p in state.params.items()}

    def nbytes(t):
        return t.numel() * t.element_size()

    own, whole = 0, 0
    for name, p in state.params.items():
        layout = p.shard_layout
        for t in (p, state.opt_state.mu[name], state.opt_state.nu[name]):
            _check(tuple(t.shape) == layout.local_shape and t.shard_layout == layout,
                   f"{name}: a tensor of shape {tuple(t.shape)} for the block {layout}")
            own += nbytes(t)
            whole += math.prod(layout.global_shape) * t.element_size()
    engine = CheckpointEngine(os.environ["CKPT_DIR"], mesh=mesh, standalone=True, replicate=False)
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        data = list(batches(0, steps))
        launches, losses, split = dict(fa.launches), [], {}
        staged = None
        for s, (x, y) in enumerate(data):
            x, y = x.to(device), y.to(device)
            mark = _split_marks(split, device) if s == LAYOUT_SPLIT_STEP else None
            t0 = time.perf_counter()
            state, loss = step_fn(state, x, y, mark) if mark else step_fn(state, x, y)
            loss = float(loss)
            step_s = time.perf_counter() - t0
            per_step = {k: fa.launches[k] - launches[k] for k in launches}
            launches.update(fa.launches)
            losses.append(loss)
            emit("step", step=s, loss=loss, step_s=step_s, launches=per_step,
                 split=split if s == LAYOUT_SPLIT_STEP else None)
            if s == steps - 2:
                t0 = time.perf_counter()
                _check(engine.save_to_memory(s, state, block=True), f"the stage of step {s} skipped")
                staged = {"step": s, "hash": _local_hash(state), "stage_s": time.perf_counter() - t0}
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        emit("update", **_update_error(state.params, start,
                                       os.path.join(updates_dir, f"params_{steps}.pt")))
        meta = engine.shm.read_meta()
        records = [[r.path, r.global_shape, r.local_shape, [list(i) for i in r.index], r.spec]
                   for r in meta.records]
        t0 = time.perf_counter()
        step, state = engine.load_consistent(state)
        restore_s = time.perf_counter() - t0
        restored_hash = _local_hash(state)
        x, y = data[-1]
        state, rerun = step_fn(state, x.to(device), y.to(device))
        emit("restore", step=step, source=engine.restored_from, restore_s=restore_s,
             stage_s=staged["stage_s"], hash_equal=restored_hash == staged["hash"],
             rerun_loss=float(rerun), loss=losses[-1])
        # the flagship's own loss head (ce_chunk=0: the logits gathered over
        # tp, collectives.gather_from_group), one step from the seed-0
        # weights on the first batch: the split CE's first loss, and the
        # gather's seconds
        _, logits_state, logits_step, _ = gpt_elastic.build(args.small, device, mesh,
                                                            layers=LAYOUT_LAYERS[args.small],
                                                            attention=attention)
        logits_split = {}
        x, y = data[0]
        _, logits_loss = logits_step(logits_state, x.to(device), y.to(device),
                                     _split_marks(logits_split, device))
        emit("logits_step", loss=float(logits_loss), split=logits_split)
        del logits_state
        emit("state", own_bytes=own, whole_bytes=whole, image_bytes=meta.total_bytes,
             peak_mem_bytes=peak, records=records, mesh_axes=meta.mesh_axes,
             mesh_shape=meta.mesh_shape)
    finally:
        engine.close()
        engine.shm.unlink()
    ctx.shutdown()
    return 0


def _layouts_world_of_one(small, device, steps, updates_dir):
    """The layouts trainer's model, step and batches trained in this process
    as a world of one for ``steps`` steps: ``{step (as a string): loss}``;
    its parameters after each layout's steps go to ``updates_dir``
    (``params_{n}.pt``)."""
    import torch

    from dlrover_tpu_torch.examples import gpt_elastic

    device = torch.device(device)
    _, state, step_fn, batches = gpt_elastic.build(small, device, layers=LAYOUT_LAYERS[small],
                                                   ce_chunk=LAYOUT_CE_CHUNK[small])
    keep = {n for *_, n in LAYOUTS.values()}
    losses = {}
    for s, (x, y) in enumerate(batches(0, steps)):
        state, loss = step_fn(state, x.to(device), y.to(device))
        losses[str(s)] = float(loss)
        if s + 1 in keep:
            torch.save({n: p.detach().cpu() for n, p in state.params.items()},
                       os.path.join(updates_dir, f"params_{s + 1}.pt"))
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return losses


def layouts_phase(work, job, device="cuda", small=False, reference=None, card=None,
                  layouts=tuple(LAYOUTS), gpu_per_rank=False, timeout=600):
    """Phase 11: the layouts trainer's model as a world of one in this
    process (``_layouts_world_of_one``) for the most steps of ``layouts``,
    saving its parameters after each layout's steps, then
    each layout of ``layouts`` as a world of ``fsdp * tp * sp`` ranks of it
    (ring attention under sp), the worlds at once (sharing the card over
    gloo, or one GPU a rank over NCCL with ``gpu_per_rank``). Checks: every
    rank-step launches 24/12/12 flash kernels, none under sp (on the card);
    the losses are bit-equal across the ranks and
    within ``LAYOUT_LOSS_TOL`` of ``reference`` ({step as a string: loss},
    phase 5's world of one; without it the world of one's losses); each
    rank's update of its blocks over the run is within
    ``LAYOUT_UPDATE_TOL`` of the world of one's on the same blocks (the
    relative L2 error over all blocks and over each leaf); every rank
    holds its blocks only (its parameters and moments
    within ``LAYOUT_BYTES_SLACK`` of the world of one's over the ranks that
    split them),
    (at the small size, less than the whole), stages them with sharded
    records whose union covers every leaf once,
    restores the staged step from memory bit-equal and steps the last step
    again to the same loss; the step on gathered logits is bit-equal across
    the ranks and within ``LAYOUT_LOSS_TOL`` of the reference's first
    loss; the workers hold /dev/nvidia* on the card, and
    no process or shm segment of the phase is left. Returns the numbers by
    layout: the median step, the split step's parts, peak device memory
    and state bytes per rank."""
    steps_max = max(LAYOUTS[name][3] for name in layouts)
    cpu = device == "cpu"
    args = (["--device", "cpu"] if cpu else []) + (["--small"] if small else [])
    out = {"card": "CPU" if cpu else card or card_line(), "backend": None}
    script = os.path.abspath(__file__)
    updates = {"LAYOUT_UPDATES_DIR": os.path.join(work, f"{job}_one_params")}
    os.makedirs(updates["LAYOUT_UPDATES_DIR"])
    one = _layouts_world_of_one(small, device, steps_max, updates["LAYOUT_UPDATES_DIR"])
    if reference is None:
        reference = one
    worlds = _at_once({name: functools.partial(
        _gpu_world, work, f"{job}_{name}", math.prod(LAYOUTS[name][:3]), LAYOUTS[name][3],
        args, timeout, [script, "--trainer", "layouts", "--layout", name], updates, gpu_per_rank)
        for name in layouts})
    for name in layouts:
        fsdp, tp, sp, steps = LAYOUTS[name]
        n = fsdp * tp * sp
        recs, held, left, _ = worlds[name]
        _check(not left, f"{name}: shm segments left behind: {left}")
        _check(cpu or all(held.get(r) for r in range(n)), f"{name}: workers without the GPU: {held}")

        def events(r, kind):
            return [x for x in recs[r] if x["event"] == kind]

        boots = [events(r, "boot")[0] for r in range(n)]
        out["backend"] = boots[0]["backend"]
        by_step = [{x["step"]: x for x in events(r, "step")} for r in range(n)]
        _check(all(sorted(b) == list(range(steps)) for b in by_step), f"{name}: steps {by_step}")
        max_diff = 0.0
        for s in range(steps):
            losses = {by_step[r][s]["loss"] for r in range(n)}
            _check(len(losses) == 1, f"{name} step {s}: the ranks' losses differ: {losses}")
            loss = losses.pop()
            _check(math.isfinite(loss), f"{name} step {s}: loss {loss}")
            max_diff = max(max_diff, abs(loss - reference[str(s)]))
        _check(max_diff <= LAYOUT_LOSS_TOL, f"{name}: losses differ from the world of one by {max_diff}")
        update = [events(r, "update")[0] for r in range(n)]
        _check(all(u["rel_err"] <= LAYOUT_UPDATE_TOL and u["worst_rel_err"] <= LAYOUT_UPDATE_TOL
                   for u in update), f"{name}: updates against the world of one's: {update}")
        # ring attention launches no flash kernel
        per_step = (flash_per_step(LAYOUT_LAYERS[small] or 12) if sp == 1
                    else dict.fromkeys(FLASH_PER_STEP, 0))
        bad = [(r, s, x["launches"]) for r in range(n) for s, x in by_step[r].items()
               if not cpu and x["launches"] != per_step]
        _check(not bad, f"{name}: steps with other flash launches than {per_step}: {bad[:3]}")
        restores = [events(r, "restore")[0] for r in range(n)]
        _check(all(x["step"] == steps - 2 and x["source"] in ("memory", "prefetch")
                   and x["hash_equal"] and x["rerun_loss"] == x["loss"] for x in restores),
               f"{name}: restores {restores}")
        states = [events(r, "state")[0] for r in range(n)]
        whole = states[0]["whole_bytes"]
        for r, st in enumerate(states):
            # the small model's unsplit leaves are a larger share: a block each
            split = n // sp  # the ranks that split the parameters
            _check(st["own_bytes"] <= (whole - 1 if small else LAYOUT_BYTES_SLACK * whole / split),
                   f"{name} rank {r}: {st['own_bytes']} bytes of a {whole}-byte state")
            _check(st["image_bytes"] <= st["own_bytes"] + 64,
                   f"{name} rank {r}: an image of {st['image_bytes']} bytes for {st['own_bytes']}")
            _check(st["mesh_shape"] == [boots[r]["mesh"][a] for a in st["mesh_axes"]],
                   f"{name} rank {r}: meta mesh {st['mesh_axes']} {st['mesh_shape']}")
        covered, volume = {}, {}
        for st in states:
            for path, global_shape, _local, index, _spec in st["records"]:
                covered.setdefault(path, set()).add(tuple(map(tuple, index)))
                volume[path] = math.prod(global_shape)
        short = {p: sum(math.prod(b - a for a, b in i) for i in idx) for p, idx in covered.items()
                 if sum(math.prod(b - a for a, b in i) for i in idx) != volume[p]}
        _check(not short, f"{name}: leaves the ranks' records do not cover once: {short}")
        logits = [events(r, "logits_step")[0] for r in range(n)]
        logits_diff = abs(logits[0]["loss"] - reference["0"])
        _check(len({x["loss"] for x in logits}) == 1 and logits_diff <= LAYOUT_LOSS_TOL,
               f"{name}: the step on gathered logits: {logits} against {reference['0']}")
        split = next(x["split"] for x in events(0, "step") if x["split"])
        # the forward and backward without the collectives inside them
        compute = split["forward_s"] + split["backward_s"] - sum(
            split.get(k, 0.0) for k in COLLECTIVE_PARTS)
        out[name] = {
            "mesh": boots[0]["mesh"], "ranks": n, "steps": steps, "max_loss_diff": max_diff,
            # one step of the flagship's head (ce_chunk=0), rank 0's split
            "logits_step": {"loss_diff": logits_diff,
                            **{k: logits[0]["split"].get(k) for k in (
                                "forward_s", "backward_s", "tp_s", "tp_logits_s")}},
            "update_rel_err": [u["rel_err"] for u in update],
            "update_worst_leaf": max((u["worst_rel_err"], u["worst_leaf"]) for u in update),
            "losses": [by_step[0][s]["loss"] for s in range(steps)],
            "median_step_s": statistics.median(
                [by_step[r][s]["step_s"] for r in range(n) for s in range(LAYOUT_SPLIT_STEP + 1, steps)]),
            "split_step": {k: split.get(k) for k in ("forward_s", "backward_s", "all_reduce_s",
                                                     "optimizer_s") + COLLECTIVE_PARTS},
            "compute_s": compute,
            "peak_mem_gb": [st["peak_mem_bytes"] and st["peak_mem_bytes"] / 1e9 for st in states],
            "state_bytes": [st["own_bytes"] for st in states], "world_of_one_state_bytes": whole,
            "image_bytes": [st["image_bytes"] for st in states],
            "records_per_rank": len(states[0]["records"]),
            "stage_s": [x["stage_s"] for x in restores], "restore_s": [x["restore_s"] for x in restores],
            "launches_per_rank_step": by_step[0][steps - 1]["launches"],
        }
        log(f"  {name}: " + json.dumps(out[name]))
    return out


# -- phase 12: the Llama family's layouts on one card ----------------------------
#
# Llama-125M under tp=2 and its MoE under fsdp=2 x ep=2, each rank a process of
# this script sharing the card over gloo, from phase 9's seed-0 weights on its
# batch; phase 9 is their world of one. The MoE ranks write their state as one
# durable generation, which a world of one in this process warm-starts onto
# its own mesh without a template, and steps on.

# name: (variant, fsdp, ep, tp, sp, steps); sp through ring attention
LLAMA_LAYOUTS = {"llama_tp2": ("dense", 1, 1, 2, 1, 3), "moe_fsdp2_ep2": ("moe", 2, 2, 1, 1, 3),
                 "llama_sp2": ("dense", 1, 1, 1, 2, 3)}
LLAMA_LAYOUT_STEPS = 3
# the head fused with the CE in sequence chunks, split over the vocabulary
# under tp, by --small (phase 9 takes the whole logits: the same loss)
LLAMA_CE_CHUNK = {False: 256, True: 16}
LLAMA_WARM_LINEAGE = "llama_moe_fsdp2_ep2"


def _llama_config(small, variant, sp=1):
    """Phase 9's variant with phase 12's split CE; ring attention on a mesh
    that splits the sequence (``sp`` above 1)."""
    from dlrover_tpu_torch.models import llama

    base = dict(LLAMA_SMALL if small else LLAMA_125M)
    if sp > 1:
        base["attention_impl"] = "ring"
    return llama.LlamaConfig(**base, **(LLAMA_MOE if variant == "moe" else {}),
                             ce_chunk=LLAMA_CE_CHUNK[small])


def _llama_batch(small):
    """Phase 9's seeded batch and its targets, on the CPU."""
    import numpy as np
    import torch

    vocab, (batch, seq) = ((LLAMA_SMALL["vocab_size"], LLAMA_SMALL_BATCH) if small
                           else (LLAMA_125M["vocab_size"], LLAMA_BATCH))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, vocab, (batch, seq)))
    return tokens, torch.roll(tokens, -1, dims=1)


def _blocks_hash(blocks) -> str:
    """SHA-256 over ``[(path, tensor)]`` in order: each path and the
    tensor's bytes."""
    import torch

    h = hashlib.sha256()
    for path, t in blocks:
        h.update(path.encode())
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def llama_layouts_trainer(args) -> int:
    """One rank of phase 12 (``--trainer llama_layouts --layout NAME``):
    the variant of ``LLAMA_LAYOUTS[NAME]`` (Llama-125M or its MoE, flash,
    remat, the split CE; the small model with ``--small``) from seed-0
    weights on the mesh of the world in its env contract, trained on this
    rank's rows of phase 9's batch. It checks that every parameter and
    moment is its layout's block, prints each step's loss, time and flash
    launches, times the parts of step ``LAYOUT_SPLIT_STEP``, and holds its
    update of its blocks to phase 9's parameters after as many steps (in
    ``LLAMA_REFERENCE_DIR``). The MoE's ranks then stage their state
    through a standalone ``CheckpointEngine`` on the mesh and drain it as
    one durable generation (``DurableWriter`` under ``LLAMA_DURABLE_ROOT``;
    rank 0 commits), printing the SHA-256 of their blocks. Records are JSON
    lines prefixed ``gpt_elastic``, as the example's."""
    import torch

    from dlrover_tpu_torch.checkpoint.durable import DurableWriter
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.checkpoint.shm_handler import flatten_with_path
    from dlrover_tpu_torch.common.platform import resolve_device, strict_fp32
    from dlrover_tpu_torch.models import gpt, llama
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import train_step
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.parallel.sharding import batch_sharding, data_sharding_for
    from dlrover_tpu_torch.trainer.elastic import elastic_context

    emit = _emit_record

    variant, fsdp, ep, tp, sp, steps = LLAMA_LAYOUTS[args.layout]
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        strict_fp32()
        torch.empty(1, device=device)
        fa._lib()
    ctx = elastic_context(device=device)
    mesh = build_mesh(MeshConfig(dp=-1, fsdp=fsdp, ep=ep, tp=tp, sp=sp))
    cfg = _llama_config(args.small, variant, sp)
    tokens, targets = _llama_batch(args.small)
    rows = batch_sharding(tokens.shape[0], mesh)
    # this rank's rows, and its block of the positions under sp
    x, y = (data_sharding_for(t, mesh).to(device) for t in (tokens, targets))
    model = llama.Llama(cfg, device=device, seed=0)
    tx = train_step.default_optimizer()
    state = train_step.init_train_state(model, x, tx, device=device, seed=0, mesh=mesh)
    step_fn = train_step.build_train_step(model, tx, gpt.token_loss_mean, mesh=mesh)
    emit("boot", rank=ctx.process_id, world=mesh.size, mesh=mesh.shape, coord=mesh.coord,
         backend=ctx.backend, device=str(device), rows=[rows.start, rows.stop])
    start = {n: p.detach().cpu().clone() for n, p in state.params.items()}
    own = whole = 0
    for name, p in state.params.items():
        layout = p.shard_layout
        for t in (p, state.opt_state.mu[name], state.opt_state.nu[name]):
            _check(tuple(t.shape) == layout.local_shape and t.shard_layout == layout,
                   f"{name}: a tensor of shape {tuple(t.shape)} for the block {layout}")
            own += t.numel() * t.element_size()
            whole += math.prod(layout.global_shape) * t.element_size()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches, split = dict(fa.launches), {}
    for s in range(steps):
        mark = _split_marks(split, device) if s == LAYOUT_SPLIT_STEP else None
        t0 = time.perf_counter()
        state, loss = step_fn(state, x, y, mark) if mark else step_fn(state, x, y)
        loss = float(loss)
        step_s = time.perf_counter() - t0
        per_step = {k: fa.launches[k] - launches[k] for k in launches}
        launches.update(fa.launches)
        emit("step", step=s, loss=loss, step_s=step_s, launches=per_step,
             split=split if s == LAYOUT_SPLIT_STEP else None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    emit("update", **_update_error(state.params, start, os.path.join(
        os.environ["LLAMA_REFERENCE_DIR"], f"{variant}_params_{steps}.pt")))
    emit("state", own_bytes=own, whole_bytes=whole, peak_mem_bytes=peak)
    if variant == "moe":
        engine = CheckpointEngine(os.environ["CKPT_DIR"], mesh=mesh, standalone=True,
                                  replicate=False)
        try:
            t0 = time.perf_counter()
            _check(engine.save_to_memory(steps, state, block=True), f"the stage of step {steps}")
            stage_s = time.perf_counter() - t0
            writer = DurableWriter(os.environ["LLAMA_DURABLE_ROOT"], LLAMA_WARM_LINEAGE, mesh.rank,
                                   mesh.size, engine.shm, keep=0)
            t0 = time.perf_counter()
            committed = writer.drain(steps)
            drain_s = time.perf_counter() - t0
            writer.stop()
            records = [[r.path, [list(i) for i in r.index]] for r in engine.shm.read_meta().records]
        finally:
            engine.close()
            engine.shm.unlink()
        blocks = [(p, t) for p, t in flatten_with_path(state) if isinstance(t, torch.Tensor)]
        emit("durable", step=steps, committed=committed, stage_s=stage_s, drain_s=drain_s,
             records=records, blocks=[p for p, _ in blocks], blocks_hash=_blocks_hash(blocks),
             count=state.opt_state.count, state_step=state.step)
    ctx.shutdown()
    return 0


def llama_layouts_phase(work, job, reference, device="cuda", small=False, card=None,
                        timeout=600, layouts=tuple(LLAMA_LAYOUTS)):
    """Phase 12: each layout of ``layouts`` (of ``LLAMA_LAYOUTS``) as a world
    of ``fsdp * ep * tp * sp`` ranks of ``llama_layouts_trainer`` sharing the
    card over gloo, the worlds at once, against phase 9's world of one
    (``reference``: each variant's ``losses``, and ``params_dir`` with its
    parameters after ``LLAMA_LAYOUT_STEPS`` steps). Checks: losses
    bit-equal across the ranks and within ``LAYOUT_LOSS_TOL`` of phase 9's;
    each rank's update of its blocks within ``LAYOUT_UPDATE_TOL`` of phase
    9's on the same blocks; 24/12/12 flash launches every rank-step (on the
    card), none under sp (ring attention); every rank holds less than the
    whole state where a mesh axis splits it, the whole under sp alone. Then,
    with the MoE world among ``layouts``, its ranks' durable generation: a
    world of one here calls ``warm_start(root, lineage, mesh)`` with no
    template; each rank's blocks cut out of what it placed must hash equal
    to what the rank held, step and count must be the ranks', and the state,
    copied into a model built afresh, must give phase 9's MoE loss of the
    next step within ``LAYOUT_LOSS_TOL``. No process or shm segment of the
    phase may be left. Returns the numbers by layout and the warm start's."""
    import logging

    import torch

    from dlrover_tpu_torch.checkpoint.durable import warm_start
    from dlrover_tpu_torch.checkpoint.engine import restore_into_template
    from dlrover_tpu_torch.common.log import logger
    from dlrover_tpu_torch.models import gpt, llama
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import train_step
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    t_phase = time.perf_counter()
    cpu = device == "cpu"
    args = (["--device", "cpu"] if cpu else []) + (["--small"] if small else [])
    out = {"card": "CPU" if cpu else card or card_line(), "backend": None}
    root = os.path.join(work, "durable")
    env = {"LLAMA_REFERENCE_DIR": reference["params_dir"], "LLAMA_DURABLE_ROOT": root}
    script = os.path.abspath(__file__)
    durable = None
    worlds = _at_once({name: functools.partial(
        _gpu_world, work, f"{job}_{name}", math.prod(LLAMA_LAYOUTS[name][1:5]),
        LLAMA_LAYOUTS[name][5], args, timeout,
        [script, "--trainer", "llama_layouts", "--layout", name], env) for name in layouts})
    for name in layouts:
        variant, fsdp, ep, tp, sp, steps = LLAMA_LAYOUTS[name]
        n = fsdp * ep * tp * sp
        recs, held, left, world_s = worlds[name]
        _check(not left, f"{name}: shm segments left behind: {left}")
        _check(cpu or all(held.get(r) for r in range(n)), f"{name}: workers without the GPU: {held}")

        def events(r, kind):
            return [x for x in recs[r] if x["event"] == kind]

        boots = [events(r, "boot")[0] for r in range(n)]
        out["backend"] = boots[0]["backend"]
        by_step = [{x["step"]: x for x in events(r, "step")} for r in range(n)]
        _check(all(sorted(b) == list(range(steps)) for b in by_step), f"{name}: steps {by_step}")
        max_diff = 0.0
        for s in range(steps):
            losses = {by_step[r][s]["loss"] for r in range(n)}
            _check(len(losses) == 1, f"{name} step {s}: the ranks' losses differ: {losses}")
            loss = losses.pop()
            _check(math.isfinite(loss), f"{name} step {s}: loss {loss}")
            max_diff = max(max_diff, abs(loss - reference[variant][s]))
        _check(max_diff <= LAYOUT_LOSS_TOL, f"{name}: losses differ from phase 9's by {max_diff}")
        update = [events(r, "update")[0] for r in range(n)]
        _check(all(u["rel_err"] <= LAYOUT_UPDATE_TOL and u["worst_rel_err"] <= LAYOUT_UPDATE_TOL
                   for u in update), f"{name}: updates against phase 9's: {update}")
        # ring attention launches no flash kernel
        expect = (flash_per_step(_llama_config(small, variant).num_layers) if sp == 1
                  else dict.fromkeys(FLASH_PER_STEP, 0))
        bad = [(r, s, x["launches"]) for r in range(n) for s, x in by_step[r].items()
               if not cpu and x["launches"] != expect]
        _check(not bad, f"{name}: steps with other flash launches than {expect}: {bad[:3]}")
        states = [events(r, "state")[0] for r in range(n)]
        whole = states[0]["whole_bytes"]
        # less than the whole where a mesh axis splits the parameters; sp
        # replicates them
        _check(all(st["own_bytes"] < whole if n > sp else st["own_bytes"] == whole
                   for st in states),
               f"{name}: state bytes {[st['own_bytes'] for st in states]} of {whole}")
        split = next(x["split"] for x in events(0, "step") if x["split"])
        compute = split["forward_s"] + split["backward_s"] - sum(
            split.get(k, 0.0) for k in COLLECTIVE_PARTS)
        out[name] = {
            "variant": variant, "mesh": boots[0]["mesh"], "ranks": n, "steps": steps,
            "max_loss_diff": max_diff, "losses": [by_step[0][s]["loss"] for s in range(steps)],
            "update_rel_err": [u["rel_err"] for u in update],
            "update_worst_leaf": max((u["worst_rel_err"], u["worst_leaf"]) for u in update),
            "median_step_s": statistics.median(
                [by_step[r][s]["step_s"] for r in range(n) for s in range(LAYOUT_SPLIT_STEP + 1, steps)]),
            "split_step": {k: split.get(k) for k in ("forward_s", "backward_s", "all_reduce_s",
                                                     "optimizer_s") + COLLECTIVE_PARTS},
            "compute_s": compute,
            "peak_mem_gb": [st["peak_mem_bytes"] and st["peak_mem_bytes"] / 1e9 for st in states],
            "state_bytes": [st["own_bytes"] for st in states], "world_of_one_state_bytes": whole,
            "launches_per_rank_step": by_step[0][steps - 1]["launches"],
            "world_s": world_s,
            # phase 9's world of one with dense attention against its flash run
            "update_yardstick": reference.get("yardstick", {}).get(variant),
        }
        if variant == "moe":
            durable = (steps, [events(r, "durable")[0] for r in range(n)])
        log(f"  {name}: " + json.dumps(out[name]))

    if durable is None:  # no MoE world among ``layouts``: no generation to warm-start
        out["phase_s"] = time.perf_counter() - t_phase
        return out
    # the MoE ranks' generation, warm-started by a world of one
    steps, written = durable
    _check(written[0]["committed"], f"rank 0 did not commit the generation: {written[0]}")
    cfg = _llama_config(small, "moe")
    mesh = build_mesh(MeshConfig(dp=1))
    seconds = {}

    class Seconds(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("warm start from lineage"):
                seconds["read_s"], seconds["place_s"] = record.args[-2:]

    handler = Seconds()
    logger.addHandler(handler)
    try:
        t0 = time.perf_counter()
        step, placed, _ = warm_start(root, LLAMA_WARM_LINEAGE, mesh, device=device)
        warm_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
    _check(step == steps, f"warm start of step {step}, not {steps}")
    for r, w in enumerate(written):
        index = dict((path, idx) for path, idx in w["records"])
        got = _blocks_hash([(p, placed[p][tuple(slice(a, b) for a, b in index[p])])
                            for p in w["blocks"]])
        _check(got == w["blocks_hash"], f"rank {r}'s blocks differ from the warm-started state")
        _check(int(placed["step"]) == w["state_step"] and
               int(placed["opt_state/count"]) == w["count"],
               f"warm-started step {placed['step']}, count {placed['opt_state/count']}")
    tokens, targets = (t.to(device) for t in _llama_batch(small))
    model = llama.Llama(cfg, device=device, seed=1)
    tx = train_step.default_optimizer()
    state = restore_into_template(
        train_step.init_train_state(model, tokens, tx, device=device, seed=1), placed)
    del placed
    step_fn = train_step.build_train_step(model, tx, gpt.token_loss_mean)
    fa.reset_launches()
    t0 = time.perf_counter()
    state, loss = step_fn(state, tokens, targets)
    loss = float(loss)
    next_step_s = time.perf_counter() - t0
    want = reference["moe"][steps]
    _check(abs(loss - want) <= LAYOUT_LOSS_TOL,
           f"the warm-started step {steps + 1} gives {loss}, phase 9 {want}")
    _check(cpu or dict(fa.launches) == flash_per_step(cfg.num_layers),
           f"the warm-started step launched {fa.launches}")
    del state, model
    if not cpu:
        torch.cuda.empty_cache()
    out["warm_start"] = {
        "lineage": LLAMA_WARM_LINEAGE, "step": step, "saved_world": len(written),
        "read_s": seconds.get("read_s"), "place_s": seconds.get("place_s"), "warm_start_s": warm_s,
        "blocks_hash_equal": True, "next_loss": loss, "phase9_next_loss": want,
        "next_loss_diff": abs(loss - want), "next_step_s": next_step_s,
        "stage_s": [w["stage_s"] for w in written], "drain_s": [w["drain_s"] for w in written]}
    out["phase_s"] = time.perf_counter() - t_phase
    log("  warm start: " + json.dumps(out["warm_start"]))
    return out


# -- one GPU a rank (``chip_smoke.py --multi-gpu-world``) ------------------------
#
# Phase 7's ranks share the card, so their backend is gloo. On a machine
# with several GPUs this mode gives each rank its own (CUDA_VISIBLE_DEVICES),
# so the backend rule must pick NCCL and the checkpoint engine's metadata
# goes through the gloo group it makes beside the NCCL default group.


# -- phase 13: the pipeline axis and the DP -> PP trade on one card ----------------
#
# GPT-2 small's pipelined tree (models/gpt_pipeline.py: 12 layers, 12 heads of
# 64, embed 768, vocab 50304, an untied head; flash, remat, seq 1024, global
# batch 8, seed 0) trains as a world of four at dp=4 (its stages [1, 12, ...])
# for 3 steps and stages step 3 to each rank's shm; the replanner trades the
# shrink to 2 devices for dp1 x pp2 (accum 4); a world of two reads the first
# two hosts' images through load_resharded, refolds the stages to [2, 6, ...]
# and trains 4 steps, the 4 accumulation slices as the pipeline's 4
# microbatches of 2 rows. A world of one in this process is the reference.

PIPE_BATCH = {False: (8, 1024), True: (8, 32)}
PIPE_SMALL = dict(vocab_size=256, max_seq_len=32, num_layers=4, num_heads=4, head_dim=16,
                  embed_dim=64, use_remat=True)
PIPE_PARAMS = 163_072_512  # GPT-2 small's pipelined tree, untied head
PIPE_DP4_STEPS = 3
PIPE_PP_STEPS = 4
PIPE_LOSS_TOL = 1e-3
PIPE_UPDATE_TOL = 0.5
PIPE_SPLIT_STEP = 1  # the step of each rung whose parts the trainers time
# the trainers' rungs: (dp, pp, microbatches); phase 13 trades dp4 for
# dp1pp2, and --multi-gpu-world on four GPUs runs dp2pp2 against one
PIPE_RUNGS = {"dp4": (4, 1, 1), "dp1pp2": (1, 2, 4), "dp2pp2": (2, 2, 2), "one": (1, 1, 1)}
PIPE_TRADE = ("dp4", "dp1pp2")


def _pipeline_config(small):
    from dlrover_tpu_torch.models import gpt

    if small:
        return gpt.GPTConfig(**PIPE_SMALL)
    return dataclasses.replace(gpt.GPTConfig.gpt2_small(), use_remat=True)


def _pipeline_batches(small, start, stop, device):
    """The global batch of step s (tokens, targets), drawn from seed s as the
    example's."""
    import numpy as np
    import torch

    batch, seq = PIPE_BATCH[small]
    vocab = _pipeline_config(small).vocab_size
    for s in range(start, stop):
        t = torch.from_numpy(np.random.default_rng(s).integers(0, vocab, (batch, seq + 1)))
        yield t[:, :-1].to(device), t[:, 1:].to(device)


def _leaf_hashes(named):
    """SHA-256 of each tensor's bytes, by name."""
    import torch

    return {n: hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest() for n, t in named.items()}


def _pipeline_state_leaves(state):
    """The staged leaves of a pipelined train state by checkpoint path."""
    out = {f"params/{n}": p for n, p in state.params.items()}
    for moment in ("mu", "nu"):
        out.update({f"opt_state/{moment}/{n}": t
                    for n, t in getattr(state.opt_state, moment).items()})
    return out


def pipeline_trainer(args) -> int:
    """One rank of phase 13 (``--trainer pipeline --rung dp4|dp1pp2``), or
    of ``--multi-gpu-world``'s pipeline (``--rung dp2pp2|one``: the tree from
    seed 0 refolded to the rung's stages, trained ``PIPE_DP4_STEPS +
    PIPE_PP_STEPS`` steps from scratch).

    dp4: the pipelined GPT-2 small at pp=1 from seed 0 on a dp=4 mesh of
    the world in its env contract, ``PIPE_DP4_STEPS`` steps of the global
    batch (each rank its 2 rows as one microbatch); it stages the state
    after the last step to its shm through a standalone engine and leaves
    the image there, and prints the leaves' hashes.

    dp1pp2: on a dp=1 x pp=2 mesh it reads its host's image (its job name
    and host rank are the old world's rank's) with ``load_resharded``,
    hashes the leaves as placed, refolds the stages and their moments to
    two stages and keeps its own, then trains ``PIPE_PP_STEPS`` steps of
    the global batch as 4 microbatches, and measures its update against the
    world of one's (``PIPE_DIR/params_7.pt``).

    Both print each step's loss, time, split (step ``PIPE_SPLIT_STEP``)
    and flash launches, the state's bytes and the peak device memory, as
    ``gpt_elastic`` JSON records."""
    import torch

    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.common.platform import resolve_device, strict_fp32
    from dlrover_tpu_torch.models import gpt_pipeline as gp
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import pipeline
    from dlrover_tpu_torch.parallel import train_step as tts
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.parallel.sharding import set_layout
    from dlrover_tpu_torch.trainer.elastic import elastic_context

    emit = _emit_record

    dp, pp, micro = PIPE_RUNGS[args.rung]
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        strict_fp32()
        torch.empty(1, device=device)
        fa._lib()
    ctx = elastic_context(device=device)
    mesh = build_mesh(MeshConfig(dp=dp, pp=pp))
    cfg = _pipeline_config(args.small)
    tx = tts.default_optimizer()
    engine = CheckpointEngine(os.environ["CKPT_DIR"], mesh=mesh, standalone=True,
                              replicate=False, prefetch_restore=False)
    emit("boot", rank=ctx.process_id, world=mesh.size, mesh=mesh.shape, coord=mesh.coord,
         backend=ctx.backend, device=str(device))
    try:
        if args.rung != "dp1pp2":  # from seed 0 at one stage, refolded to pp stages
            flat = gp.flatten_params(gp.init_gpt_pipeline_params(cfg, 1, seed=0, device=device))
            flat = {k: pipeline.refold_stages({"x": v}, pp)["x"] if k.startswith("stages/")
                    else v for k, v in flat.items()}
            params = gp.shard_pipeline_params(flat, mesh)
            del flat
            state = tts.TrainState(0, params, tx.init(params))
            first, steps = 0, PIPE_DP4_STEPS if args.rung == "dp4" else \
                PIPE_DP4_STEPS + PIPE_PP_STEPS
        else:
            t0 = time.perf_counter()
            step, placed, _ = engine.load_resharded(mesh, device=device)
            load_s = time.perf_counter() - t0
            _check(step == PIPE_DP4_STEPS, f"load_resharded gave step {step}")
            loaded = _leaf_hashes({k: v for k, v in placed.items()
                                   if k.startswith(("params/", "opt_state/mu/", "opt_state/nu/"))})
            r = mesh.coord["pp"]
            own, kept = {}, True
            for path, t in placed.items():
                if "/stages/" in path:  # the whole stack: refold it, keep this stage
                    refolded = pipeline.refold_stages({"x": t}, pp)["x"]
                    layout = pipeline.stage_sharding({"x": refolded}, mesh)["x"]
                    t = set_layout(refolded[layout.slices()].clone(), layout)
                    kept = kept and torch.equal(t, refolded[r:r + 1])
                elif path.startswith(("params/", "opt_state/mu/", "opt_state/nu/")):
                    t = set_layout(t, None)  # whole on every rank, as the step keeps them
                own[path] = t
            del placed, refolded
            params = {p[len("params/"):]: set_layout(torch.nn.Parameter(t), t.shard_layout)
                      for p, t in own.items() if p.startswith("params/")}
            moments = {m: {p[len(f"opt_state/{m}/"):]: t for p, t in own.items()
                           if p.startswith(f"opt_state/{m}/")} for m in ("mu", "nu")}
            count = int(own["opt_state/count"])
            state = tts.TrainState(step, params, tts.OptState(count, moments["mu"], moments["nu"]))
            del own
            if cuda:
                torch.cuda.empty_cache()
            emit("resharded", step=step, load_s=load_s, **engine.last_reshard, hashes=loaded,
                 kept=kept, stage_shape=list(params["stages/wqkv"].shape), count=count)
            first, steps = PIPE_DP4_STEPS, PIPE_PP_STEPS
        start = {n: p.detach().cpu().clone() for n, p in params.items()}
        own_bytes = sum(t.numel() * t.element_size()
                        for t in _pipeline_state_leaves(state).values())
        n_params = sum(math.prod(p.shard_layout.global_shape) if p.shard_layout is not None
                       else p.numel() for p in params.values())
        step_fn = gp.build_gpt_pipeline_train_step(cfg, mesh, tx, micro)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        launches = dict(fa.launches)
        for s, (x, y) in enumerate(_pipeline_batches(args.small, first, first + steps, device)):
            split = {}
            mark = _split_marks(split, device) if s == PIPE_SPLIT_STEP else None
            t0 = time.perf_counter()
            state, loss = step_fn(state, x, y, mark) if mark else step_fn(state, x, y)
            loss = float(loss)
            step_s = time.perf_counter() - t0
            per_step = {k: fa.launches[k] - launches[k] for k in launches}
            launches.update(fa.launches)
            emit("step", step=first + s, loss=loss, step_s=step_s, launches=per_step,
                 split=split or None)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        if args.rung == "dp4":
            t0 = time.perf_counter()
            _check(engine.save_to_memory(state.step, state, block=True),
                   f"the stage of step {state.step} skipped")
            stage_s = time.perf_counter() - t0
            meta = engine.shm.read_meta()
            emit("staged", step=meta.step, stage_s=stage_s, image_bytes=meta.total_bytes,
                 hashes=_leaf_hashes(_pipeline_state_leaves(state)) if mesh.rank < 2 else None)
        elif args.rung == "dp1pp2":
            emit("update", **_update_error(state.params, start,
                                           os.path.join(os.environ["PIPE_DIR"], "params_7.pt")))
            engine.shm.unlink()
        emit("state", own_bytes=own_bytes, n_params=n_params, peak_mem_bytes=peak)
    finally:
        engine.close()
    ctx.shutdown()
    return 0


def _pipeline_world_of_one(small, device, out_dir):
    """The phase's model, optimizer and batches as a world of one in this
    process (pp=1, the global batch as one microbatch) for all the phase's
    steps: {step as a string: loss}; its parameters after the last step,
    the stages refolded to two, go to ``out_dir/params_7.pt``, and the
    seconds of its median step."""
    import torch

    from dlrover_tpu_torch.models import gpt_pipeline as gp
    from dlrover_tpu_torch.parallel import pipeline
    from dlrover_tpu_torch.parallel import train_step as tts

    device = torch.device(device)
    cfg = _pipeline_config(small)
    params = {k: torch.nn.Parameter(v) for k, v in gp.flatten_params(
        gp.init_gpt_pipeline_params(cfg, 1, seed=0, device=device)).items()}
    tx = tts.default_optimizer()
    state = tts.TrainState(0, params, tx.init(params))
    step_fn = gp.build_gpt_pipeline_train_step(cfg, None, tx, 1)
    total = PIPE_DP4_STEPS + PIPE_PP_STEPS
    losses, times = {}, []
    for s, (x, y) in enumerate(_pipeline_batches(small, 0, total, device)):
        t0 = time.perf_counter()
        state, loss = step_fn(state, x, y)
        losses[str(s)] = float(loss)
        times.append(time.perf_counter() - t0)
    keep = {n: (pipeline.refold_stages({"x": p.detach()}, 2)["x"] if n.startswith("stages/")
                else p.detach()).cpu() for n, p in state.params.items()}
    torch.save(keep, os.path.join(out_dir, f"params_{total}.pt"))
    n_params = sum(p.numel() for p in state.params.values())
    del state, params, keep
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return losses, n_params, statistics.median(times[1:])


def _shm_free():
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def pipeline_phase(work, job, device="cuda", small=False, card=None, timeout=600):
    """Phase 13: the pipeline axis and the DP -> PP trade.

    1. A world of one in this process (``_pipeline_world_of_one``) trains
       the pipelined tree ``PIPE_DP4_STEPS + PIPE_PP_STEPS`` steps: the
       reference.
    2. A world of four at dp=4 (``--trainer pipeline --rung dp4``, sharing
       the card over gloo) trains ``PIPE_DP4_STEPS`` steps and stages the
       last to each rank's shm. Checks: each step's loss within
       ``PIPE_LOSS_TOL`` of the world of one's and bit-equal across the
       ranks; ``/dev/shm`` holds the four images (checked first: the phase
       fails, it does not skip, when it cannot).
    3. ``ElasticReplanner(CostModel(...), full_dp=4, current=Rung(dp=4),
       max_pp=2, num_layers=12).plan(2)`` with the tree's parameter and
       moment bytes, a dp=4 rank's peak less its state as the activations,
       the dp=4 median step, and a memory cap halfway between dp2's and
       dp1 x pp2's bytes a device. Checks: ``Rung(dp=1, pp=2, accum=4)``,
       a trade, goodput x above 1.
    4. A world of two at dp1 x pp2 (``--rung dp1pp2``, the old ranks 0 and
       1's job names) reads the images, refolds and trains
       ``PIPE_PP_STEPS`` steps with the global batch as ``accum = 4``
       microbatches of 2 rows. Checks: every leaf as placed bit-equal to
       the staged step's (the dp=4 ranks' hashes), each rank's stage 6
       layers (half the depth) of the refolded stack; the losses within
       ``PIPE_LOSS_TOL`` of the world of one's continuation and bit-equal
       across the ranks; each rank's update within ``PIPE_UPDATE_TOL``
       relative L2 of the world of one's (over its blocks and each leaf).
    On the card every rank-step launches the flash kernels (each layer's
    forward twice under remat, its two backward kernels once) for each of
    its microbatches. No process or shm segment of the phase is left.
    Returns the ``pipeline`` line's numbers."""
    cpu = device == "cpu"
    args = (["--device", "cpu"] if cpu else []) + (["--small"] if small else [])
    script = os.path.abspath(__file__)
    pipe_dir = os.path.join(work, f"{job}_pipe")
    os.makedirs(pipe_dir)
    cfg = _pipeline_config(small)
    t0 = time.perf_counter()
    one, n_params, one_step_s = _pipeline_world_of_one(small, device, pipe_dir)
    one_s = time.perf_counter() - t0
    _check(small or n_params == PIPE_PARAMS, f"{n_params} parameters, not {PIPE_PARAMS}")
    state_bytes = 3 * 4 * n_params
    shm_free = _shm_free()
    dp4_n = PIPE_RUNGS["dp4"][0] * PIPE_RUNGS["dp4"][1]
    _check(shm_free > dp4_n * state_bytes * 1.02,
           f"/dev/shm has {shm_free} bytes free, the {dp4_n} dp=4 images need about "
           f"{dp4_n * state_bytes}")
    shm_peak = [0]

    def poll(procs):
        shm_peak[0] = max(shm_peak[0], shm_free - _shm_free())

    out = {"card": "CPU" if cpu else card or card_line(), "n_params": n_params,
           "state_bytes": state_bytes, "world_of_one_step_s": one_step_s,
           "world_of_one_s": one_s, "shm_free_before": shm_free}
    env = {"PIPE_DIR": pipe_dir}
    worlds = {}
    try:
        for rung in PIPE_TRADE:
            dp, pp, micro = PIPE_RUNGS[rung]
            n = dp * pp
            entry = [script, "--trainer", "pipeline", "--rung", rung]
            t0 = time.perf_counter()
            worlds[rung] = _example_world(work, job, n, 0, args, timeout, entry=entry,
                                          on_poll=poll, extra_env=env)
            out[f"{rung}_world_s"] = time.perf_counter() - t0
            if rung == "dp4":
                plan_out = _pipeline_plan(worlds["dp4"], n_params, cfg)
                out["plan"] = plan_out
    finally:
        _unlink_job_segments([f"{job}_"])
    left = [s for s in os.listdir("/dev/shm") if s.startswith(f"dlrover_{job}_")]
    _check(not left, f"shm segments left behind: {left}")
    out["shm_peak_bytes"] = shm_peak[0]

    def events(recs, r, kind):
        return [x for x in recs[r] if x["event"] == kind]

    for rung, recs in worlds.items():
        dp, pp, micro = PIPE_RUNGS[rung]
        n = dp * pp
        first, steps = (0, PIPE_DP4_STEPS) if rung == "dp4" else (PIPE_DP4_STEPS, PIPE_PP_STEPS)
        by_step = [{x["step"]: x for x in events(recs, r, "step")} for r in range(n)]
        _check(all(sorted(b) == list(range(first, first + steps)) for b in by_step),
               f"{rung}: steps {[sorted(b) for b in by_step]}")
        max_diff = 0.0
        for s in range(first, first + steps):
            losses = {by_step[r][s]["loss"] for r in range(n)}
            _check(len(losses) == 1, f"{rung} step {s}: the ranks' losses differ: {losses}")
            loss = losses.pop()
            _check(math.isfinite(loss), f"{rung} step {s}: loss {loss}")
            max_diff = max(max_diff, abs(loss - one[str(s)]))
        _check(max_diff <= PIPE_LOSS_TOL,
               f"{rung}: losses differ from the world of one by {max_diff}")
        # each layer's forward twice (remat), its backward kernels once, for
        # every microbatch of the rank's stage
        layers = cfg.num_layers // pp
        per_step = {"fwd": 2 * layers * micro, "bwd_dkdv": layers * micro,
                    "bwd_dq": layers * micro}
        bad = [(r, s, x["launches"]) for r in range(n) for s, x in by_step[r].items()
               if not cpu and x["launches"] != per_step]
        _check(not bad, f"{rung}: steps with other flash launches than {per_step}: {bad[:3]}")
        states = [events(recs, r, "state")[0] for r in range(n)]
        split = next(x["split"] for x in events(recs, 0, "step") if x["split"])
        parts = ("pp_s", "pp_sum_s", "all_reduce_s")
        compute = split.get("forward_s", 0.0) + split.get("backward_s", 0.0) - split.get("pp_s", 0.0)
        out[rung] = {
            "mesh": events(recs, 0, "boot")[0]["mesh"], "ranks": n, "microbatches": micro,
            "losses": [by_step[0][s]["loss"] for s in range(first, first + steps)],
            "max_loss_diff": max_diff,
            "median_step_s": statistics.median(
                [by_step[r][s]["step_s"] for r in range(n)
                 for s in range(first + PIPE_SPLIT_STEP + 1, first + steps)]
                or [by_step[r][first + PIPE_SPLIT_STEP]["step_s"] for r in range(n)]),
            "split_step": {k: split.get(k) for k in ("forward_s", "backward_s", "optimizer_s")
                           + parts},
            "compute_s": compute,
            "launches_per_rank_step": by_step[0][first + steps - 1]["launches"],
            "peak_mem_gb": [st["peak_mem_bytes"] and st["peak_mem_bytes"] / 1e9 for st in states],
            "state_bytes": [st["own_bytes"] for st in states],
        }
        if rung == "dp4":
            staged = [events(recs, r, "staged")[0] for r in range(n)]
            _check(all(x["step"] == PIPE_DP4_STEPS for x in staged), f"staged {staged}")
            _check(staged[0]["hashes"] == staged[1]["hashes"], "the dp=4 ranks' states differ")
            out[rung]["stage_s"] = [x["stage_s"] for x in staged]
            out[rung]["image_bytes"] = staged[0]["image_bytes"]
        else:
            resh = [events(recs, r, "resharded")[0] for r in range(n)]
            want = events(worlds["dp4"], 0, "staged")[0]["hashes"]
            for r, x in enumerate(resh):
                _check(x["step"] == PIPE_DP4_STEPS and x["hashes"] == want,
                       f"rank {r}: the leaves placed by load_resharded differ from the staged "
                       f"step {PIPE_DP4_STEPS}'s: "
                       f"{sorted(k for k in want if x['hashes'].get(k) != want[k])[:5]}")
                _check(x["kept"] and x["stage_shape"][:2] == [1, cfg.num_layers // pp],
                       f"rank {r}: its stage of the refolded stack {x['stage_shape']}")
            update = [events(recs, r, "update")[0] for r in range(n)]
            _check(all(u["rel_err"] <= PIPE_UPDATE_TOL and u["worst_rel_err"] <= PIPE_UPDATE_TOL
                       for u in update), f"updates against the world of one's: {update}")
            out[rung].update({
                "load_resharded": [{k: x[k] for k in ("load_s", "read_s", "place_s", "bytes")}
                                   for x in resh],
                "update_rel_err": [u["rel_err"] for u in update],
                "update_worst_leaf": max((u["worst_rel_err"], u["worst_leaf"]) for u in update),
                "accum_as_microbatches": "accum 4 keeps the global batch of 8: the 4 "
                                         "accumulation slices of 2 rows are the pipeline's 4 "
                                         "microbatches, one update a step",
            })
    out["world_of_one_losses"] = one
    return out


def _pipeline_plan(recs, n_params, cfg):
    """The replanner's verdict for the dp=4 world shrunk to 2 devices, from
    the dp=4 ranks' bytes, peak and step."""
    from dlrover_tpu_torch.parallel.replan import CostModel, ElasticReplanner, Rung

    states = [x for r in recs for x in r if x["event"] == "state"]
    steps = [x["step_s"] for r in recs for x in r if x["event"] == "step" and x["step"] > 0]
    param_bytes, opt_bytes = 4 * n_params, 8 * n_params
    peaks = [x["peak_mem_bytes"] for x in states if x["peak_mem_bytes"]]
    # a dp=4 rank's peak less its state: its gradients and activations (on
    # the CPU, where nothing reports a peak: 2 GiB, the JAX check's figure)
    act_bytes = (max(peaks) - max(x["own_bytes"] for x in states)) if peaks else 2 << 30
    base = CostModel(param_bytes=param_bytes, opt_bytes=opt_bytes, act_bytes=act_bytes,
                     step_time_s=statistics.median(steps), reference=Rung(dp=4))
    dp2 = base.mem_bytes_per_device(Rung(dp=2, accum=2))
    dp1pp2 = base.mem_bytes_per_device(Rung(dp=1, pp=2, accum=4))
    cap = (dp2 + dp1pp2) // 2
    planner = ElasticReplanner(dataclasses.replace(base, hbm_bytes_per_device=cap), full_dp=4,
                               current=Rung(dp=4), max_pp=2, num_layers=cfg.num_layers)
    plan = planner.plan(2)
    _check(plan.rung == Rung(dp=1, pp=2, accum=4) and plan.is_trade
           and plan.hybrid_vs_accum_goodput_x > 1.0,
           f"the plan {plan.rung} (trade {plan.is_trade}, x {plan.hybrid_vs_accum_goodput_x})")
    out = {"rung": plan.rung.label(), "accum": plan.rung.accum, "is_trade": plan.is_trade,
           "hybrid_vs_accum_goodput_x": plan.hybrid_vs_accum_goodput_x,
           "est_step_s": plan.est_step_s, "accum_rung": plan.accum_rung.label(),
           "accum_est_step_s": plan.accum_est_step_s, "param_bytes": param_bytes,
           "opt_bytes": opt_bytes, "act_bytes": act_bytes,
           "mem_bytes_per_device": {"dp2": dp2, "dp1pp2": dp1pp2},
           "hbm_bytes_per_device": cap,
           "note": "the cap is set between dp2's and dp1pp2's bytes, as the JAX scenario sets "
                   "one; the card's 80 GB bounds nothing for GPT-2 small"}
    log("  plan: " + json.dumps(out))
    return out


def pipeline_world(work, job, device="cuda", small=False, gpu_per_rank=False, timeout=600):
    """The pipelined tree at dp2 x pp2 (4 ranks, the global batch as 2
    microbatches, each split over dp) against a world of one (``--trainer
    pipeline --rung dp2pp2|one``), both from seed 0, ``PIPE_DP4_STEPS +
    PIPE_PP_STEPS`` steps; one GPU a rank over NCCL with ``gpu_per_rank``.
    Checks: the losses bit-equal across the ranks and within
    ``PIPE_LOSS_TOL`` of the world of one's. Returns both median steps, the
    backend and the largest loss difference."""
    args = (["--device", "cpu"] if device == "cpu" else []) + (["--small"] if small else [])
    runs = {}
    try:
        for rung in ("one", "dp2pp2"):
            dp, pp, _ = PIPE_RUNGS[rung]
            entry = [os.path.abspath(__file__), "--trainer", "pipeline", "--rung", rung]
            runs[rung] = _example_world(work, f"{job}_{rung}", dp * pp, 0, args, timeout,
                                        gpu_per_rank=gpu_per_rank, entry=entry)
    finally:
        _unlink_job_segments([f"{job}_"])

    def steps(recs):
        return {x["step"]: x for x in recs if x["event"] == "step"}

    one = steps(runs["one"][0])
    world = [steps(recs) for recs in runs["dp2pp2"]]
    _check(all(sorted(w) == sorted(one) for w in world), "the runs' steps differ")
    _check(all(w[s]["loss"] == world[0][s]["loss"] for w in world for s in one),
           "the dp2pp2 ranks' losses differ")
    diff = max(abs(world[0][s]["loss"] - one[s]["loss"]) for s in one)
    _check(diff <= PIPE_LOSS_TOL, f"dp2pp2 differs from its world of one by {diff}")
    boot = next(x for x in runs["dp2pp2"][0] if x["event"] == "boot")
    return {"mesh": boot["mesh"], "backend": boot["backend"], "max_loss_diff": diff,
            "losses": [world[0][s]["loss"] for s in sorted(one)],
            "median_step_s": {"dp2pp2": statistics.median(w[s]["step_s"] for w in world
                                                          for s in list(one)[2:]),
                              "world_of_one": statistics.median(one[s]["step_s"]
                                                                for s in list(one)[2:])},
            "split_step": next(x["split"] for x in world[0].values() if x["split"])}


# -- phase 14: decode and serving ------------------------------------------------
#
# (a) the decode path in fp32 at GPT-2 small's width and 4 layers, held to a
# teacher-forced forward without a cache, and the continuous engine held to
# the one-shot generate; (b) the user's command, ``python3 -m
# dlrover_tpu_torch.launcher.serve --ckpt-dir <phase 5's storage>``, answering
# concurrent completions over HTTP at full width in bf16; (c) the int8 cache
# against the exact one on the same weights; (d) Llama-125M's GQA cache on
# phase 9's weights. No flash kernel runs in this phase: decode attends over
# the cache with plain torch ops, as the JAX package does.

# sizes: the card's, and the CPU twin's (small)
SERVE = {False: dict(batch=8, width=128, new=32, prompts=24, lo=20, hi=120, chunk=8),
         True: dict(batch=4, width=16, new=8, prompts=8, lo=3, hi=16, chunk=4)}
SERVE_FP32_LAYERS = 4
# fp32 decode logits against the teacher-forced forward (TF32 off): the same
# function in another order of sums
SERVE_FP32_TOL = 1e-4
# bf16 logits against the teacher-forced forward, relative to the largest
# logit: twelve layers of bf16 roundings taken at other points (the cache's
# masked softmax over every slot against the forward's T x T)
SERVE_BF16_REL_TOL = 2.0 ** -4
# the int8 cache's logits against the exact cache's, each step (JAX's bound)
SERVE_INT8_COS = 0.999
SERVE_BOOT_S = 180
SERVE_SEED = 14


def _serve_config(small):
    """The served GPT's config as ``--config`` takes it: phase 5's example
    model (GPT-2 small at full width), or its 2-layer CPU variant."""
    if small:
        return dict(vocab_size=256, max_seq_len=32, num_layers=2, num_heads=4, head_dim=16,
                    embed_dim=64, use_remat=False)
    return dict(_gpt2_small_dims(), use_remat=False)


def _gpt2_small_dims():
    from dlrover_tpu_torch.models import gpt

    c = gpt.GPTConfig.gpt2_small()
    return {k: getattr(c, k) for k in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
                                       "head_dim", "embed_dim")}


def params_sha256(named):
    """SHA-256 over the parameters ``{name: tensor}``, by name: each name
    and its tensor's bytes."""
    import torch

    h = hashlib.sha256()
    for name in sorted(named):
        h.update(name.encode())
        t = named[name].detach().contiguous().reshape(-1)
        h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _serve_prompts(n, lo, hi, vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))]
            for _ in range(n)]


def _greedy_trace(model, prompts, n, drive=None):
    """Greedy decode of the left-padded ``prompts`` for ``n`` tokens through
    ``prefill_prompt`` and ``decode_apply``: (tokens [B, n], the logits each
    token was chosen from [B, n, V] fp32). ``drive`` ([B, n] tokens) feeds
    those tokens instead of the argmax (the int8 cache scores the exact
    cache's context)."""
    import torch

    from dlrover_tpu_torch.models import generation

    tokens, mask = generation.left_pad_prompts(prompts)
    cache, last, pos, kv = generation.prefill_prompt(model, None, tokens, mask)
    W = tokens.shape[1]
    toks, logits = [], []
    for t in range(n):
        logits.append(last)
        tok = last.argmax(-1) if drive is None else drive[:, t].to(last.device)
        toks.append(tok)
        if t == n - 1:
            break
        kv[:, W + t] = True
        pos = pos + 1
        out, cache = generation.decode_apply(model, None, cache, tok[:, None], pos[:, None], kv)
        last = out[:, 0].float()
    return torch.stack(toks, 1), torch.stack(logits, 1)


def _teacher_forced(model, prompt, gen):
    """The logits a forward without a cache gives at the positions that
    chose ``gen`` after ``prompt`` (fp32 ``[len(gen), V]``)."""
    import torch

    x = torch.tensor([list(prompt) + [int(t) for t in gen[:-1]]], device=model.device)
    with torch.no_grad():
        logits = model(x)[0].float()
    return logits[len(prompt) - 1:]


def _token_rule(got, want, ref_logits, delta):
    """(failed, excused) for the token lists ``got`` against ``want``, up to
    their first difference (the contexts part there): a difference counts
    as a failure only where the reference's top-2 gap at that position
    exceeds ``2 * delta``, twice the measured logit difference (two logits
    that each move by up to delta can swap within 2 delta)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            top2 = ref_logits[i].topk(2).values
            return (0, 1) if float(top2[0] - top2[1]) <= 2 * delta else (1, 0)
    return (0, 0) if len(got) == len(want) else (1, 0)


def _rule_over(outs, refs, delta):
    """``_token_rule`` summed over requests: outs and refs are token lists,
    refs carrying their logits ([(tokens, logits)])."""
    failed = excused = 0
    for got, (want, logits) in zip(outs, refs):
        f, e = _token_rule(got, want, logits, delta)
        failed += f
        excused += e
    return failed, excused


def _trace_against_forward(model, prompts, n):
    """A greedy trace of ``prompts`` and each row's teacher-forced logits:
    (tokens, the largest logit difference, the largest reference logit,
    (failed, excused) of the trace's tokens against the forward's argmax).
    The difference is the larger of the trace's against the forward's and
    the trace's first two rows against the same rows decoded alone, driven
    by the same tokens: what another batch shape (another choice of
    algorithm, another order of sums) moves a row's logits by."""
    toks, logits = _greedy_trace(model, prompts, n)
    refs = [_teacher_forced(model, p, toks[b].tolist()) for b, p in enumerate(prompts)]
    alone = [_greedy_trace(model, [p], n, drive=toks[b:b + 1])[1][0]
             for b, p in enumerate(prompts[:2])]
    delta = max([float((logits[b] - ref).abs().max()) for b, ref in enumerate(refs)]
                + [float((logits[b] - row).abs().max()) for b, row in enumerate(alone)])
    top = max(float(ref.abs().max()) for ref in refs)
    failed, excused = _rule_over([t.tolist() for t in toks],
                                 [(ref.argmax(-1).tolist(), ref) for ref in refs], delta)
    return toks, delta, top, failed, excused


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _decode_numbers(model, prompts, n, device):
    """The decode step of ``prompts`` (one batch, left-padded): prefill
    seconds, a step's host wall seconds over ``n`` steps (synchronised at the
    ends), the device's seconds for one step with the host queued ahead
    (CUDA events after a device sleep, so the step's launches are all
    queued when it starts; median of 5), and the busy share, device over
    wall. CPU runs give the wall numbers only."""
    import torch

    from dlrover_tpu_torch.models import generation

    cuda = torch.device(device).type == "cuda"
    tokens, mask = generation.left_pad_prompts(prompts)
    W = tokens.shape[1]
    prefill = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        cache, last, pos, kv = generation.prefill_prompt(model, None, tokens, mask)
        _sync(device)
        prefill.append(time.perf_counter() - t0)

    def one(t):
        nonlocal cache, last, pos
        kv[:, W + t] = True
        pos = pos + 1
        out, cache = generation.decode_apply(model, None, cache, last.argmax(-1)[:, None],
                                             pos[:, None], kv)
        last = out[:, 0].float()

    one(0)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for t in range(1, n):
        one(t)
    _sync(device)
    wall = (time.perf_counter() - t0) / (n - 1)
    out = {"prefill_ms": statistics.median(prefill) * 1e3, "decode_step_ms": wall * 1e3,
           "batch": len(prompts), "prompt_width": W}
    if not cuda:
        out.update(device_step_ms="not measured", busy_share="not measured")
        return out
    cache, last, pos, kv = generation.prefill_prompt(model, None, tokens, mask)
    device_ms = []
    for t in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # about 0.1 s: the step's launches queue behind it
        start.record()
        one(t)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
    out["device_step_ms"] = statistics.median(device_ms)
    out["busy_share"] = out["device_step_ms"] / out["decode_step_ms"]
    return out


def _cache_bytes(model, batch):
    from dlrover_tpu_torch.models import generation

    cache = generation.init_cache(model, batch)
    return sum(t.numel() * t.element_size() for layer in cache["layers"] for t in layer.values())


def _http(port, method, path, body=None, timeout=300):
    """(status, parsed JSON body, or the NDJSON lines of a stream) of one
    request to the local server."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read().decode()
        if resp.getheader("Content-Type") == "application/x-ndjson":
            return resp.status, [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
        return resp.status, json.loads(raw)
    finally:
        conn.close()


def torch_device_type(device):
    import torch

    return torch.device(device).type


def _start_server(work, job, ckpt_dir, sizes, small, device):
    """The user's command as a child process in its own session: (proc,
    its output's path)."""
    cfg = _serve_config(small)
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.launcher.serve", "--ckpt-dir", ckpt_dir,
           "--config", json.dumps(cfg), "--batch-size", str(sizes["batch"]),
           "--prompt-width", str(sizes["width"]), "--max-new-tokens", str(sizes["new"]),
           "--decode-chunk", str(sizes["chunk"]), "--temperature", "0", "--port", "0"]
    if torch_device_type(device) == "cpu":
        cmd.append("--cpu")
    env = dict(os.environ, DLROVER_JOB_NAME=job)
    env.pop("DLROVER_IPC_NAMESPACE", None)
    out_path = os.path.join(work, "serve.out")
    with open(out_path, "w") as out, open(os.path.join(work, "serve.err"), "w") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, env=env, start_new_session=True,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, out_path


def _server_line(proc, out_path, work, deadline):
    """The server's ``serve {...}`` record, once it listens."""
    while time.monotonic() < deadline:
        with open(out_path) as f:
            for line in f:
                if line.startswith("serve ") and line.endswith("\n"):
                    return json.loads(line[len("serve "):])
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    with open(os.path.join(work, "serve.err")) as f:
        err = f.read()[-4000:]
    raise AssertionError(f"the server did not come up (exit {proc.poll()}):\n{err}")


def serve_phase(work, job, reference, device="cuda", small=False, card=None):
    """Phase 14: decode and serving. ``reference`` holds ``ckpt_dir`` (the
    storage checkpoint phase 5 persisted, its latest step the bench
    trainer's), ``persisted`` (that step and its parameters' SHA-256) and
    ``llama_params`` (phase 9's dense Llama parameters after 3 steps, a
    ``torch.save`` of ``{name: tensor}``). Raises on the first failed check;
    returns the phase's numbers (the ``serving`` line)."""
    import dataclasses as dc
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from dlrover_tpu_torch.launcher import serve as tserve
    from dlrover_tpu_torch.models import generation, gpt, llama, serving

    t_phase = time.perf_counter()
    sizes = SERVE[small]
    cuda = torch_device_type(device) == "cuda"
    out = {"card": card or (card_line() if cuda else "CPU"), "sizes": sizes}
    greedy = generation.SamplingConfig(max_new_tokens=sizes["new"], temperature=0.0)

    # (a) exactness in fp32
    t0 = time.perf_counter()
    if small:
        cfg32 = dc.replace(gpt.GPTConfig.tiny(), dtype=torch.float32)
    else:
        cfg32 = gpt.GPTConfig(**dict(_gpt2_small_dims(), num_layers=SERVE_FP32_LAYERS),
                              dtype=torch.float32, use_remat=False)
    model32 = gpt.GPT(cfg32, device=device, seed=SERVE_SEED)
    prompts = _serve_prompts(sizes["prompts"], sizes["lo"], sizes["hi"], cfg32.vocab_size,
                             SERVE_SEED)
    batch = prompts[:sizes["batch"]]
    toks, delta32, _, failed, excused = _trace_against_forward(model32, batch, sizes["new"])
    gen_toks, gen_mask, gen_logp = generation.generate(
        model32, None, *generation.left_pad_prompts(batch), None, greedy)
    _check(torch.equal(gen_toks.cpu(), toks.cpu()) and bool(gen_mask.all())
           and bool(torch.isfinite(gen_logp).all()), "generate's tokens differ from the trace's")
    log(f"  (a) fp32, {cfg32.num_layers} layers: decode logits against the teacher-forced "
        f"forward, max diff {delta32:.3e} (tol {SERVE_FP32_TOL}); tokens: {failed} failed, "
        f"{excused} excused")
    _check(delta32 <= SERVE_FP32_TOL, f"fp32 decode logits differ by {delta32}")
    _check(failed == 0, f"{failed} fp32 greedy tokens differ from the forward's argmax")
    one_shot = [_greedy_trace(model32, [p], sizes["new"]) for p in prompts]
    refs = [(t[0].tolist(), lg[0]) for t, lg in one_shot]
    runs = {}
    for name, layout, overlap in (("per_row", "per_row", True), ("frontier", "frontier", True),
                                  ("per_row_sync", "per_row", False)):
        eng = serving.ContinuousBatchingEngine(
            model32, None, greedy, batch_size=sizes["batch"], prompt_width=sizes["width"],
            decode_chunk=sizes["chunk"], cache_layout=layout, overlap=overlap)
        done = eng.run(prompts)
        _check([c.uid for c in done] == list(range(len(prompts))), f"{name}: uids {done}")
        runs[name] = [c.tokens for c in done]
    engine_rule = {name: _rule_over(t, refs, delta32) for name, t in runs.items()}
    log(f"  (a) engine ({len(prompts)} prompts, {sizes['batch']} slots) against one-shot "
        f"generate, (failed, excused): {engine_rule}")
    _check(all(f == 0 for f, _ in engine_rule.values()), f"engine tokens: {engine_rule}")
    _check(runs["per_row_sync"] == runs["per_row"], "the sync round differs from the overlapped")
    frontier = _rule_over(runs["frontier"], [(t, lg) for t, (_, lg) in
                                             zip(runs["per_row"], refs)], delta32)
    _check(frontier[0] == 0, f"frontier against per_row: {frontier}")
    out["fp32"] = {"layers": cfg32.num_layers, "logit_max_diff": delta32,
                   "tol": SERVE_FP32_TOL, "excused_tokens": excused,
                   "engine_against_one_shot": engine_rule, "frontier_against_per_row": frontier,
                   "seconds": time.perf_counter() - t0}
    del model32, one_shot, refs
    if cuda:
        torch.cuda.empty_cache()

    # (b) the user's command, beside the same restored weights in this process
    t0 = time.perf_counter()
    proc, out_path = _start_server(work, job, reference["ckpt_dir"], sizes, small, device)
    try:
        cfg = gpt.GPTConfig(**_serve_config(small))
        model = gpt.GPT(cfg, device=device)
        t_restore = time.perf_counter()
        step, params = tserve._restore_params(model, reference["ckpt_dir"])
        restore_s = time.perf_counter() - t_restore
        restored_hash = params_sha256(params)
        log(f"  (b) restored step {step} in {restore_s:.2f} s; parameters hash-equal to the "
            f"persisted step's: {restored_hash == reference['persisted']['params_sha256']}")
        _check(step == reference["persisted"]["step"],
               f"restored step {step}, persisted {reference['persisted']['step']}")
        _check(restored_hash == reference["persisted"]["params_sha256"],
               "the restored parameters differ from the persisted step's")
        model.load_state_dict(params)
        prompts = _serve_prompts(sizes["prompts"], sizes["lo"], sizes["hi"], cfg.vocab_size,
                                 SERVE_SEED + 1)
        batch = prompts[:sizes["batch"]]
        trace_toks, delta, top, failed, excused = _trace_against_forward(model, batch,
                                                                         sizes["new"])
        tol = SERVE_BF16_REL_TOL * top
        log(f"  (b) bf16 at full width: decode logits against the teacher-forced forward, max "
            f"diff {delta:.3e} (tol {tol:.3e}); tokens: {failed} failed, {excused} excused")
        _check(delta <= tol, f"bf16 decode logits differ by {delta}")
        _check(failed == 0, f"{failed} bf16 greedy tokens differ from the forward's argmax")
        bf16 = _decode_numbers(model, batch, sizes["new"], device)
        eng = serving.ContinuousBatchingEngine(
            model, None, greedy, batch_size=sizes["batch"], prompt_width=sizes["width"],
            decode_chunk=sizes["chunk"], cache_layout="per_row")
        local = eng.run(prompts)
        local_tokens = [c.tokens for c in local]
        local_refs = [(t, _teacher_forced(model, p, t)) for p, t in zip(prompts, local_tokens)]

        # (c) the int8 cache, driven by the exact cache's tokens
        t_int8 = time.perf_counter()
        model8 = gpt.GPT(dc.replace(cfg, kv_cache_int8=True), device=device)
        model8.load_state_dict(params)
        _, exact = _greedy_trace(model, batch, sizes["new"], drive=trace_toks)
        _, quant = _greedy_trace(model8, batch, sizes["new"], drive=trace_toks)
        cos = torch.nn.functional.cosine_similarity(exact, quant, dim=-1)
        int8 = _decode_numbers(model8, batch, sizes["new"], device)
        log(f"  (c) int8 cache against the exact one: min cosine {float(cos.min()):.6f} "
            f"(bound {SERVE_INT8_COS})")
        _check(bool((cos > SERVE_INT8_COS).all()), f"int8 cosine {float(cos.min())}")
        int8.update(min_cosine=float(cos.min()), seconds=time.perf_counter() - t_int8)
        cache_bytes = {"bf16": _cache_bytes(model, sizes["batch"]),
                       "int8": _cache_bytes(model8, sizes["batch"])}
        del model8, exact, quant

        # the server: concurrent completions, a reload, a stream, /healthz
        rec = _server_line(proc, out_path, work, time.monotonic() + SERVE_BOOT_S)
        port = rec["port"]
        _check(rec["step"] == step, f"the server restored step {rec['step']}")
        _check(torch.device(rec["device"]).type == torch_device_type(device),
               f"the server runs on {rec['device']}")
        t_http = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as pool:
            answers = list(pool.map(
                lambda p: _http(port, "POST", "/v1/completions", {"prompt": p}), prompts))
        http_s = time.perf_counter() - t_http
        _check(all(code == 200 for code, _ in answers), f"completions: {answers[:2]}")
        served = [a["tokens"] for _, a in answers]
        server_rule = _rule_over(served, local_refs, delta)
        code, health = _http(port, "GET", "/healthz")  # the burst's window
        _check(code == 200 and health["completed_total"] == len(prompts),
               f"/healthz: {code} {health}")
        code, reload = _http(port, "POST", "/v1/weights/reload", {})
        _check(code == 200 and reload["step"] == step, f"reload: {code} {reload}")
        code, lines = _http(port, "POST", "/v1/completions", {"prompt": prompts[0],
                                                              "stream": True})
        _check(code == 200 and lines[-1].get("done"), f"stream: {code} {lines[-1:]}")
        streamed = [t for ln in lines[:-1] for t in ln["tokens"]]
        _check(streamed == lines[-1]["tokens"], "the stream's chunks differ from its completion")
        stream_rule = _token_rule(lines[-1]["tokens"], *local_refs[0], delta)
        code, after = _http(port, "GET", "/healthz")
        _check(code == 200 and after["completed_total"] == len(prompts) + 1
               and after["last_swap_latency_s"] is not None, f"/healthz: {code} {after}")
        code, bad = _http(port, "POST", "/v1/completions", {"prompt": "x"})
        _check(code == 400, f"a bad prompt gave {code}")
        log(f"  (b) the server: {len(prompts)} concurrent completions in {http_s:.2f} s, "
            f"(failed, excused) against this process's engine {server_rule}, the stream "
            f"after the reload {stream_rule}; /healthz tokens_per_s {health['tokens_per_s']}, "
            f"latency p50 {health['latency_p50_s']} s, p95 {health['latency_p95_s']} s")
        _check(server_rule[0] == 0 and stream_rule[0] == 0,
               f"server tokens: {server_rule}, stream {stream_rule}")
        ttft = sorted(a["ttft_s"] for _, a in answers)
    finally:
        if proc.poll() is None:
            os.kill(proc.pid, signal.SIGTERM)
        try:
            rc = proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(30)
        leaked, segments = _reap_leftovers([proc.pid], [proc.pid], [f"tpurun_serve_{proc.pid}"])
    log(f"  (b) the server exited {rc} on SIGTERM; left behind: {leaked} {segments}")
    if rc != 0:
        with open(os.path.join(work, "serve.err")) as f:
            raise AssertionError(f"the server exited {rc} on SIGTERM:\n{f.read()[-4000:]}")
    _check(not leaked and not segments, f"left behind: {leaked} {segments}")
    out["serve"] = {
        "restored_step": step, "restore_s": restore_s, "logit_max_diff": delta, "tol": tol,
        "excused_tokens": excused, "server_against_engine": server_rule,
        "stream_against_engine": stream_rule, "reload_swap_latency_s": reload["swap_latency_s"],
        "completions": len(prompts), "http_s": http_s,
        "client_tokens_per_s": sum(len(t) for t in served) / http_s,
        "tokens_per_s": health["tokens_per_s"], "latency_p50_s": health["latency_p50_s"],
        "latency_p95_s": health["latency_p95_s"], "ttft_p50_s": ttft[len(ttft) // 2],
        "serving_host_frac": health["serving_host_frac"],
        "seconds": time.perf_counter() - t0}
    out["decode_bf16"], out["decode_int8"], out["cache_bytes"] = bf16, int8, cache_bytes
    del model, params
    if cuda:
        torch.cuda.empty_cache()

    # (d) Llama-125M's narrow GQA cache on phase 9's weights
    t0 = time.perf_counter()
    base = dict(LLAMA_SMALL if small else LLAMA_125M, attention_impl="dense", use_remat=False)
    lmodel = llama.Llama(llama.LlamaConfig(**base), device=device)
    lmodel.load_state_dict(torch.load(reference["llama_params"], weights_only=True))
    lcfg = lmodel.config
    shape = tuple(generation.init_cache(lmodel, sizes["batch"])["layers"][0]["k"].shape)
    want = (sizes["batch"], lcfg.max_seq_len, lcfg.num_kv_heads, lcfg.head_dim)
    _check(shape == want, f"the Llama cache is {shape}, not {want}")
    lprompts = _serve_prompts(sizes["batch"], sizes["lo"], sizes["hi"], lcfg.vocab_size,
                              SERVE_SEED + 2)
    ltoks, ldelta, ltop, lfailed, lexcused = _trace_against_forward(lmodel, lprompts,
                                                                    sizes["new"])
    gen_toks, gen_mask, _ = generation.generate(
        lmodel, None, *generation.left_pad_prompts(lprompts), None, greedy)
    _check(torch.equal(gen_toks, ltoks) and bool(gen_mask.all()),
           "Llama's generate gives other tokens than its trace")
    ltol = SERVE_BF16_REL_TOL * ltop
    log(f"  (d) Llama, cache {shape} a layer: decode logits against the teacher-forced "
        f"forward, max diff {ldelta:.3e} (tol {ltol:.3e}); tokens: {lfailed} failed, "
        f"{lexcused} excused")
    _check(ldelta <= ltol, f"Llama decode logits differ by {ldelta}")
    _check(lfailed == 0, f"{lfailed} Llama greedy tokens differ from the forward's argmax")
    out["llama"] = {"cache_shape": list(shape), "logit_max_diff": ldelta, "tol": ltol,
                    "excused_tokens": lexcused,
                    "decode": _decode_numbers(lmodel, lprompts, sizes["new"], device),
                    "cache_bytes": _cache_bytes(lmodel, sizes["batch"]),
                    "seconds": time.perf_counter() - t0}
    del lmodel
    if cuda:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _gpu_count() -> int:
    """GPUs of this machine from ``nvidia-smi -L``, without a CUDA context
    in this process (the workers own the devices)."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(ln.startswith("GPU ") for ln in out.stdout.splitlines()) if out.returncode == 0 else 0


MULTI_GPU_STEPS = 20
# the Llama MoE example as a world against the same model as a world of one
LLAMA_MOE_WORLD_TOL = 1e-3


def llama_moe_world(work, job, n, device="cuda", ep=None, timeout=600, gpu_per_rank=False):
    """``examples/llama_moe.py`` as a world of ``n`` processes under the
    agent's env contract (the JAX example's mesh: ep 4 on a multiple of 4
    devices; ``ep`` overrides it), then the same model and global batch
    trained by one process (``--devices n``). Checks: the mesh the world
    printed, every step's loss bit-equal across the ranks and within
    ``LLAMA_MOE_WORLD_TOL`` of the world of one's. Returns both runs'
    losses, the mesh and the largest difference."""
    args = ["--log-every", "1"] + (["--device", "cpu"] if device == "cpu" else []) + (
        ["--ep", str(ep)] if ep else [])
    entry = ["-m", "dlrover_tpu_torch.examples.llama_moe"]

    def run(name, ranks, extra):
        _example_world(work, name, ranks, 0, args + extra, timeout, gpu_per_rank=gpu_per_rank,
                       entry=entry)
        outs = []
        for r in range(ranks):
            with open(os.path.join(work, f"{name}_rank{r}.out")) as f:
                text = f.read()
            outs.append((re.search(r"^mesh: (.*)$", text, re.M).group(1),
                         [float(m.group(1)) for m in re.finditer(r"^step \d+: loss (\S+)$", text,
                                                                  re.M)]))
        return outs

    t0 = time.perf_counter()
    world = run(f"{job}_w", n, [])
    world_s = time.perf_counter() - t0
    (one,) = run(f"{job}_1", 1, ["--devices", str(n)])
    losses = world[0][1]
    _check(losses and all(x == world[0] for x in world), f"the ranks differ: {world}")
    _check(len(one[1]) == len(losses), f"{len(one[1])} world-of-one losses for {len(losses)}")
    diff = max(abs(a - b) for a, b in zip(losses, one[1]))
    _check(diff <= LLAMA_MOE_WORLD_TOL, f"the example's world differs from its world of one by "
                                         f"{diff}: {losses} against {one[1]}")
    return {"ranks": n, "mesh": world[0][0], "losses": losses, "world_of_one_losses": one[1],
            "max_loss_diff": diff, "world_s": world_s}


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
    flash launches a step on the GPU. The example's mesh is fsdp over the
    ranks. With four GPUs or more it then runs phase 11's fsdp=2 x tp=2
    and sp=2 x tp=2 worlds over NCCL, one GPU a rank, at once, against the
    same world of one
    (``layouts_phase``), and the Llama MoE example on the JAX example's mesh
    (ep=4, 8 experts) against the same model as a world of one
    (``llama_moe_world``), and phase 13's pipelined tree at dp2 x pp2 against
    its world of one (``pipeline_world``). Returns the result, with the median step of each
    run and the collectives' parts of each rank's second step; raises on a
    failed check."""
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

    layouts = moe = pipe = None
    if not cpu and nproc >= 4:
        lwork = tempfile.mkdtemp(prefix="chip_smoke_mgw_layouts_")
        try:
            layouts = layouts_phase(lwork, f"{job}_ly", layouts=("fsdp2_tp2", "sp2_tp2"),
                                    gpu_per_rank=True)
            moe = llama_moe_world(lwork, f"{job}_moe", 4, gpu_per_rank=True)
            pipe = pipeline_world(lwork, f"{job}_pp", gpu_per_rank=True)
        finally:
            shutil.rmtree(lwork, ignore_errors=True)
        _check(layouts["backend"] == "nccl", f"layouts backend {layouts['backend']}")
        _check("'ep': 4" in moe["mesh"], f"the MoE example's mesh {moe['mesh']}")
        _check(pipe["backend"] == "nccl" and pipe["mesh"]["pp"] == 2,
               f"the pipeline's backend {pipe['backend']}, mesh {pipe['mesh']}")

    def second(recs):
        (x,) = events(recs, "second_step")
        parts = _step_parts(x)
        return {"all_reduce_s": parts.get("all_reduce_s"), "gather_s": parts.get("gather_s"),
                "reduce_scatter_s": parts.get("reduce_scatter_s"),
                "step_s": sum(v for k, v in parts.items() if k not in COLLECTIVE_PARTS)}

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
        "layouts": layouts,
        "llama_moe": moe,
        "pipeline": pipe,
    }


def main(argv=()) -> int:
    import argparse

    argv = list(argv)
    if argv[:1] == ["--tpurun-no-spare"]:
        return _no_spare_entry(argv[1:])

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trainer",
                        choices=("reference", "kill", "resume", "restore", "bench", "shards",
                                 "layouts", "llama_layouts", "pipeline"),
                        help="run one trainer process of the checkpoint phase, (shards) a "
                             "worker of the sharded-input phase, or (layouts) a rank of the "
                             "parallel-layouts phase")
    parser.add_argument("--layout", choices=tuple(LAYOUTS) + tuple(LLAMA_LAYOUTS),
                        help="the layouts trainers' mesh")
    parser.add_argument("--rung", choices=tuple(PIPE_RUNGS), help="the pipeline trainers' rung")
    parser.add_argument("--ckpt", help="checkpoint directory of the trainer")
    parser.add_argument("--data", help="token file of the shards trainer")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true", help="2-layer model (tests)")
    parser.add_argument("--layers", type=int, help="the shards trainer's depth (GPT-2 small's "
                                                   "width)")
    parser.add_argument("--job-log-dir", help="write each tpurun run's whole output here")
    parser.add_argument("--multi-gpu-world", action="store_true",
                        help="only run the example as a world of one rank per GPU (NCCL) "
                             "and print its result")
    args = parser.parse_args(argv)
    if args.trainer == "shards":
        return shard_trainer(args)
    if args.trainer == "layouts":
        return layouts_trainer(args)
    if args.trainer == "llama_layouts":
        return llama_layouts_trainer(args)
    if args.trainer == "pipeline":
        return pipeline_trainer(args)
    if args.trainer:
        return trainer(args)
    if args.multi_gpu_world:
        print(json.dumps({"multi_gpu_world": multi_gpu_world(
            None if args.device == "cuda" else args.device, args.small)}), flush=True)
        return 0
    return smoke(args.job_log_dir)


@contextlib.contextmanager
def _timed_phase(seconds, name):
    """Record the seconds of the phase ``name`` in ``seconds`` and print them.
    When the phase raises, print ``{"failed_phase": name, "error": ...,
    "phase_seconds": ...}`` on a line of its own and raise again."""
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        seconds[name] = time.perf_counter() - t0
        print(json.dumps({"failed_phase": name, "error": repr(e)[:500],
                          "phase_seconds": seconds}), flush=True)
        raise
    finally:
        seconds[name] = time.perf_counter() - t0
        log(f"{name}: {seconds[name]:.1f} s")


def smoke(job_log_dir=None) -> int:
    # what phase 14 serves: phase 5's storage checkpoint and phase 9's weights
    keep = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        return _smoke(job_log_dir, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)


def _smoke(job_log_dir, keep) -> int:
    import torch

    from dlrover_tpu_torch.common.platform import strict_fp32
    from dlrover_tpu_torch.models import gpt
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import train_step

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    if job_log_dir:
        os.makedirs(job_log_dir, exist_ok=True)
    card = card_line()
    log(f"probe: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    strict_fp32()
    seconds = {}

    with _timed_phase(seconds, "build"):
        fa._lib()
    log(f"build: {_build.library_path('flash_attention')}")

    with _timed_phase(seconds, "kernels"):
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
        layout_runs = []
        for layout_shape in LAYOUT_SHAPES:
            log(f"kernels at {layout_shape}, phase 11's local heads (q, k, v views of one buffer)")
            layout_runs.append((layout_shape, *kernel_phase(fa, layout_shape, gen, timed=True,
                                                             qkv_views=True)))
        log(f"kernels at {LLAMA_TP_SHAPE}, phase 12's local heads under tp (k and v this "
            f"rank's kv groups repeated)")
        llama_tp_checks, llama_tp_times = kernel_phase(fa, LLAMA_TP_SHAPE, gen, timed=True)
        log(f"kernels at {PIPELINE_SHAPE}, phase 13's pipeline stage (a microbatch of 2 rows)")
        pipe_checks, pipe_times = kernel_phase(fa, PIPELINE_SHAPE, gen, timed=True, qkv_views=True)

    with _timed_phase(seconds, "main_path"):
        log("main path: GPT-2 small flash train step")
        result = main_path(fa, gpt, train_step)
        log("main path: " + json.dumps(result))
        torch.cuda.empty_cache()  # the trainers of phase 5 are other processes

    with _timed_phase(seconds, "phase5_checkpoint"):
        log("checkpoint and elastic loop: GPT-2 small through ElasticTrainLoop, SIGKILL, resume")
        work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            facts, numbers = checkpoint_phase(
                work, f"chip_smoke_{os.getpid()}_{int(time.time())}", n_params=result["n_params"])
            # phase 14 serves the newest persisted step (the bench trainer's)
            serve_ckpt = os.path.join(keep, "gpt_ckpt")
            shutil.move(os.path.join(work, "ckpt"), serve_ckpt)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        log("checkpoint and elastic loop: " + json.dumps(facts))
        numbers["main_path_step_s"] = result["step_s"]

    tpurun_times = {}
    for run, warm in (("A", True), ("B", False)):
        with _timed_phase(seconds, f"phase6_tpurun_{run}"):
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

    with _timed_phase(seconds, "phase7_two_node"):
        log(f"two nodes on one card: a master, two agents (elastic_run --nnodes 2), a world of two "
            f"over gloo at {TWO_NODE_LAYERS} layers, a SIGKILL of rank 1's worker and the recovery "
            f"of both nodes")
        # phases 7 and 10's reference: the example at their depth as a world
        # of one in this process
        two_node_ref, two_node_ref_step_s = _example_world_of_one(
            False, "cuda", max(TWO_NODE_STEPS, CHAIN_STEPS), TWO_NODE_LAYERS)
        work = tempfile.mkdtemp(prefix="chip_smoke_two_node_")
        try:
            two_facts, two_numbers = two_node_phase(
                work, f"chip_smoke_2n_{os.getpid()}_{int(time.time())}",
                reference=two_node_ref, card=card, world_of_one_step_s=two_node_ref_step_s,
                job_log=job_log_dir and os.path.join(job_log_dir, "two_node.log"))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        log("two nodes: " + json.dumps(two_facts))

    with _timed_phase(seconds, "phase8_shards"):
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

    # phase 9's parameters after LLAMA_LAYOUT_STEPS steps: phase 12's world of one
    llama_ref = tempfile.mkdtemp(prefix="chip_smoke_llama_ref_")
    try:
        with _timed_phase(seconds, "phase9_llama"):
            log("the Llama family: Llama-125M and its top-2 MoE variant, 10 steps each at batch "
                "16 x seq 1024, and the MoE state through shm into a model built afresh")
            work = tempfile.mkdtemp(prefix="chip_smoke_llama_")
            try:
                llama_numbers = llama_phase(work, f"chip_smoke_llama_{os.getpid()}_{int(time.time())}",
                                            keep_dir=llama_ref)
            finally:
                shutil.rmtree(work, ignore_errors=True)

        with _timed_phase(seconds, "phase10_restore_chain"):
            log("the restore chain: phase 7's job with peer replicas and the durable tier; node 1 "
                "replaced whole restores from node 0's memory, then a world of one restores the "
                "newest durable generation after shm and flash storage are gone")
            work = tempfile.mkdtemp(prefix="chip_smoke_chain_")
            try:
                chain_facts, chain_numbers = restore_chain_phase(
                    work, f"chip_smoke_rc_{os.getpid()}_{int(time.time())}",
                    reference=two_node_ref, card=card,
                    stage_block_s=numbers.get("async_block_s"),
                    job_log=job_log_dir and os.path.join(job_log_dir, "restore_chain.log"))
            finally:
                shutil.rmtree(work, ignore_errors=True)
            log("restore chain: " + json.dumps(chain_facts))

        with _timed_phase(seconds, "phase11_layouts"):
            log("parallel layouts on one card: GPT-2 small at 4 layers under tp=2 (2 ranks, "
                "3 steps), fsdp=2 x tp=2 (4 ranks, 3 steps) and sp=2 x tp=2 (4 ranks, 3 steps, "
                "ring attention) over gloo, staged and restored on the same mesh")
            work = tempfile.mkdtemp(prefix="chip_smoke_layouts_")
            try:
                layouts = layouts_phase(work, f"chip_smoke_ly_{os.getpid()}_{int(time.time())}",
                                        card=card)
            finally:
                shutil.rmtree(work, ignore_errors=True)

        with _timed_phase(seconds, "phase12_llama_layouts"):
            log("the Llama family's layouts on one card: Llama-125M under tp=2 (2 ranks) and sp=2 "
                "(2 ranks, ring attention) and its MoE under fsdp=2 x ep=2 (4 ranks) over gloo, "
                "3 steps each against phase 9; the MoE ranks' durable generation warm-started by "
                "a world of one")
            work = tempfile.mkdtemp(prefix="chip_smoke_llama_layouts_")
            try:
                llama_layouts = llama_layouts_phase(
                    work, f"chip_smoke_lly_{os.getpid()}_{int(time.time())}", card=card,
                    reference={"dense": llama_numbers["dense"]["losses"],
                               "moe": llama_numbers["moe"]["losses"], "params_dir": llama_ref,
                               "yardstick": {v: llama_numbers[v]["dense_twin_update"]
                                             for v in ("dense", "moe")}})
            finally:
                shutil.rmtree(work, ignore_errors=True)
    finally:
        # phase 14 serves phase 9's dense parameters after 3 steps
        llama_params = os.path.join(llama_ref, f"dense_params_{LLAMA_LAYOUT_STEPS}.pt")
        if os.path.exists(llama_params):
            shutil.move(llama_params, keep)
        shutil.rmtree(llama_ref, ignore_errors=True)

    with _timed_phase(seconds, "phase13_pipeline"):
        log("the pipeline axis and the DP->PP trade: GPT-2 small's pipelined tree as a world of "
            "four at dp=4 (3 steps, staged to shm), replanned onto dp1 x pp2 through "
            "load_resharded and trained 4 steps as 4 microbatches, against a world of one")
        work = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
        try:
            pipe = pipeline_phase(work, f"chip_smoke_pp_{os.getpid()}_{int(time.time())}",
                                  card=card)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        log("pipeline: " + json.dumps(pipe))

    with _timed_phase(seconds, "phase14_serve"):
        log("decode and serving: the decode path in fp32 against a teacher-forced forward and "
            "the continuous engine against one-shot generate; the serving command restoring "
            "phase 5's checkpoint and answering concurrent completions over HTTP; the int8 "
            "cache; Llama-125M's GQA cache on phase 9's weights")
        work = tempfile.mkdtemp(prefix="chip_smoke_serve_work_")
        try:
            serving_numbers = serve_phase(
                work, f"chip_smoke_sv_{os.getpid()}_{int(time.time())}", card=card,
                reference={"ckpt_dir": serve_ckpt, "persisted": numbers["persisted"],
                           "llama_params": os.path.join(
                               keep, f"dense_params_{LLAMA_LAYOUT_STEPS}.pt")})
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def base(shape):
        return {k: shape[k] for k in ("B", "T", "H", "D", "causal")}

    def at_shape(shape, shape_checks, shape_times, name):
        b_ms, b_by = bound_ms(*bounds(**base(shape))[name])
        return {"shape": shape, "ms": shape_times[name]["ms"],
                "plain_ms": shape_times[name]["plain_ms"],
                "library_ms": shape_times[name]["library_ms"], "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": max(c[1] for c in shape_checks[name])}

    shape = base(MAIN_SHAPE)
    kernels = []
    for name, (nbytes, flops) in bounds(**shape).items():
        b_ms, b_by = bound_ms(nbytes, flops)
        rows = checks[name] + ragged[name] + llama_checks[name] + llama_tp_checks[name] + \
            pipe_checks[name] + [row for _, c, _ in layout_runs for row in c[name]]
        worst = max(rows, key=lambda c: c[1] / c[2])
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
            # phase 11's and phase 12's launches of one rank-step, by layout
            "launches_layouts": {lay: layouts[lay]["launches_per_rank_step"][name]
                                 for lay in LAYOUTS},
            "launches_llama_layouts": {lay: llama_layouts[lay]["launches_per_rank_step"][name]
                                       for lay in LLAMA_LAYOUTS},
            # phase 13's launches of one rank-step, by rung (each microbatch
            # of the rank's stage)
            "launches_pipeline": {rung: pipe[rung]["launches_per_rank_step"][name]
                                  for rung in PIPE_TRADE},
            "max_abs_err": max(c[1] for c in rows),
            "tol": worst[2], "max_err_over_tol": worst[1] / worst[2],
            "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times[name]["library_ms"],
            "library_call": times[name]["library_call"],
            "shape": shape,
            # the same kernel at phase 9's shape (B*H 192)
            "at_llama_shape": at_shape(LLAMA_SHAPE, llama_checks, llama_times, name),
            # at phase 11's local shapes (q, k, v views)
            "at_layout_shapes": [at_shape(lshape, lchecks, ltimes, name)
                                 for lshape, lchecks, ltimes in layout_runs],
            # at phase 12's local shape under tp (k, v this rank's kv groups repeated)
            "at_llama_tp_shape": at_shape(LLAMA_TP_SHAPE, llama_tp_checks, llama_tp_times, name),
            # at phase 13's stage shape (a microbatch of 2 rows)
            "at_pipeline_shape": at_shape(PIPELINE_SHAPE, pipe_checks, pipe_times, name),
            # the D=64 instance the main path runs; registers at entry (the
            # wgmma kernels' consumers raise theirs with setmaxnreg)
            **{key: binary[(name, shape["D"])][key]
               for key in ("registers", "spill_stores", "hgmma", "utmaldg")},
        })
    seconds["script"] = time.perf_counter() - t_script
    print(json.dumps({"checkpoint": numbers}), flush=True)
    print(json.dumps({"tpurun": tpurun_times}), flush=True)
    print(json.dumps({"two_node": two_numbers}), flush=True)
    print(json.dumps({"shards": shard_numbers}), flush=True)
    print(json.dumps({"llama": llama_numbers}), flush=True)
    print(json.dumps({"restore_chain": chain_numbers}), flush=True)
    print(json.dumps({"layouts": layouts}), flush=True)
    print(json.dumps({"llama_layouts": llama_layouts}), flush=True)
    print(json.dumps({"pipeline": pipe}), flush=True)
    print(json.dumps({"serving": serving_numbers}), flush=True)
    print(json.dumps({"phase_seconds": seconds}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
