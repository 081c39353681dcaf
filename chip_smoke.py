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
   losses must agree with the plain dense attention path on a small batch.

The output ends with the kernel table as one JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}`` as the last line.
"""

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
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
        "batch": batch, "seq_len": seq, "steps": n_steps,
        "first_step_s": step_s[0], "step_s": steady,
        "tokens_per_s": batch * seq / steady,
        "mfu": flops_per_token * batch * seq / steady / PEAK_BF16_FLOPS,
        "losses": losses,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "flash_vs_dense_mean_loss_diff": mean_diff,
    }


def main() -> int:
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
