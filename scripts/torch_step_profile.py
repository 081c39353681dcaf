#!/usr/bin/env python3
"""Where the time of the PyTorch port's GPT-2 small train step goes, on one GPU.

    python3 scripts/torch_step_profile.py [--steps 4] [--batch 8]

Builds the same main path as chip_smoke.py (GPT-2 small at full width,
flash attention, remat, seq 1024, seeded random tokens) and warms it up.
Then it times ``--timed`` steps with the profiler off (host clock, each
step ending in a synchronising loss fetch) and runs ``--steps`` more under
``torch.profiler``. From the profiler's Chrome trace (written to
``--trace``, by default ``profiles/torch_step_trace.json``) it sums the
device time of every kernel, memcpy and memset per step, in buckets (the
three flash kernels, matrix products, softmax, reductions, optimizer,
other elementwise work), and the device busy share two ways: the union of
device intervals over the profiled span (the profiler slows the host, so
this reads low), and device time per step over the unprofiled step time.
Exits non-zero without a GPU.
"""

import argparse
import collections
import json
import os
import statistics
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _bucket(name: str) -> str:
    for kernel in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        if f"{kernel}_kernel" in name:
            return kernel
    lowered = name.lower()
    if any(s in lowered for s in ("gemm", "xmma", "cutlass", "nvjet", "wgmma")):
        return "matmul"
    if "softmax" in lowered:
        return "softmax"
    if "reduce" in lowered:
        return "reduction"
    if "foreach" in lowered or "multi_tensor" in lowered:
        return "optimizer"
    return "other_elementwise"


def trace_summary(trace_path: str, steps: int):
    """Device time per step by bucket and by name, busy union and span."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") in _DEVICE_CATS]
    by_name = collections.Counter()
    for e in events:
        by_name[e["name"]] += e["dur"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    buckets = collections.Counter()
    for name, us in by_name.items():
        buckets[_bucket(name)] += us
    return {
        "device_ms_per_step": sum(by_name.values()) / 1e3 / steps,
        "busy_ms_per_step": busy / 1e3 / steps,
        "span_ms_per_step": (spans[-1][1] - spans[0][0]) / 1e3 / steps,
        "buckets_ms_per_step": {b: us / 1e3 / steps for b, us in buckets.most_common()},
        "top": [(us / 1e3 / steps, name) for name, us in by_name.most_common(15)],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=4, help="profiled steps")
    parser.add_argument("--timed", type=int, default=6, help="unprofiled timed steps")
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=1024)
    parser.add_argument(
        "--trace", default=os.path.join(_REPO, "profiles", "torch_step_trace.json")
    )
    args = parser.parse_args()

    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.common.platform import strict_fp32
    from dlrover_tpu_torch.models import gpt
    from dlrover_tpu_torch.parallel import train_step

    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    strict_fp32()
    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(), attention_impl="flash",
                              max_seq_len=args.seq, use_remat=True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (args.batch, args.seq))).cuda()
    targets = torch.roll(tokens, -1, dims=1)
    model = gpt.GPT(cfg)
    tx = train_step.default_optimizer()
    state = train_step.init_train_state(model, tokens, tx, seed=0)
    step_fn = train_step.build_train_step(model, tx, gpt.cross_entropy_loss)

    def timed_steps(n):
        nonlocal state
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            state, loss = step_fn(state, tokens, targets)
            float(loss)  # synchronises
            times.append(time.perf_counter() - t0)
        return times

    timed_steps(args.warmup)
    step_s = timed_steps(args.timed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = timed_steps(args.steps)
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    summary = trace_summary(args.trace, args.steps)

    print("top device time (ms per step, name):")
    for ms, name in summary.pop("top"):
        print(f"  {ms:8.3f}  {name[:110]}")
    # which PyTorch ops launched that device time (kernels attributed to
    # the op that launched them directly)
    ops = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if ev.key.startswith("aten::") and dev_us > 0:
            ops.append((dev_us / 1e3 / args.steps, ev.count / args.steps, ev.key))
    print("top PyTorch ops by device time they launched (ms per step, calls per step, op):")
    for ms, calls, name in sorted(ops, reverse=True)[:12]:
        print(f"  {ms:8.3f}  {calls:6.1f}  {name}")
    step = statistics.median(step_s)
    summary.update({
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch, "seq_len": args.seq,
        "step_s_median": step, "step_s": step_s, "profiled_step_s": profiled_s,
        "busy_share_profiled": summary["busy_ms_per_step"] / summary["span_ms_per_step"],
        "busy_share_vs_unprofiled_step": summary["busy_ms_per_step"] / 1e3 / step,
    })
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
