#!/usr/bin/env python3
"""Where the first training step of a fresh worker process goes, on one GPU.

    python3 scripts/first_step_split.py [--out FILE]

A restarted worker of the flagship job spends most of its first step in
the first forward (``examples/gpt_elastic.py``'s ``first_step`` record).
This script builds the same model and data (``gpt_elastic.build``: GPT-2
small at full width, flash attention, remat, seq 1024, batch 8) in fresh
child processes, one per mode, and times with device synchronisations:

- ``model``: what a worker does: CUDA init, build, then the first and the
  second forward, backward and optimizer step;
- ``parts``: the first call of each ingredient before the model's first
  step (4 GiB allocated, 4 GiB zeroed, a bf16 matrix product, the flash
  forward kernel, the last two called twice), then the model's steps:
  what is left of the first forward is neither of those;
- ``eager``: ``model`` with ``CUDA_MODULE_LOADING=EAGER``, which loads
  every kernel of the process's libraries when the context is made;
- ``profile``: ``model`` with the first step under ``torch.profiler``:
  the operators that took the most host time in it (self time, so a
  parent operator's children are not counted twice);
- ``pyprofile``: ``model`` with the first step under ``cProfile``: the
  Python functions with the most cumulative time in it, for host work
  that no operator accounts for (imports, first-call set-up);
- ``dynamo``: ``model`` after importing ``torch._dynamo`` before CUDA
  init, as the warm spare does: the import's time, the /dev/nvidia* files
  the process holds after it, and the first step without the import.

The kernel library is built (or found in the build cache) before the
children start, as a restarted worker finds it. Prints one JSON object
per mode and writes them to ``--out`` as a list. Exits non-zero without a
GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

MODES = ("model", "parts", "eager", "profile", "pyprofile", "dynamo")


def _nvidia_fds():
    held = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            held.append(target)
    return sorted(held)


def child(mode: str) -> dict:
    t_start = time.perf_counter()
    import torch

    from dlrover_tpu_torch.examples import gpt_elastic
    from dlrover_tpu_torch.ops import flash_attention as fa

    out = {"mode": mode, "module_loading": os.environ.get("CUDA_MODULE_LOADING", "default"),
           "import_s": time.perf_counter() - t_start}
    device = torch.device("cuda", 0)

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        out[name] = time.perf_counter() - t0

    if mode == "dynamo":
        t0 = time.perf_counter()
        import torch._dynamo  # noqa: F401

        out["import_dynamo_s"] = time.perf_counter() - t0
        out["nvidia_fds_after_import"] = _nvidia_fds()
    timed("cuda_init_s", lambda: torch.empty(1, device=device))
    if mode == "parts":
        timed("alloc_4gib_first_s", lambda: torch.empty(4 << 30, dtype=torch.uint8, device=device))
        timed("alloc_touch_4gib_s", lambda: torch.zeros(4 << 30, dtype=torch.uint8, device=device))
        a = torch.randn(8192, 768, device=device, dtype=torch.bfloat16)
        b = torch.randn(768, 3072, device=device, dtype=torch.bfloat16)
        timed("matmul_first_s", lambda: a @ b)
        timed("matmul_second_s", lambda: a @ b)
        q = torch.randn(8, 1024, 12, 64, device=device, dtype=torch.bfloat16)
        timed("flash_fwd_first_s", lambda: fa.flash_attention(q, q, q, causal=True))
        timed("flash_fwd_second_s", lambda: fa.flash_attention(q, q, q, causal=True))
        del a, b, q
    t0 = time.perf_counter()
    _, state, step_fn, batches = gpt_elastic.build(False, device)
    torch.cuda.synchronize(device)
    out["model_build_s"] = time.perf_counter() - t0
    for i, (x, y) in enumerate(batches(0, 2)):
        x, y = x.to(device), y.to(device)
        stamp = [time.perf_counter()]

        def mark(part, i=i):
            torch.cuda.synchronize(device)
            now = time.perf_counter()
            out[f"step{i}_{part}_s"] = out.get(f"step{i}_{part}_s", 0.0) + now - stamp[0]
            stamp[0] = now

        if mode == "profile" and i == 0:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, loss = step_fn(state, x, y, mark=mark)
                float(loss)
            ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
            out["top_self_cpu_ops_s"] = [(e.key, e.count, e.self_cpu_time_total / 1e6)
                                         for e in ops[:15]]
            continue
        if mode == "pyprofile" and i == 0:
            import cProfile
            import pstats

            prof = cProfile.Profile()
            prof.enable()
            state, loss = step_fn(state, x, y, mark=mark)
            float(loss)
            prof.disable()
            stats = pstats.Stats(prof).sort_stats("cumulative").stats
            top = sorted(stats.items(), key=lambda kv: kv[1][3], reverse=True)[:40]
            out["top_cumulative_s"] = [(f"{os.path.basename(f)}:{line}:{fn}", calls, cum)
                                       for (f, line, fn), (_, calls, _, cum, _) in top]
            continue
        state, loss = step_fn(state, x, y, mark=mark)
        float(loss)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--child", choices=MODES, help=argparse.SUPPRESS)
    parser.add_argument("--out", default=os.path.join(_REPO, "profiles", "first_step_split.json"))
    args = parser.parse_args()
    if args.child:
        print("RESULT " + json.dumps(child(args.child)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("first_step_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    from dlrover_tpu_torch.ops import _build

    _build.build(["flash_attention"])
    results = []
    for mode in MODES:
        env = dict(os.environ)
        if mode == "eager":
            env["CUDA_MODULE_LOADING"] = "EAGER"
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", mode],
                              capture_output=True, text=True, timeout=600, env=env)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        result = {"card": card, **json.loads(lines[-1][len("RESULT "):])}
        results.append(result)
        print(json.dumps(result), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
