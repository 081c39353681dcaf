#!/usr/bin/env python3
"""Times versions of the port's flash-attention kernels against each other on one GPU.

    python3 scripts/kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (or ``git archive``) holding ``dlrover_tpu_torch``;
``.`` is this tree. Every ROOT's ``csrc/flash_attention.cu`` is built by its
own ``_build`` in a child process; then this process loads all the libraries
and times them through this tree's wrappers, which is sound while the C
interface is the same. Timing alternates between the versions in 8 rounds
(forward, then reversed order), each round the median of 9 samples of 10
back-to-back launches by CUDA events, at the training shape (B=8, T=1024,
H=12, D=64, causal). Two versions compared in one process on one card see
the same clocks and neighbours; across calls the same kernel can read
differently. Prints each version's forward and dQ errors against the plain
versions (at this tree's ``kernel_tiles``), then per kernel (forward, dK/dV,
dQ) the median over rounds and every round's value, then the card's name,
power limit and SM clock. Exits non-zero without a GPU.
"""

import ctypes
import math
import os
import statistics
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from dlrover_tpu_torch.ops import _build; print(_build.build(['flash_attention'])[0])")
SHAPE = dict(B=8, T=1024, H=12, D=64, causal=True)


def time_ms(fn, warmup=3, samples=9, reps=10):
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


def load(path):
    """A built library with the C signatures ``flash_attention._lib`` sets."""
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i, i, i, i, i, f, i, p]
    lib.flash_fwd.argtypes = [p] * 5 + [i] * 9 + tail
    lib.flash_bwd_dq.argtypes = [p] * 7 + [i] * 12 + tail
    lib.flash_bwd_dkdv.argtypes = [p] * 8 + [i] * 12 + tail
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkdv):
        fn.restype = i
    lib.flash_error_string.argtypes = [i]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    import torch

    from dlrover_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = sys.argv[1:]
    libs = {}
    for root in roots:
        out = subprocess.run([sys.executable, "-c", _BUILD, os.path.abspath(root)],
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            print(f"build failed for {root}:\n{out.stderr[-3000:]}", file=sys.stderr)
            return 1
        libs[root] = load(out.stdout.strip().splitlines()[-1])

    B, T, H, D, causal = (SHAPE[k] for k in ("B", "T", "H", "D", "causal"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((B, T, H, D), device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    b3 = fa._to_bht
    out3, lse3 = fa.flash_fwd_plain(b3(q), b3(k), b3(v), scale, causal,
                                    *fa.kernel_tiles("fwd", D))
    # the backward's residuals from the plain forward, the same for every version
    delta = fa.delta_bh(do, fa._from_bht(out3, B, H))
    args = (q, k, v, do, lse3.contiguous(), delta, scale, causal)
    dq3 = fa.flash_bwd_dq_plain(b3(q), b3(k), b3(v), b3(do), lse3, delta, scale, causal,
                                *fa.kernel_tiles("bwd_dq", D))
    for root, lib in libs.items():
        fa._lib = lambda lib=lib: lib
        out, _ = fa.flash_fwd_cuda(q, k, v, scale, causal)
        dq = fa.flash_bwd_dq_cuda(*args)
        print(root, "forward max_abs_err", float((b3(out).float() - out3.float()).abs().max()),
              "dq max_abs_err", float((b3(dq).float() - dq3.float()).abs().max()))

    kernels = {
        "fwd": lambda: fa.flash_fwd_cuda(q, k, v, scale, causal),
        "bwd_dkdv": lambda: fa.flash_bwd_dkdv_cuda(*args),
        "bwd_dq": lambda: fa.flash_bwd_dq_cuda(*args),
    }
    times = {root: {name: [] for name in kernels} for root in roots}
    for rnd in range(8):
        for root in roots if rnd % 2 == 0 else roots[::-1]:
            fa._lib = lambda lib=libs[root]: lib
            for name, fn in kernels.items():
                times[root][name].append(time_ms(fn))
    for root in roots:
        print(root, {name: (statistics.median(t), [round(x, 4) for x in t])
                     for name, t in times[root].items()})
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                    "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
