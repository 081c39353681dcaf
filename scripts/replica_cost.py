"""What peer replicas cost phases 7 and 8 of ``chip_smoke.py``.

In a world of several hosts the checkpoint engine replicates by default
(``replicate=None`` means ``num_hosts > 1``), so phase 7's and phase 8's
two-node jobs push every staged image to the peer. This script runs each
job twice in one process, on one card, alternately with replicas on (the
default) and off (the same trainer with ``CheckpointEngine(replicate=
False)``), and prints one JSON line a job and a summary: the host-clock
step (median and spread), the first steps' all-reduce, the stages each
worker skipped by reason, every persist's and every push's shard-lock
hold and seconds, and how many steps each push's image lagged the newest
trained step when it landed.

    python3 scripts/replica_cost.py [--phases 7,8] [--order on,off,off,on]
        [--out chiprun_out/replica_cost.json] [--device cpu --small]

Without ``--device cpu`` it needs the GPU. The agents run the trainer
with replicas off through this script's worker mode:
``replica_cost.py --worker example|shards <trainer args>``.
"""

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

_LOG_TS = re.compile(r"^\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3})\]")


def _replicas_off() -> None:
    """Make every CheckpointEngine of this process replicate nothing."""
    from dlrover_tpu_torch.checkpoint import engine

    base = engine.CheckpointEngine

    class NoReplicaEngine(base):
        def __init__(self, *args, **kwargs):
            kwargs["replicate"] = False
            super().__init__(*args, **kwargs)

    engine.CheckpointEngine = NoReplicaEngine


def worker(kind: str, argv) -> int:
    """The trainer of phase 7 (``example``) or phase 8 (``shards``) with
    replicas off."""
    _replicas_off()
    if kind == "example":
        from dlrover_tpu_torch.checkpoint import engine
        from dlrover_tpu_torch.examples import gpt_elastic

        gpt_elastic.CheckpointEngine = engine.CheckpointEngine  # bound at its import
        return gpt_elastic.main(argv)
    import chip_smoke

    return chip_smoke.main(["--trainer", "shards"] + list(argv))


def _log_time(line: str):
    """The wall-clock time of a log line of the port's logger, or None."""
    m = _LOG_TS.match(line)
    if m is None:
        return None
    return time.mktime(time.strptime(m.group(1), "%Y-%m-%d %H:%M:%S")) + int(m.group(2)) / 1e3


def _pushes(j):
    """Every push of both first agents: step, bytes, seconds, lock hold, and
    the steps its node's worker had trained past it when it landed."""
    import chip_smoke

    out = []
    for r in (0, 1):
        o = j["all_outs"][r]
        trained = sorted((x["t"], x["step"]) for b in (j["first"][r], j["second"][r])
                         for x in o.events("step", b["pid"]))
        for line in o.lines:
            m = re.search(chip_smoke._PUSH, line)
            if m is None:
                continue
            t = _log_time(line)
            newest = max((s for ts, s in trained if t is not None and ts <= t), default=None)
            out.append({"node": r, "step": int(m.group(1)), "bytes": int(m.group(2)),
                        "push_s": float(m.group(3)), "hold_s": float(m.group(4)),
                        "lag_steps": None if newest is None else newest - int(m.group(1))})
    return out


def _skips(j):
    """The stages each worker skipped, by reason, from its last record."""
    got = {}
    for r in (0, 1):
        o = j["all_outs"][r]
        for inc, b in enumerate((j["first"][r], j["second"][r])):
            recs = o.events("step", b["pid"])
            got[f"node{r}_worker{inc}"] = recs[-1].get("skipped") if recs else None
    return got


def _quantiles(xs):
    xs = sorted(xs)
    if not xs:
        return None
    pick = lambda q: xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]  # noqa: E731
    return {"min": xs[0], "p10": pick(0.1), "median": pick(0.5), "p90": pick(0.9),
            "max": xs[-1], "n": len(xs)}


def run_job(phase: int, replicas: bool, device: str, small: bool, card, timeout: float):
    import chip_smoke

    work = tempfile.mkdtemp(prefix=f"replica_cost_{phase}_")
    job = f"rcost{phase}{'on' if replicas else 'off'}_{os.getpid()}_{int(time.time())}"
    try:
        if phase == 7:
            entry = (chip_smoke.EXAMPLE if replicas
                     else [os.path.abspath(__file__), "--worker", "example"])
        else:
            data = os.path.join(work, "tokens.u16")
            entry = ([os.path.abspath(chip_smoke.__file__), "--trainer", "shards"] if replicas
                     else [os.path.abspath(__file__), "--worker", "shards"]) + ["--data", data]
        j = chip_smoke._two_node_job(work, job, entry, device, small, chip_smoke.TPURUN_STEPS,
                                     chip_smoke.TWO_NODE_KILL_AFTER, timeout, None)
        numbers = chip_smoke._two_node_numbers(j, card, small, chip_smoke.TPURUN_STEPS)
        steps = [t for r in (0, 1) for b in (j["first"][r], j["second"][r])
                 for t in chip_smoke._step_seconds(j["all_outs"][r].events("step", b["pid"]))]
        pushes = _pushes(j)
        split = [{k: v for k, v in x.items() if k.endswith("_s")}
                 for o in j["outs"] for x in o.events("second_step")]
        return {
            "phase": phase, "replicas": replicas, "card": card,
            "step_s": _quantiles(steps),
            "second_step_split": split,
            "first_step_all_reduce_s": [x.get("all_reduce_s") for o in j["outs"]
                                        for x in o.events("first_step")],
            "skipped_stages": _skips(j),
            "persists": numbers["persists"],
            "pushes": pushes,
            "push_hold_s": _quantiles([p["hold_s"] for p in pushes]),
            "push_s": _quantiles([p["push_s"] for p in pushes]),
            "push_lag_steps": _quantiles([p["lag_steps"] for p in pushes
                                          if p["lag_steps"] is not None]),
            "persist_hold_s": _quantiles([p["hold_s"] for p in numbers["persists"]]),
            "recovery": numbers["recovery"], "resumed_step": j["resumed"],
            "restored_from": j["sources"],
            "mem_gb_total_peak_rss": numbers["mem_gb_total_peak_rss"],
            "job_s": numbers["job_s"], "launches": j["launches"],
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return worker(argv[1], argv[2:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="7,8")
    parser.add_argument("--order", default="on,off,off,on",
                        help="replicas on/off, one job each, per phase")
    parser.add_argument("--out", default=os.path.join("chiprun_out", "replica_cost.json"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--timeout", type=float, default=600)
    args = parser.parse_args(argv)
    import torch

    import chip_smoke

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("replica_cost: no GPU", file=sys.stderr)
            return 1
        from dlrover_tpu_torch.ops import flash_attention as fa

        fa._lib()  # built once here, from the build cache in the workers
    card = chip_smoke.card_line() if args.device == "cuda" else None
    results = []
    for phase in [int(p) for p in args.phases.split(",")]:
        for which in args.order.split(","):
            res = run_job(phase, which == "on", args.device, args.small, card, args.timeout)
            print(json.dumps({"replica_cost": {k: v for k, v in res.items() if k != "pushes"}}),
                  flush=True)
            results.append(res)
    summary = {}
    for res in results:
        key = f"phase{res['phase']}_{'on' if res['replicas'] else 'off'}"
        summary.setdefault(key, []).append({
            "median_step_s": res["step_s"]["median"] if res["step_s"] else None,
            "skipped": res["skipped_stages"],
            "push_hold_median_s": (res["push_hold_s"] or {}).get("median"),
            "push_lag_median_steps": (res["push_lag_steps"] or {}).get("median")})
    print(json.dumps({"replica_cost_summary": summary, "card": card}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
