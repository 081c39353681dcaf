"""Serving host/device split: scheduler-round phase accounting. The port of
``dlrover_tpu/attribution/phases.py``, pure Python and copied whole, with the
same names, phases and reductions.

The continuous-batching engine's ``step()`` (``models/serving.py``) stamps
its phase spans per scheduler round:

- ``admission``   host: queue pop, slot bookkeeping, swap adoption
- ``prefill``     device: prompt prefill and the admit insert (and the
                  compaction re-prefills of the frontier layout)
- ``decode_dispatch``  host: enqueueing the decode chunk's operations
- ``host_sync``   device: the blocking wait for the chunk's tokens; it
                  measures device execution the host did not overlap
- ``retirement``  host: emit loop, completion bookkeeping
- ``overlap_hidden``  host work (admission, emission, retirement) done
                  WHILE a decode chunk is in flight on the device: neither
                  host nor device time, the host cost the double-buffered
                  round hid.

``serving_host_frac`` = host time / total: the fraction of a serving round
the device sits idle while the host schedules. Overlap-hidden time counts
toward the total but not toward host. The accumulator is pure arithmetic
over (phase, seconds) samples, so the split is testable on synthetic
timestamps without an engine. The gateway and pool phases of the JAX
module are kept, so that the two packages reduce the same names.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

PHASES = (
    "admission",
    "prefill",
    "decode_dispatch",
    "host_sync",
    "retirement",
    "overlap_hidden",
)
# Fleet gateway phases (dlrover_tpu/fleet/gateway.py) — a SEPARATE
# accumulator from the engine's: "route" and "redispatch" are
# gateway-host work (replica selection, failover bookkeeping);
# "proxy" is time spent waiting on the chosen replica's engine — the
# gateway's equivalent of device time, so a gateway accumulator's
# serving_host_frac reads as gateway overhead over end-to-end request
# time.
GATEWAY_PHASES = (
    "route",
    "proxy",
    "redispatch",
)
# Chip-pool arbiter phases (dlrover_tpu/pool/arbiter.py) — a third
# separate accumulator: "revoke" and "grant" are arbiter-host work
# (ledger transitions, dispatching the tenant call); "drain" is the
# wall time waiting on the tenant's cooperative reclaim (checkpointed
# training shrink, replica drain) — the arbiter's equivalent of
# backend time, so its host_frac reads as arbitration overhead over
# end-to-end capacity-move latency.
POOL_PHASES = (
    "revoke",
    "drain",
    "grant",
)
HOST_PHASES = frozenset(
    {
        "admission",
        "decode_dispatch",
        "retirement",
        "route",
        "redispatch",
        "revoke",
        "grant",
    }
)
DEVICE_PHASES = frozenset({"prefill", "host_sync", "proxy", "drain"})
OVERLAP_PHASES = frozenset({"overlap_hidden"})

# log2(µs) histogram: bucket i covers [2^i, 2^(i+1)) µs; 20 buckets
# reach ~10 min — far past any sane phase span.
HIST_BUCKETS = 20


@dataclass
class PhaseStat:
    total_s: float = 0.0
    count: int = 0
    max_s: float = 0.0
    hist: List[int] = field(default_factory=lambda: [0] * HIST_BUCKETS)


@dataclass
class PhaseSplit:
    """One reduction of an accumulator: totals, fractions, histogram."""

    total_s: float
    host_s: float
    device_s: float
    serving_host_frac: float
    rounds: int
    phases: Dict[str, Dict]
    # host time hidden behind in-flight device chunks (the pipelined
    # scheduler's round): in total_s, in neither host_s nor device_s
    overlap_s: float = 0.0

    def summary(self) -> Dict:
        """Compact dict for /healthz and bench extras (floats only,
        bounded key count — the 1,800-byte line budget applies)."""
        out = {
            "serving_host_frac": round(self.serving_host_frac, 4),
            "rounds": self.rounds,
        }
        if self.overlap_s:
            out["overlap_hidden_s"] = round(self.overlap_s, 4)
        for name, stat in self.phases.items():
            out[f"{name}_ms"] = round(stat["total_s"] * 1e3, 2)
        return out


def _hist_bucket(dur_s: float) -> int:
    us = dur_s * 1e6
    if us < 1.0:
        return 0
    return min(int(math.log2(us)), HIST_BUCKETS - 1)


class PhaseAccumulator:
    """Running per-phase totals + log2-µs histograms. ``add`` is a few
    dict ops — cheap enough to leave always-on in the serving engine
    (one call per phase per scheduler round, not per token)."""

    def __init__(self):
        self._stats: Dict[str, PhaseStat] = {}
        self.rounds = 0

    def add(self, phase: str, dur_s: float) -> None:
        if dur_s < 0:
            dur_s = 0.0
        stat = self._stats.setdefault(phase, PhaseStat())
        stat.total_s += dur_s
        stat.count += 1
        stat.max_s = max(stat.max_s, dur_s)
        stat.hist[_hist_bucket(dur_s)] += 1

    def add_round(
        self, spans: List[Tuple[str, float]]
    ) -> None:
        """One scheduler round's (phase, seconds) spans — the synthetic
        -timestamp entry point the tests drive."""
        for phase, dur_s in spans:
            self.add(phase, dur_s)
        self.rounds += 1

    def reset(self) -> None:
        self._stats.clear()
        self.rounds = 0

    def split(self) -> PhaseSplit:
        # snapshot first: split() is read from other threads (/healthz
        # handler) while the driver's step() inserts phase keys —
        # dict(d) is a single C-level copy under the GIL, so the
        # iteration below never sees a resize
        stats = dict(self._stats)
        host_s = sum(
            s.total_s for p, s in stats.items() if p in HOST_PHASES
        )
        overlap_s = sum(
            s.total_s for p, s in stats.items() if p in OVERLAP_PHASES
        )
        device_s = sum(
            s.total_s for p, s in stats.items()
            if p not in HOST_PHASES and p not in OVERLAP_PHASES
        )
        total_s = host_s + device_s + overlap_s
        return PhaseSplit(
            total_s=total_s,
            host_s=host_s,
            device_s=device_s,
            overlap_s=overlap_s,
            serving_host_frac=(host_s / total_s) if total_s > 0 else 0.0,
            rounds=self.rounds,
            phases={
                name: {
                    "total_s": round(stat.total_s, 6),
                    "count": stat.count,
                    "mean_ms": round(
                        stat.total_s / stat.count * 1e3, 3
                    )
                    if stat.count
                    else 0.0,
                    "max_ms": round(stat.max_s * 1e3, 3),
                    "host": name in HOST_PHASES,
                    "hist_log2us": list(stat.hist),
                }
                for name, stat in stats.items()
            },
        )
