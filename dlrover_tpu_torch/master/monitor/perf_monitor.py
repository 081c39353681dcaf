"""Training performance monitor: the port of
``dlrover_tpu/master/monitor/perf_monitor.py``.

Tracks the global step from the trainers' step reports and derives step
speed and goodput. Goodput is measured, not assumed: each step interval is
credited as productive up to a tolerance over the running median step
time, so rendezvous rounds, restarts and hangs show up as the gap between
productive and wall-clock time.
"""

import statistics
import threading
import time
from collections import deque
from typing import Deque, Tuple

# A step interval beyond this multiple of the median step time is
# downtime; only one median's worth of it was training.
_STALL_TOLERANCE = 3.0
# The first interval has no median to judge it by (and includes the
# warm-up); credit at most this much of it.
_FIRST_INTERVAL_CAP_S = 120.0


class PerfMonitor:
    def __init__(self, window: int = 64):
        self._lock = threading.Lock()
        self._samples: Deque[Tuple[int, float]] = deque(maxlen=window)
        self._start_time = time.time()
        self._productive_s = 0.0
        self._step_dts: Deque[float] = deque(maxlen=window)
        self._first_sample_ts = 0.0  # the first step report ever

    def collect_global_step(self, step: int, timestamp: float = 0.0) -> None:
        timestamp = timestamp or time.time()
        with self._lock:
            if self._samples and step <= self._samples[-1][0]:
                return
            if self._samples:
                # monotonic: a lagging reporter clock must not rewind the
                # baseline and have the next interval count twice
                timestamp = max(timestamp, self._samples[-1][1])
                dt = timestamp - self._samples[-1][1]
                if dt > 0:
                    if self._step_dts:
                        median = statistics.median(self._step_dts)
                        if dt <= _STALL_TOLERANCE * median:
                            self._step_dts.append(dt)
                            self._productive_s += dt
                        else:
                            # a stall: the step cost about a median, the
                            # rest was downtime
                            self._productive_s += median
                    else:
                        credited = min(dt, _FIRST_INTERVAL_CAP_S)
                        self._step_dts.append(credited)
                        self._productive_s += credited
            if not self._first_sample_ts:
                self._first_sample_ts = timestamp
            self._samples.append((step, timestamp))

    def goodput(self) -> float:
        """Productive fraction of the wall time since the monitor (about the
        job) started; 0.0 until the first step interval lands."""
        return self._goodput(since_first_step=False)

    def training_goodput(self) -> float:
        """Productive fraction of the wall time since the first step
        report: provisioning is left out."""
        return self._goodput(since_first_step=True)

    def _goodput(self, since_first_step: bool) -> float:
        with self._lock:
            now = time.time()
            if self._samples:
                now = max(now, self._samples[-1][1])
            start = self._start_time
            if since_first_step and self._first_sample_ts:
                start = max(start, self._first_sample_ts)
            elapsed = now - start
            if elapsed <= 0 or self._productive_s <= 0:
                return 0.0
            return min(1.0, self._productive_s / elapsed)

    def steps_per_second(self) -> float:
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            s0, t0 = self._samples[0]
            s1, t1 = self._samples[-1]
            if t1 <= t0:
                return 0.0
            return (s1 - s0) / (t1 - t0)

    def last_step(self) -> Tuple[int, float]:
        with self._lock:
            return self._samples[-1] if self._samples else (0, 0.0)
