"""The fixed-bound latency histogram the serving front end keeps its
always-on distributions in (`Predictor.stats()` reads it).

The port's counterpart of `Histogram` in
`lightgbm_tpu/telemetry/metrics.py`. The JAX package's `tracing`
counters and spans, their `LGBM_TPU_TIMETAG` switch and their export
(`lightgbm_tpu/telemetry/`) come with the slice that ports the export:
until something reads them, the port keeps its counts in the local
`stats()` of each serving component.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Optional


class Histogram:
    """Fixed-bound bucketed histogram (`buckets[i]` counts observations
    <= bounds[i], with a +Inf overflow bucket); quantiles interpolate
    linearly inside the winning bucket, clamped to the observed range.
    Safe for concurrent observers (the serving threads). The same
    instrument as `lightgbm_tpu/telemetry/metrics.Histogram`."""

    def __init__(self, bounds: Iterable[float]):
        self.bounds = tuple(sorted(float(b) for b in bounds))
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.buckets[i] += 1
            self.count += 1
            self.sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0..1); None with no observations."""
        with self._lock:
            if self.count == 0:
                return None
            rank = q * self.count
            cum = 0
            for i, c in enumerate(self.buckets):
                if c == 0:
                    continue
                prev_cum = cum
                cum += c
                if cum >= rank:
                    lo = self.bounds[i - 1] if i > 0 else self._min
                    hi = self.bounds[i] if i < len(self.bounds) else self._max
                    est = lo + (hi - lo) * (rank - prev_cum) / c
                    return min(max(est, self._min), self._max)
            return self._max

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "min": self._min, "max": self._max}
