"""Admission control for the serving front end: bounded queues,
deadlines and EWMA-based load shedding.

The port's copy of the per-predictor half of
`lightgbm_tpu/serving/admission.py`, with the same defaults (every cap
0 = off, the unbounded behaviour): past saturation an unbounded queue
answers every request late, so the controller refuses the requests it
cannot answer in time IMMEDIATELY, with a structured, retriable
`ServingOverload` / `DeadlineExceeded`. Shedding changes whether a
request is answered, never what is answered. The registry's per-model
pieces (`TokenBucket`, `CircuitBreaker`) and the run-log overload event
wait for the registry and telemetry slices, and so does the JAX
package's mirror of the counters into `tracing` counters.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from .. import log


class ServingOverload(log.LightGBMError):
    """A request refused by admission control. Always retriable: the
    refusal is about the server's CURRENT load, not about the request.

    `reason` is machine-readable: "queue_full", "inflight_full",
    "shed" (EWMA queue wait already exceeds the deadline), "deadline"
    (expired in the queue), "shutdown" (predictor closing; retry against
    another replica)."""

    retriable = True

    def __init__(self, message: str, reason: str = "overload",
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.reason = str(reason)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(ServingOverload):
    """The request's deadline expired before device dispatch (it would
    have been answered late; failing it in the queue burns no device
    time and unblocks the caller's retry immediately)."""

    def __init__(self, message: str, deadline_ms: Optional[float] = None,
                 waited_ms: Optional[float] = None):
        super().__init__(message, reason="deadline")
        self.deadline_ms = deadline_ms
        self.waited_ms = waited_ms


class PredictorShutdown(ServingOverload):
    """The predictor is closed (`close()` drained it, or the process is
    shutting down). The message contains "closed" by contract, as in the
    JAX package, whose model registry re-routes on it."""

    def __init__(self, message: str = "Predictor is closed "
                 "(shutting down; retry against the current model)"):
        super().__init__(message, reason="shutdown")


class AdmissionController:
    """Per-predictor admission decisions: caps, deadlines, EWMA shed.

    `max_queue` bounds the micro-batch queue depth, `max_inflight`
    bounds concurrent synchronous predicts, `deadline_s` is the default
    request deadline (0 = none; per-call overrides ride on the request).
    All three are 0-disabled so the pre-existing unbounded behavior is
    exactly reproduced by the defaults."""

    # EWMA weight for queue-wait observations: 0.2 ~ the last ~10
    # dispatches dominate, fast enough to track a saturation edge and
    # smooth enough not to shed on one slow dispatch
    EWMA_ALPHA = 0.2

    def __init__(self, max_queue: int = 0, max_inflight: int = 0,
                 deadline_s: float = 0.0):
        self.max_queue = max(0, int(max_queue))
        self.max_inflight = max(0, int(max_inflight))
        self.deadline_s = max(0.0, float(deadline_s))
        self._lock = threading.Lock()
        self._ewma_wait_s: Optional[float] = None
        self._ewma_service_s: Optional[float] = None
        self.inflight = 0
        self.counts: Dict[str, int] = {
            "admitted": 0, "shed": 0, "deadline_expired": 0,
            "queue_full": 0, "inflight_full": 0, "rejected": 0}

    # ------------------------------------------------------------------
    def deadline_for(self, deadline_ms: Optional[float]) -> Optional[float]:
        """Absolute deadline (perf_counter clock) for a request arriving
        now, honoring a per-call override (ms; <=0 = no deadline)."""
        d = self.deadline_s if deadline_ms is None \
            else max(0.0, float(deadline_ms)) / 1e3
        return (time.perf_counter() + d) if d > 0 else None

    def observe_wait(self, wait_s: float) -> None:
        """Fold one queue-wait observation (enqueue -> dispatch) into
        the EWMA the shed policy reads."""
        with self._lock:
            prev = self._ewma_wait_s
            self._ewma_wait_s = wait_s if prev is None else \
                (1 - self.EWMA_ALPHA) * prev + self.EWMA_ALPHA * wait_s

    def observe_service(self, service_s: float) -> None:
        with self._lock:
            prev = self._ewma_service_s
            self._ewma_service_s = service_s if prev is None else \
                (1 - self.EWMA_ALPHA) * prev + self.EWMA_ALPHA * service_s

    @property
    def ewma_wait_s(self) -> float:
        with self._lock:
            return self._ewma_wait_s or 0.0

    @property
    def ewma_service_s(self) -> float:
        with self._lock:
            return self._ewma_service_s or 0.0

    # ------------------------------------------------------------------
    def _reject(self, kind: str, exc: ServingOverload) -> ServingOverload:
        with self._lock:
            self.counts[kind] += 1
            self.counts["rejected"] += 1
        return exc

    # ------------------------------------------------------------------
    def admit_queued(self, queue_depth: int,
                     deadline_abs: Optional[float]) -> None:
        """Admission decision for one submit(): queue cap, then the
        EWMA shed policy. Raises ServingOverload on refusal."""
        if self.max_queue > 0 and queue_depth >= self.max_queue:
            raise self._reject("queue_full", ServingOverload(
                "Serving queue is full (%d queued >= tpu_serving_max_queue"
                "=%d); retriable" % (queue_depth, self.max_queue),
                reason="queue_full",
                retry_after_s=max(self.ewma_wait_s, 0.001)))
        if deadline_abs is not None:
            remaining = deadline_abs - time.perf_counter()
            # the EWMA only updates when queued items are POPPED, so it
            # can hold a stale overload-era value after the burst ends;
            # shedding into an EMPTY queue on that stale estimate would
            # refuse traffic forever (nothing enqueued -> nothing
            # popped -> estimate never corrects). An empty queue admits
            # on the wait estimate — the pop-time deadline check still
            # expires anything that genuinely waits too long, and its
            # observe_wait drags the EWMA back down
            est = self.ewma_wait_s if queue_depth > 0 else 0.0
            if remaining <= 0 or est > remaining:
                raise self._reject("shed", ServingOverload(
                    "Shedding: estimated queue wait %.1fms exceeds the "
                    "request deadline (%.1fms remaining); retriable"
                    % (est * 1e3, max(remaining, 0.0) * 1e3),
                    reason="shed", retry_after_s=max(est, 0.001)))
        with self._lock:
            self.counts["admitted"] += 1

    def admit_sync(self, deadline_abs: Optional[float]) -> None:
        """Admission for one synchronous predict(): in-flight cap plus
        the deadline pre-check (estimated service time vs remaining
        budget — refuse BEFORE burning device time). Check and
        increment happen under ONE lock hold: a check-then-increment
        race would let K concurrent callers exceed the cap by K-1."""
        refusal = None
        with self._lock:
            if self.max_inflight > 0 and self.inflight >= self.max_inflight:
                refusal = ("inflight_full", ServingOverload(
                    "Too many in-flight predicts (%d >= tpu_serving_max_"
                    "inflight=%d); retriable"
                    % (self.inflight, self.max_inflight),
                    reason="inflight_full",
                    retry_after_s=max(self._ewma_service_s or 0.0, 0.001)))
            elif deadline_abs is not None:
                remaining = deadline_abs - time.perf_counter()
                # same staleness guard as the queue path: the service
                # EWMA only corrects when something DISPATCHES, so
                # shedding an idle predictor on a stale estimate (a
                # past slow-device period) would refuse deadline-
                # bearing traffic forever. With work in flight the
                # estimate is live evidence; idle, the request runs
                # immediately and its measurement re-anchors the EWMA
                est = (self._ewma_service_s or 0.0) \
                    if self.inflight > 0 else 0.0
                if remaining <= 0 or est > remaining:
                    refusal = ("shed", ServingOverload(
                        "Shedding: estimated service time %.1fms exceeds "
                        "the request deadline (%.1fms remaining); "
                        "retriable" % (est * 1e3, max(remaining, 0.0) * 1e3),
                        reason="shed", retry_after_s=max(est, 0.001)))
            if refusal is None:
                self.counts["admitted"] += 1
                self.inflight += 1
        if refusal is not None:
            # _reject re-takes the lock, so it must run OUTSIDE it
            raise self._reject(*refusal)

    def release_sync(self) -> None:
        with self._lock:
            self.inflight -= 1

    def expire(self, waited_s: float,
               deadline_abs: float) -> DeadlineExceeded:
        """Build + count the rejection for a queued request whose
        deadline passed before dispatch."""
        with self._lock:
            self.counts["deadline_expired"] += 1
            self.counts["rejected"] += 1
        over_ms = (time.perf_counter() - deadline_abs) * 1e3
        return DeadlineExceeded(
            "Request deadline expired in the serving queue (waited "
            "%.1fms, %.1fms past deadline); retriable"
            % (waited_s * 1e3, over_ms),
            waited_ms=round(waited_s * 1e3, 3))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self.counts)
            out["inflight"] = self.inflight
            if self._ewma_wait_s is not None:
                out["queue_wait_ewma_ms"] = round(self._ewma_wait_s * 1e3, 4)
            if self._ewma_service_s is not None:
                out["service_ewma_ms"] = round(self._ewma_service_s * 1e3, 4)
        out["max_queue"] = self.max_queue
        out["max_inflight"] = self.max_inflight
        out["deadline_ms"] = round(self.deadline_s * 1e3, 3)
        return out
