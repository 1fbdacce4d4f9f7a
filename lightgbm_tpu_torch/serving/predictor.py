"""Serving front end: warmup, the request path, optional micro-batching,
admission control, and throughput/latency counters.

Counterpart of `lightgbm_tpu/serving/predictor.py` (reference:
`Predictor`, predictor.hpp:24-205, built once per booster and reused
per request). The device work lives in `GBDT.predict` and the
device-resident `serving.forest.CompiledForest`; this layer adds:

- `warmup()` builds the kernels and stacks the forest before traffic;
- `predict()` / `predict_one()` time every request into a latency
  histogram and counters (`serving/requests`, `serving/rows`);
- `submit()` coalesces concurrent single-row requests arriving within
  `tpu_predict_micro_batch_window_ms` into one kernel launch, on a
  background thread. The predict there copies its result to the host,
  which waits for the launch on that thread's current stream, before
  any future resolves;
- admission control (serving/admission.py): queue-depth and in-flight
  caps, per-request deadlines and the EWMA shed policy.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional

import numpy as np

from .. import log, tracing
from .admission import AdmissionController, PredictorShutdown

# latency histogram bounds: 10us..~20s exponential, so p50/p95/p99 cover
# the predictor's whole service life in fixed memory
_LATENCY_BOUNDS = tuple(1e-5 * (2.0 ** i) for i in range(22))
# micro-batch size distribution (rows per coalesced dispatch)
_BATCH_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class _QueueItem:
    """One queued submit(): the row, its future, and the admission
    evidence the batch loop needs to expire/time it."""
    __slots__ = ("arr", "fut", "enqueued", "deadline_abs")

    def __init__(self, arr, fut, enqueued, deadline_abs):
        self.arr = arr
        self.fut = fut
        self.enqueued = enqueued
        self.deadline_abs = deadline_abs


def _resolve(fut: Future, value) -> None:
    try:
        fut.set_result(value)
    except InvalidStateError:  # raced close()'s shutdown sweep
        pass


def _fail(fut: Future, exc: BaseException) -> None:
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


class Predictor:
    """Reference: class Predictor, predictor.hpp:24-205 — built once per
    booster, reused per request. Accepts a `basic.Booster` or a bare
    `boosting.GBDT`; per-request overrides ride on `predict(**kw)`."""

    def __init__(self, booster, num_iteration: int = -1,
                 raw_score: bool = False, pred_leaf: bool = False,
                 pred_contrib: bool = False, pred_early_stop: bool = False,
                 pred_early_stop_freq: int = 10,
                 pred_early_stop_margin: float = 10.0):
        self._gbdt = getattr(booster, "_inner", booster)
        self._kwargs = dict(
            num_iteration=num_iteration, raw_score=raw_score,
            pred_leaf=pred_leaf, pred_contrib=pred_contrib,
            pred_early_stop=pred_early_stop,
            pred_early_stop_freq=pred_early_stop_freq,
            pred_early_stop_margin=pred_early_stop_margin)
        io = self._gbdt.config.io
        self._micro_batch = max(0, int(io.tpu_predict_micro_batch))
        self._window_s = max(0.0, float(
            io.tpu_predict_micro_batch_window_ms)) / 1e3
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[_QueueItem] = []
        self._batcher: Optional[threading.Thread] = None
        self._closed = False
        # admission control: all caps default to 0 (= off), reproducing
        # the pre-admission unbounded behavior exactly
        self.admission = AdmissionController(
            max_queue=int(io.tpu_serving_max_queue),
            max_inflight=int(io.tpu_serving_max_inflight),
            deadline_s=max(0.0, float(io.tpu_serving_deadline_ms)) / 1e3)
        # always-on local instruments, read by stats()
        self._latency_hist = tracing.Histogram(_LATENCY_BOUNDS)
        self._batch_hist = tracing.Histogram(_BATCH_BOUNDS)
        self._counts = {"requests": 0, "rows": 0,
                        "micro_batches": 0, "micro_rows": 0,
                        "batch_isolated_rows": 0}
        self._warmup_seconds: Optional[float] = None

    # ------------------------------------------------------------------
    def num_features(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def _check_width(self, arr: np.ndarray) -> None:
        """Reject wrong-width rows up front with a clear error, before
        they reach the queue or the kernel."""
        want = self.num_features()
        if arr.ndim != 2 or arr.shape[1] != want:
            raise log.LightGBMError(
                "Prediction input has %s feature column(s); this model "
                "expects %d (shape %s)"
                % (arr.shape[1] if arr.ndim == 2 else "a bad number of",
                   want, tuple(arr.shape)))

    def warmup(self) -> Dict[str, Any]:
        """Build the kernels (on CUDA) and stack the forest on the
        device with one uncounted one-row predict, so the first real
        request is pure device work. There is no shape ladder to warm:
        the kernels take any row count. Warmup traffic is NOT counted
        in the request/latency stats."""
        t0 = time.perf_counter()
        # the all-zero row must not become the quantize gate's
        # calibration (one leaf a tree, a near-zero delta kept for the
        # model version): the gate waits for the first real batch
        # (lightgbm_tpu/serving/predictor.py:177-184)
        self._gbdt._quant_gate_defer = True
        try:
            self._predict_timed(np.zeros((1, self.num_features()),
                                         np.float32), count=False)
        finally:
            self._gbdt._quant_gate_defer = False
        self._warmup_seconds = time.perf_counter() - t0
        log.debug("Predictor warmup in %.3fs", self._warmup_seconds)
        return {"seconds": self._warmup_seconds}

    # ------------------------------------------------------------------
    def _predict_timed(self, arr: np.ndarray, count: bool = True,
                       **overrides):
        """The timed dispatch body shared by predict(), the micro-batch
        loop, and warmup(). Admission decisions happen in the PUBLIC
        entry points; this layer feeds the latency instruments. The
        predict returns host arrays, i.e. after the device finished."""
        kw = dict(self._kwargs)
        kw.update(overrides)
        t0 = time.perf_counter()
        out = self._gbdt.predict(arr, **kw)
        dt = time.perf_counter() - t0
        if count:
            self.admission.observe_service(dt)
            with self._lock:
                self._counts["requests"] += 1
                self._counts["rows"] += int(arr.shape[0])
            self._latency_hist.observe(dt)
        return out

    def predict(self, data, deadline_ms: Optional[float] = None,
                **overrides):
        """Timed predict over a [N, F] batch (rows also accepted as a
        single 1-D row, returned as a 1-row result — use predict_one()
        for the squeezed scalar path). `deadline_ms` overrides
        `tpu_serving_deadline_ms` for this call: a request whose
        estimated service time already exceeds it is refused with a
        structured retriable error BEFORE any device work."""
        arr = np.asarray(data, np.float32)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        self._check_width(arr)
        deadline_abs = self.admission.deadline_for(deadline_ms)
        self.admission.admit_sync(deadline_abs)
        try:
            return self._predict_timed(arr, **overrides)
        finally:
            self.admission.release_sync()

    def predict_one(self, row, deadline_ms: Optional[float] = None,
                    **overrides):
        """Single-row path; returns the row's prediction with the batch
        axis squeezed."""
        return self.predict(np.asarray(row, np.float32).reshape(1, -1),
                            deadline_ms=deadline_ms, **overrides)[0]

    # ------------------------------------------------------------------
    # micro-batching: coalesce concurrent single-row requests
    def submit(self, row, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one row; resolves to its prediction. With
        `tpu_predict_micro_batch` 0 this degenerates to a synchronous
        predict_one; otherwise rows arriving within the window share
        one device dispatch. Refusals (queue full, shed, closed) raise
        `ServingOverload` HERE — an accepted Future either resolves to
        a prediction or fails with a structured error (deadline expiry,
        shutdown, a predict failure); it is never silently dropped."""
        arr = np.asarray(row, np.float32).reshape(-1)
        # validate BEFORE enqueueing: a wrong-width row must fail its
        # caller, not poison the whole coalesced batch it would ride in
        self._check_width(arr.reshape(1, -1))
        deadline_abs = self.admission.deadline_for(deadline_ms)
        fut: Future = Future()
        if self._micro_batch <= 0:
            self.admission.admit_sync(deadline_abs)
            try:
                _resolve(fut, self._predict_timed(arr.reshape(1, -1))[0])
            except Exception as exc:  # surface through the future
                _fail(fut, exc)
            finally:
                self.admission.release_sync()
            return fut
        with self._cv:
            if self._closed:
                raise PredictorShutdown()
            # queue cap + EWMA shed under the lock: the depth the
            # decision reads is the depth the enqueue appends to
            self.admission.admit_queued(len(self._queue), deadline_abs)
            if self._batcher is None:
                self._batcher = threading.Thread(
                    target=self._batch_loop, name="lgbm-torch-microbatch",
                    daemon=True)
                self._batcher.start()
            self._queue.append(_QueueItem(arr, fut, time.perf_counter(),
                                          deadline_abs))
            self._cv.notify()
        return fut

    def _batch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                # collect up to micro_batch rows arriving within the window
                deadline = time.perf_counter() + self._window_s
                while len(self._queue) < self._micro_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(timeout=remaining)
                batch = self._queue[:self._micro_batch]
                del self._queue[:len(batch)]
            now = time.perf_counter()
            live = []
            for item in batch:
                self.admission.observe_wait(now - item.enqueued)
                # claim each future; a client may have cancel()ed while
                # its row sat in the window (request-timeout pattern) —
                # resolving a cancelled future raises and would kill
                # this thread
                if not item.fut.set_running_or_notify_cancel():
                    continue
                if item.deadline_abs is not None and now > item.deadline_abs:
                    # expired in the queue: prompt structured rejection
                    # BEFORE burning device time on a row whose answer
                    # nobody is waiting for anymore
                    _fail(item.fut, self.admission.expire(
                        now - item.enqueued, item.deadline_abs))
                    continue
                live.append(item)
            if not live:
                continue
            rows = np.stack([item.arr for item in live])
            try:
                res = self._predict_timed(rows)
            except Exception as exc:
                self._isolate_batch_failure(live, exc)
                continue
            with self._lock:
                self._counts["micro_batches"] += 1
                self._counts["micro_rows"] += len(live)
            self._batch_hist.observe(len(live))
            for i, item in enumerate(live):
                _resolve(item.fut, res[i])

    def _isolate_batch_failure(self, live: List[_QueueItem],
                               exc: BaseException) -> None:
        """A predict failure inside a coalesced batch must fail only
        the rows that actually fail: re-run each row alone so one
        poisoned row (or one transient fault) cannot take down every
        co-riding future. Single-row batches skip the retry — the
        failure IS that row's answer. Each re-run honors its row's
        deadline: under overload the serialized per-row dispatches can
        outlive deadlines that were met at pop time, and an expired
        row must not burn device time nobody is waiting for."""
        if len(live) == 1:
            _fail(live[0].fut, exc)
            return
        with self._lock:
            self._counts["batch_isolated_rows"] += len(live)
        for item in live:
            now = time.perf_counter()
            if item.deadline_abs is not None and now > item.deadline_abs:
                _fail(item.fut, self.admission.expire(
                    now - item.enqueued, item.deadline_abs))
                continue
            try:
                out = self._predict_timed(item.arr.reshape(1, -1),
                                          count=False)
            except Exception as row_exc:
                _fail(item.fut, row_exc)
            else:
                _resolve(item.fut, out[0])

    def close(self, timeout: float = 5.0) -> None:
        """Stop the micro-batcher. Queued requests are drained (they
        complete on this model — the registry's hot-swap contract);
        anything the batcher fails to drain within `timeout` (a wedged
        device, a dead thread) is failed with a structured
        `PredictorShutdown` instead of leaking an unresolved Future."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            # read (don't clear) the batcher under the lock: EVERY
            # racing close() must wait out the same drain window —
            # Thread.join is multi-caller-safe, whereas clearing here
            # would let a second closer skip straight to the sweep and
            # fail futures the batcher was actively draining. Join
            # OUTSIDE the lock — the batcher takes it to drain
            batcher = self._batcher
        if batcher is not None:
            batcher.join(timeout=timeout)
            with self._cv:
                if self._batcher is batcher:
                    self._batcher = None
        # shutdown sweep: after the drain window nothing may stay
        # pending forever — a leaked Future is an indefinitely blocked
        # caller, the one outcome the overload contract forbids
        with self._cv:
            leftovers = self._queue[:]
            del self._queue[:]
        for item in leftovers:
            if item.fut.set_running_or_notify_cancel():
                _fail(item.fut, PredictorShutdown())

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Request/row totals, service-lifetime latency percentiles (from
        the bucketed histogram: bucket-resolution estimates, host wall
        clock around work that ends with the result on the host),
        throughput, admission/shed counters, and the forest cache's
        restack economics."""
        with self._lock:
            counts = dict(self._counts)
        hist = self._latency_hist.snapshot()
        out: Dict[str, Any] = dict(counts)
        out["model_version"] = int(self._gbdt._compiled_forest.version)
        stack = self._gbdt._compiled_forest.stats
        out.update({f"stack_{k}": int(v) for k, v in stack.items()})
        out["quantize"] = str(self._gbdt.config.io.tpu_predict_quantize)
        out["warmup_seconds"] = self._warmup_seconds
        out["admission"] = self.admission.stats()
        if hist["count"]:
            out["p50_latency_ms"] = round(
                self._latency_hist.quantile(0.50) * 1e3, 4)
            out["p95_latency_ms"] = round(
                self._latency_hist.quantile(0.95) * 1e3, 4)
            out["p99_latency_ms"] = round(
                self._latency_hist.quantile(0.99) * 1e3, 4)
            out["mean_latency_ms"] = round(
                hist["sum"] / hist["count"] * 1e3, 4)
            out["max_latency_ms"] = round(hist["max"] * 1e3, 4)
            if hist["sum"] > 0:
                out["rows_per_second"] = round(counts["rows"] / hist["sum"],
                                               2)
        if self._micro_batch > 0:
            with self._cv:
                out["queue_depth"] = len(self._queue)
            batch = self._batch_hist.snapshot()
            if batch["count"]:
                out["mean_micro_batch_rows"] = round(
                    batch["sum"] / batch["count"], 2)
        return out
