"""Device-resident stacked-forest cache.

Counterpart of `lightgbm_tpu/serving/forest.py:114-290`. Stacking the
host `Tree` objects into a `Forest` and copying it to the card is
O(forest) host work; paying it per `predict` call would make serving
host-bound. `CompiledForest` keeps every stack keyed by
`(layout, trees used, model version)`; the owning `GBDT` bumps the
version on every ensemble mutation (`invalidate()`), so a stale stack can
never be looked up again. `evict_entries()` frees the stacks without a
version bump (a memory-budget reclaim; the next predict restacks).

The layouts: the f32 walk stack (`value_stacks`, which pred_leaf walks
too), its f16-leaf copy and the fixed-point `QuantForest` of
`tpu_predict_quantize=f16|int8` (`value_stacks(..., quantize=)`, each
under its own key, so the three can be held at once; linear forests are
refused with the JAX package's words), and the [K, T] stack of
prediction early stop (`early_stop_stacks`). Beside the stacks, the
quantize accuracy gate's measured delta per (layout, model version)
(`gate_delta` / `record_gate`), dropped with the stacks.

What the JAX module needs and this one does not: a bucket ladder and
row padding (XLA compiles one program per input shape; a CUDA kernel
takes any row count), a compile single-flight and a compile cache (there
is one kernel build per process, under its own lock in ops/_build.py).
Linear forests stack and serve like constant ones in f32: the stack
carries each leaf's coefficients and feature columns.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..ops.predict import (Forest, stack_trees, stack_trees_early_stop,
                           stack_trees_quant, to_f16)

# tpu_predict_quantize values (config.py validates against the same)
QUANTIZE_MODES = ("none", "f16", "int8")

# stacks kept per model version: one per distinct num_iteration cap seen
_MAX_ENTRIES = 8


class CompiledForest:
    """Per-booster cache of device-resident stacked forests on `device`.
    `enabled=False` (`tpu_predict_cache=false`) rebuilds on every lookup.
    The lock covers lookup AND build, so concurrent misses (the
    micro-batch thread and caller threads) stack the forest once."""

    def __init__(self, device: torch.device):
        self.device = device
        self._version = 0
        self._cache: "OrderedDict[Tuple, Forest]" = OrderedDict()
        self._entry_bytes: Dict[Tuple, int] = {}
        # quantize gate ledger: layout key -> measured relative raw-score
        # delta against the f32 stack on the calibration rows
        self._gate_delta: Dict[Tuple, float] = {}
        self.enabled = True
        self._lock = threading.RLock()
        self.stats: Dict[str, int] = {
            "restacks": 0, "hits": 0, "invalidations": 0, "evictions": 0,
            "bytes": 0}

    @property
    def version(self) -> int:
        return self._version

    def invalidate(self) -> None:
        with self._lock:
            self._version += 1
            if self._cache:
                self.stats["invalidations"] += 1
            self._drop_all()

    def evict_entries(self) -> int:
        """Drop every cached stack (the model version is NOT bumped).
        Returns the bytes freed."""
        with self._lock:
            freed = self.stats["bytes"]
            if self._cache:
                self.stats["evictions"] += 1
            self._drop_all()
            return freed

    def _drop_all(self) -> None:
        self._cache.clear()
        self._entry_bytes.clear()
        self._gate_delta.clear()
        self.stats["bytes"] = 0

    def device_bytes(self) -> int:
        """Current device memory held by cached stacks."""
        with self._lock:
            return self.stats["bytes"]

    def _get(self, key: Tuple, build: Callable[[], Forest]) -> Any:
        with self._lock:
            key = key + (self._version,)
            if self.enabled:
                hit = self._cache.get(key)
                if hit is not None:
                    self._cache.move_to_end(key)
                    self.stats["hits"] += 1
                    return hit
            value = build()
            self.stats["restacks"] += 1
            if self.enabled:
                self._cache[key] = value
                self._entry_bytes[key] = value.nbytes()
                self.stats["bytes"] += self._entry_bytes[key]
                while len(self._cache) > _MAX_ENTRIES:
                    old_key, _ = self._cache.popitem(last=False)
                    self.stats["bytes"] -= self._entry_bytes.pop(old_key, 0)
            return value

    # ------------------------------------------------------------------
    # quantize gate ledger (lightgbm_tpu/serving/forest.py:205-262)
    def gate_delta(self, key: Tuple) -> Optional[float]:
        with self._lock:
            return self._gate_delta.get(key + (self._version,))

    def record_gate(self, key: Tuple, delta: float) -> None:
        with self._lock:
            self._gate_delta[key + (self._version,)] = float(delta)

    # ------------------------------------------------------------------
    def value_stacks(self, models, total: int, quantize: str = "none"):
        """The layout over the first `total` trees: quantize="none" the
        f32 Forest (pred_leaf walks the same one, so one entry serves
        both routes), "f16" its copy with f16 leaves, "int8" the
        fixed-point QuantForest (raises ops.predict.QuantRefused when
        the forest has no such layout). Distinct keys."""
        if quantize == "f16":
            return self._get(("walk", total, "f16"), lambda: to_f16(
                self.value_stacks(models, total)))
        if quantize == "int8":
            return self._get(("walk", total, "int8"), lambda:
                             stack_trees_quant(models[:total], self.device))
        return self._get(("walk", total),
                         lambda: stack_trees(models[:total], self.device))

    def early_stop_stacks(self, models, k: int, t_iters: int) -> Forest:
        """The [K, T] stack of the first t_iters iterations for
        prediction early stop (ops.predict.forest_early_stop_walk)."""
        return self._get(("early_stop", t_iters, k),
                         lambda: stack_trees_early_stop(
                             models, k, t_iters, self.device))
