"""Device-resident stacked-forest cache.

Counterpart of `lightgbm_tpu/serving/forest.py:114-290`. Stacking the
host `Tree` objects into a `Forest` and copying it to the card is
O(forest) host work; paying it per `predict` call would make serving
host-bound. `CompiledForest` keeps every stack keyed by
`(layout, trees used, model version)`; the owning `GBDT` bumps the
version on every ensemble mutation (`invalidate()`), so a stale stack can
never be looked up again. `evict_entries()` frees the stacks without a
version bump (a memory-budget reclaim; the next predict restacks).

What the JAX module needs and this one does not: a bucket ladder and
row padding (XLA compiles one program per input shape; a CUDA kernel
takes any row count), a compile single-flight and a compile cache (there
is one kernel build per process, under its own lock in ops/_build.py),
and the quantized layouts (`tpu_predict_quantize` is refused until
their kernels are ported; for linear forests with the JAX package's
own refusal). Linear forests stack and serve like constant ones: the
stack carries each leaf's coefficients and feature columns.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Tuple

import torch

from ..ops.predict import Forest, stack_trees

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

    def value_stacks(self, models, total: int) -> Forest:
        """The Forest over the first `total` trees (pred_leaf walks the
        same layout, so one entry serves both routes)."""
        return self._get(("walk", total),
                         lambda: stack_trees(models[:total], self.device))
