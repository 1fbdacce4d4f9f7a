"""DART: Dropouts meet Multiple Additive Regression Trees.

Counterpart of `lightgbm_tpu/boosting/dart.py` (reference:
src/boosting/dart.hpp). Each iteration drops a random subset of the
trees grown so far (weight-proportional unless `uniform_drop`;
DroppingTrees, dart.hpp:85-130) from the train score, grows the new tree
against the score without them at shrinkage learning_rate / (1 + k)
(or the xgboost_dart_mode variant), then re-weighs each dropped tree by
k / (k + 1) and puts it back (Normalize, dart.hpp:140-180). The drops
draw from `np.random.RandomState(drop_seed)` in the JAX package's order,
the draw of iteration 0 included, so the ledger of tree weights equals
the JAX package's. DART runs no kernel of its own: a dropped or
re-weighed tree's values, sign times its leaf values computed in f64 on
the host and rounded to f32, are added to the scores by W
(`GBDT._add_tree_values`), as rollback adds a negated tree.

The model text carries the ledger in its header
(`tpu_dart_tree_weights`, `tpu_dart_sum_weight`); a load keeps it, so a
save writes it back byte for byte.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .. import log
from .gbdt import GBDT


class DART(GBDT):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self._drop_rng = np.random.RandomState(config.boosting.drop_seed)
        self.drop_index: List[int] = []

    def model_name(self) -> str:
        return "dart"

    def _extra_model_header(self, num_iteration: int = -1):
        # truncated saves truncate the ledger (as the JAX package does)
        weights = self.tree_weight
        sum_weight = self.sum_weight
        if 0 < num_iteration < len(weights):
            weights = weights[:num_iteration]
            sum_weight = float(sum(weights))
        if not weights:
            return []
        return ["tpu_dart_tree_weights=" + " ".join(
                    repr(float(w)) for w in weights),
                "tpu_dart_sum_weight=" + repr(float(sum_weight))]

    def load_model_from_string(self, text: str) -> None:
        super().load_model_from_string(text)
        self.tree_weight = []
        self.sum_weight = 0.0
        self.drop_index = []
        for line in text.splitlines():
            ls = line.strip()
            if ls.startswith("tpu_dart_tree_weights="):
                self.tree_weight = [float(w)
                                    for w in ls.split("=", 1)[1].split()]
            elif ls.startswith("tpu_dart_sum_weight="):
                self.sum_weight = float(ls.split("=", 1)[1])
            elif ls.startswith("Tree="):
                break

    # ------------------------------------------------------------------
    # training (dart.py:88-204)
    def _tree_contribution(self, it: int, sign: float,
                           on_valid: bool) -> None:
        """Add sign * tree(it) to the train scores, or to every valid
        set's (dart.py:88-105 and :166-180)."""
        tree = self.models[it]
        if tree.num_leaves <= 1:
            return
        if not on_valid:
            self._add_tree_values(tree, self._walk_binned, None,
                                  self._score[0], sign)
            return
        for vi, vb in enumerate(self._valid_binned):
            self._add_tree_values(tree, vb, None, self._valid_score[vi][0],
                                  sign)

    def _dropping_trees(self) -> None:
        """Select the dropped trees, take them off the train score and set
        this iteration's shrinkage (dart.py:107-139)."""
        cfg = self.config.boosting
        self.drop_index = []
        if self._drop_rng.rand() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                inv_avg = len(self.tree_weight) / self.sum_weight \
                    if self.sum_weight > 0 else 0.0
                if cfg.max_drop > 0 and self.sum_weight > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg / self.sum_weight)
                for i in range(self.iter_):
                    if self._drop_rng.rand() < \
                            drop_rate * self.tree_weight[i] * inv_avg:
                        self.drop_index.append(i)
            else:
                if cfg.max_drop > 0 and self.iter_ > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter_)
                for i in range(self.iter_):
                    if self._drop_rng.rand() < drop_rate:
                        self.drop_index.append(i)
        for i in self.drop_index:
            self._tree_contribution(i, -1.0, on_valid=False)
        kdrop = len(self.drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + kdrop)
        else:
            self.shrinkage_rate = cfg.learning_rate if kdrop == 0 else \
                cfg.learning_rate / (cfg.learning_rate + kdrop)

    def _normalize(self) -> None:
        """Re-weigh the dropped trees (dart.py:141-164): their stored
        values times factor, the valid scores (which still hold them)
        plus (factor - 1) / factor times the new values, the train score
        (which had them taken off) plus the new values."""
        cfg = self.config.boosting
        kdrop = float(len(self.drop_index))
        for i in self.drop_index:
            if not cfg.xgboost_dart_mode:
                factor = kdrop / (kdrop + 1.0)
            else:
                factor = kdrop / (kdrop + cfg.learning_rate)
            tree = self.models[i]
            tree.leaf_value = tree.leaf_value * factor
            tree.internal_value = tree.internal_value * factor
            self._tree_contribution(i, (factor - 1.0) / factor,
                                    on_valid=True)
            self._tree_contribution(i, 1.0, on_valid=False)
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] / (kdrop + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[i] / (
                        kdrop + cfg.learning_rate)
                self.tree_weight[i] *= factor

    def train_one_iter(self) -> bool:
        """dart.py:182-204: drop, grow one tree, then re-weigh; every
        change to the ensemble bumps the model version."""
        self._dropping_trees()
        stop = super().train_one_iter()
        if not stop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
            self._normalize()
            # _normalize rescales trees already kept: a stacked forest
            # cached after the append would be stale
            self._bump_model_version()
        else:
            for i in self.drop_index:
                self._tree_contribution(i, 1.0, on_valid=False)
        log.debug("DART iteration %d dropped %d trees", self.iter_,
                  len(self.drop_index))
        return stop
