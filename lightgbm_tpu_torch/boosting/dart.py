"""DART models: the model-IO half (reference: dart.hpp).

Counterpart of `lightgbm_tpu/boosting/dart.py`: a DART model predicts
like any GBDT; what differs in serving is its model-text name and the
drop ledger (per-tree weights) it carries in its header, which a load
keeps so a save writes it back byte for byte.
"""
from __future__ import annotations

from typing import List

from .gbdt import GBDT


class DART(GBDT):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0

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
        for line in text.splitlines():
            ls = line.strip()
            if ls.startswith("tpu_dart_tree_weights="):
                self.tree_weight = [float(w)
                                    for w in ls.split("=", 1)[1].split()]
            elif ls.startswith("tpu_dart_sum_weight="):
                self.sum_weight = float(ls.split("=", 1)[1])
            elif ls.startswith("Tree="):
                break
