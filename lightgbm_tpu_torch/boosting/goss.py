"""GOSS: Gradient-based One-Side Sampling.

Counterpart of `lightgbm_tpu/boosting/goss.py` (reference:
src/boosting/goss.hpp): from iteration int(1 / learning_rate) on
(goss.hpp:135-138) each tree grows on the rows of the top_rate fraction
of |g*h| at weight 1 and on a Bernoulli(other_k / (n - top_k)) sample of
the rest at weight (n - top_k) / other_k, the others at weight 0; the
weight folds into the histogram channels (g*w, h*w) and the count
channel counts the rows of weight > 0. The weights come from kernels GT
and GW (`ops/goss.py`), drawn from JAX's threefry stream keyed by
fold_in(PRNGKey(bagging_seed), iteration), so they equal the JAX
package's bit for bit given the same gradients. The iterations before
int(1 / learning_rate) are unweighted. Its refusals (bagging, a rate <=
0) are `refuse_unported_training`'s.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.goss import goss_rates, goss_threshold, goss_weights
from ..ops.rng import fold_in, prng_key
from .gbdt import GBDT


class GOSS(GBDT):
    def model_name(self) -> str:
        return "goss"

    def init(self, train_data, objective, metric_names=()) -> None:
        super().init(train_data, objective, metric_names)
        self._goss_w = torch.empty(self._n, dtype=torch.float32,
                                   device=self.device)

    def _bagging_weights(self, iter_idx: int,
                         grad: Optional[torch.Tensor] = None,
                         hess: Optional[torch.Tensor] = None
                         ) -> Optional[torch.Tensor]:
        """The [n] f32 GOSS weights of iteration `iter_idx`, or None
        before int(1 / learning_rate) (goss.py:36-57)."""
        bc = self.config.boosting
        if iter_idx < int(1.0 / max(bc.learning_rate, 1e-12)) \
                or grad is None:
            return None
        n = self._n
        top_k = max(1, int(n * bc.top_rate))
        other_k = max(1, int(n * bc.other_rate))
        rest_p, multiply = goss_rates(n, top_k, other_k)
        mag, thresh = goss_threshold(grad, hess, top_k)
        return goss_weights(mag, thresh,
                            fold_in(prng_key(bc.bagging_seed), iter_idx),
                            rest_p, multiply, self._goss_w)
