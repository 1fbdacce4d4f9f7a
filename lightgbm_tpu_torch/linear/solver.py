"""Every leaf's linear model in one pass: the port's copy of
`lightgbm_tpu/linear/solver.py`.

For leaf l with path features f_1..f_k (`learner/grow.leaf_path_features`)
and z = [x_{f_1}, .., x_{f_k}, 1], the Newton step of the leaf's linear
model is the ridge system

    (sum_r w h z z^T + linear_lambda * diag(1..1, 0)) beta = -sum_r w g z

(the ridge on the slopes only). Kernel LF sums the systems over each
leaf's rows, kernel LS solves them (`ops/linear.py`). A leaf keeps its
grower constant, with zero slopes, when fewer than 2(k+1) of its rows
have weight or its solution is not finite (a singular system, such as a
feature constant within the leaf at linear_lambda = 0). Rows with a
non-finite value in a live slot are left out of the fit, and get the
intercept alone when scored (`linear_row_values`, kernel LA), so train
and serve agree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.linear import (linear_addend, linear_normal_eq, linear_solve,
                          segments_of)


def fit_leaves(x: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               row_weight: torch.Tensor, leaf_id: Optional[torch.Tensor],
               leaf_feats: torch.Tensor, leaf_const: torch.Tensor,
               linear_lambda: float, num_leaves: int, *,
               perm: Optional[torch.Tensor] = None,
               leaf_begin: Optional[np.ndarray] = None,
               leaf_rows: Optional[np.ndarray] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(leaf_value [L], leaf_coeff [L, k], fitted [L] bool) of every leaf
    slot (lightgbm_tpu/linear/solver.py:54).

    x [N, F] raw values (the columns leaf_feats [L, k] i32 index, -1
    padded); grad, hess, row_weight [N] f32 (weight 0: out of the bag);
    leaf_const [L] f32: the grower's constants, kept by leaves that are
    not fitted. The rows of each leaf come from the grower's partition
    (`perm` with each slot's segment `leaf_begin`/`leaf_rows`) or, when
    that is not given, from `leaf_id` [N] (sorted stably by leaf)."""
    if perm is None:
        lid = leaf_id.clamp(0, num_leaves - 1)
        perm, leaf_begin, leaf_rows = segments_of(lid, num_leaves)
    a_sum, b_sum, cnt = linear_normal_eq(x, grad, hess, row_weight, perm,
                                         leaf_begin, leaf_rows, leaf_feats)
    return linear_solve(a_sum, b_sum, cnt, leaf_feats, leaf_const,
                        linear_lambda)


def linear_row_values(x: torch.Tensor, leaf_id: torch.Tensor,
                      leaf_value: torch.Tensor, leaf_coeff: torch.Tensor,
                      leaf_feats: torch.Tensor) -> torch.Tensor:
    """[N] f32: leaf_value[l] + row_ok * sum_j coeff[l, j] * x[r, f_j] with
    l = leaf_id[r] (lightgbm_tpu/linear/solver.py:143)."""
    out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    linear_addend(x, leaf_id, leaf_value, leaf_coeff, leaf_feats, out, 1.0)
    return out
