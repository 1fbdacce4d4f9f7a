"""Per-leaf marginal moments of the raw features: the port's copy of
`lightgbm_tpu/linear/stats.py`.

Summed over bins, kernel LM's per-bin moments (sum w x, sum w x^2,
sum w g x, sum w h x per leaf and feature) are exactly some entries of
the solver's normal equations: sum w g x_f is b's entry of feature f,
and the w- and h-weighted sums of x and x^2 are the matching marginals.
The cross moments sum w h x_i x_j (i != j) are not among them, which is
why the solver builds its systems in its own pass (kernel LF). This is
the diagnostic that ties the two together.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.histogram import leaf_moments_ids


def leaf_feature_moments(binned: torch.Tensor, x: torch.Tensor,
                         weights: torch.Tensor, leaf_id: torch.Tensor,
                         ids, num_bins: int, chunk: int = 16384,
                         n_valid: Optional[int] = None) -> torch.Tensor:
    """[C, F, 4] = (sum w x, sum w x^2, sum w g x, sum w h x) per leaf id
    ids[c] and feature, over the rows whose leaf_id is that id
    (lightgbm_tpu/linear/stats.py:34). binned [N, F] per-feature bins,
    x [N, F] raw values aligned with them, weights [N, 3] = (g*w, h*w,
    w). `chunk` is the JAX package's schedule and is taken and ignored;
    `n_valid` keeps the leading rows only. The ids stay on the host (a
    tensor of them is read back once), so on the card nothing is read
    back."""
    if n_valid is not None:
        binned, x, weights, leaf_id = (t[:int(n_valid)] for t in (
            binned, x, weights, leaf_id))
    per_bin = leaf_moments_ids(binned.contiguous(), x.contiguous(),
                               weights.contiguous(), num_bins,
                               leaf_id=leaf_id.to(torch.int32).contiguous(),
                               ids=ids)
    return per_bin.sum(dim=2)
