"""Piecewise-linear leaves (`linear_tree=true`): the port's copy of
`lightgbm_tpu/linear/`.

- `solver.py`: `fit_leaves`, every leaf's ridge fit over its path
  features (kernels LF and LS), and `linear_row_values`, the rows'
  values under linear leaves (kernel LA);
- `stats.py`: `leaf_feature_moments`, the per-leaf marginal moments of
  kernel LM, the diagnostics that cross-check the solver's normal
  equations.
"""
from .solver import fit_leaves, linear_row_values  # noqa: F401
from .stats import leaf_feature_moments  # noqa: F401
