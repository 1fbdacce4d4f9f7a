"""Objective functions: the output half this slice serves.

Counterpart of `lightgbm_tpu/objectives.py` for prediction: each
objective knows its model-text name (`to_string`) and its output
transform (`convert_output`, on torch tensors). `OUTPUT_KIND` tells the
forest-walk kernel which transform it fuses into its epilogue
(`ops/predict.OutputTransform`). The gradient half arrives with
training; every other objective is refused by name until its slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import log
from .config import Config


class ObjectiveFunction:
    name = "base"
    OUTPUT_KIND = "identity"
    sigmoid = 1.0

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def to_string(self) -> str:
        return self.name


class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp:13-79 (identity output)."""
    name = "regression"


class BinaryLogloss(ObjectiveFunction):
    """reference: binary_objective.hpp:13-157."""
    name = "binary"
    OUTPUT_KIND = "sigmoid"

    def __init__(self, config: Config):
        self.sigmoid = config.objective_config.sigmoid
        if self.sigmoid <= 0:
            log.fatal("Sigmoid parameter %f should be greater than zero"
                      % self.sigmoid)

    def to_string(self):
        # the reference loader REQUIRES the sigmoid token
        # (binary_objective.hpp:32-42 fatals without it)
        return f"binary sigmoid:{self.sigmoid:g}"

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))


_PORTED = {
    "regression": RegressionL2,
    "regression_l2": RegressionL2,
    "mean_squared_error": RegressionL2,
    "mse": RegressionL2,
    "l2": RegressionL2,
    "l2_root": RegressionL2,
    "rmse": RegressionL2,
    "binary": BinaryLogloss,
}

# the JAX package's other objectives (lightgbm_tpu/objectives.py
# _OBJECTIVE_REGISTRY): known names, refused until their slice
_NOT_PORTED = (
    "regression_l1", "l1", "mean_absolute_error", "mae", "huber", "fair",
    "poisson", "multiclass", "softmax", "multiclassova", "multiclass_ova",
    "ova", "ovr", "xentropy", "cross_entropy", "xentlambda",
    "cross_entropy_lambda", "lambdarank")


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference: ObjectiveFunction::CreateObjectiveFunction,
    objective_function.cpp:10-36). None for objective='none'."""
    name = config.objective
    if name in ("none", "null", "custom", ""):
        return None
    if name in _NOT_PORTED:
        log.fatal("objective %s is not ported to lightgbm_tpu_torch yet "
                  "(ported: regression, binary)" % name)
    if name not in _PORTED:
        log.fatal("Unknown objective type name: %s" % name)
    cls = _PORTED[name]
    return cls(config) if cls is BinaryLogloss else cls()
