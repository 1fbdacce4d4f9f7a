"""Objective functions: gradients for training, outputs for serving.

Counterpart of `lightgbm_tpu/objectives.py` for `regression` (L2),
`binary` and `lambdarank`: each objective knows its model-text name
(`to_string`), its output transform (`convert_output`, on torch
tensors; `OUTPUT_KIND` tells the forest-walk kernel which transform it
fuses into its epilogue, `ops/predict.OutputTransform`), and, once
`init` has seen the training labels, its gradients (`get_gradients`):
elementwise f32 torch ops on the score's device in the JAX package's
operation order, or, for lambdarank, kernel L (`ops/rank.py`), and the
boost-from-average `bias`. The JAX package's other objectives are
refused by name until their slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import log
from .config import Config
from .metrics import query_layout, segment_sum
from .ops.rank import lambdarank_grads
from .ops.route import fma_f32

# XLA's f32 exp on its CPU backend (the Cephes polynomial of XLA's
# elemental emitter, every multiply-add fused): clamp, n = floor(x log2(e)
# + 1/2) clamped to [-127, 127], x - n ln2 in two fused steps, a degree-5
# polynomial in Horner form, times 2^n, a subnormal result flushed to
# zero as XLA flushes it
_EXP_CLAMP = (-87.8, 88.8)
_EXP_LOG2E = 1.44269504088896341
_EXP_LN2 = (0.693359375, -2.12194440e-4)
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_F32_TINY = float(np.finfo(np.float32).tiny)


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """`jnp.exp` on an f32 tensor as XLA's CPU backend computes it, bit
    for bit (probed on 2^24 inputs over [-104, 89] and the special
    values, tests/test_torch_xla_order.py), in plain f32 torch ops on
    x's device. torch.exp differs from it by an ulp on some inputs."""
    def const(v):
        return torch.full_like(x, v)
    r = x.clamp(*_EXP_CLAMP)
    n = torch.floor(fma_f32(r, const(_EXP_LOG2E), const(0.5))).clamp(
        -127.0, 127.0)
    r = fma_f32(const(-_EXP_LN2[0]), n, r)
    r = fma_f32(const(-_EXP_LN2[1]), n, r)
    z = fma_f32(r, const(_EXP_POLY[0]), const(_EXP_POLY[1]))
    for c in _EXP_POLY[2:]:
        z = fma_f32(z, r, const(c))
    z = fma_f32(z, r * r, r) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    return torch.where(out.abs() < _F32_TINY, out * 0.0, out)


class ObjectiveFunction:
    name = "base"
    OUTPUT_KIND = "identity"
    sigmoid = 1.0
    label: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None

    def __init__(self, config: Optional[Config] = None):
        pass

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        """Capture the labels and weights (as f32 tensors on `device`)
        and their statistics (lightgbm_tpu/objectives.py:37-44)."""
        self.num_data = num_data
        self.label = torch.from_numpy(np.asarray(
            metadata.label, np.float32)).to(device)
        self.weights = None if metadata.weights is None else \
            torch.from_numpy(np.asarray(metadata.weights,
                                        np.float32)).to(device)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _apply_weights(self, grad, hess):
        if self.weights is not None:
            return grad * self.weights, hess * self.weights
        return grad, hess

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def is_constant_hessian(self) -> bool:
        """Every row's hessian is the same (lightgbm_tpu/objectives.py:68):
        quantized training then codes it exactly (`hess_const`)."""
        return False

    def boost_from_average(self) -> bool:
        return False

    def bias(self) -> float:
        """Initial score when boosting from the average (gbdt.cpp:358-378)."""
        return 0.0

    def to_string(self) -> str:
        return self.name


class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp:13-79 (grad = score - label,
    identity output)."""
    name = "regression"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label)
        if metadata.weights is not None:
            w = np.asarray(metadata.weights)
            sums = np.array([np.sum(lab * w), np.sum(w)])
        else:
            sums = np.array([lab.sum(), float(len(lab))])
        self._bias = float(sums[0] / sums[1])

    def get_gradients(self, score):
        grad = score - self.label
        hess = torch.ones_like(score)
        return self._apply_weights(grad, hess)

    def is_constant_hessian(self):
        return self.weights is None

    def boost_from_average(self):
        return True

    def bias(self):
        return self._bias


class BinaryLogloss(ObjectiveFunction):
    """reference: binary_objective.hpp:13-157."""
    name = "binary"
    OUTPUT_KIND = "sigmoid"

    def __init__(self, config: Config):
        self.sigmoid = config.objective_config.sigmoid
        if self.sigmoid <= 0:
            log.fatal("Sigmoid parameter %f should be greater than zero"
                      % self.sigmoid)
        self.is_unbalance = config.objective_config.is_unbalance
        self.scale_pos_weight = config.objective_config.scale_pos_weight
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at "
                      "the same time")
        self.label_weights = (1.0, 1.0)

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label)
        cnt_pos = int((lab > 0).sum())
        cnt_neg = num_data - cnt_pos
        if cnt_pos == 0 or cnt_neg == 0:
            log.warning("Only one class present in label")
        log.info("Number of positive: %d, number of negative: %d",
                 cnt_pos, cnt_neg)
        w_neg, w_pos = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        self.label_weights = (w_neg, w_pos)
        self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg

    def get_gradients(self, score):
        """lightgbm_tpu/objectives.py:258-267, the same f32 operations in
        the same order, with XLA's exp (`xla_exp_f32`), so the gradients
        equal the JAX package's bitwise."""
        is_pos = self.label > 0
        one = torch.ones((), dtype=torch.float32, device=score.device)
        lv = torch.where(is_pos, one, -one)
        lw = torch.where(is_pos, one * self.label_weights[1],
                         one * self.label_weights[0])
        s = self.sigmoid
        response = -lv * s / (1.0 + xla_exp_f32(lv * s * score))
        abs_r = torch.abs(response)
        grad = response * lw
        hess = abs_r * (s - abs_r) * lw
        return self._apply_weights(grad, hess)

    def to_string(self):
        # the reference loader REQUIRES the sigmoid token
        # (binary_objective.hpp:32-42 fatals without it)
        return f"binary sigmoid:{self.sigmoid:g}"

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))


class LambdarankNDCG(ObjectiveFunction):
    """reference: rank_objective.hpp:19-245; lightgbm_tpu/objectives.py
    :493-581. Per-query pairwise lambdas weighted by the change in NDCG,
    through kernel L over unpadded queries (no length buckets, no pair
    budget: those give the TPU fixed shapes)."""
    name = "lambdarank"

    def __init__(self, config: Config):
        self.sigmoid = config.objective_config.sigmoid
        self.optimize_pos_at = config.objective_config.max_position
        gains = config.objective_config.label_gain or \
            [float((1 << i) - 1) for i in range(31)]
        self.label_gain = np.asarray(gains, np.float64)

    def init(self, metadata, num_data, device=torch.device("cpu")):
        """The inverse max DCG at max_position of each query (f64 on the
        host, as dcg_calculator.cpp CalMaxDCGAtK and the JAX package
        compute it, then f32) and each doc's gain, on `device` once."""
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Lambdarank tasks require query information")
        qb = np.asarray(metadata.query_boundaries, np.int64)
        if qb[0] != 0 or qb[-1] != num_data or np.any(np.diff(qb) < 0):
            log.fatal("query boundaries must rise from 0 to num_data (%d)"
                      % num_data)
        lab = np.asarray(metadata.label).astype(int)
        top = len(self.label_gain) - 1
        # rows sorted by (query, -label) stay query-contiguous, so each
        # query's max DCG is a segment sum of masked discounted gains
        qid, pos = query_layout(qb)
        by_label = np.lexsort((-lab, qid))
        contrib = np.where(
            pos < self.optimize_pos_at,
            self.label_gain[np.clip(lab[by_label], 0, top)]
            / np.log2(pos + 2.0), 0.0)
        dcg = segment_sum(contrib, qb)
        inv = np.where(dcg > 0, 1.0 / np.maximum(dcg, 1e-300), 0.0)
        self.inv_max_dcg = torch.from_numpy(inv.astype(np.float32)).to(device)
        self.query_boundaries = torch.from_numpy(qb.astype(np.int32)).to(
            device)
        self.label_int = torch.from_numpy(lab.astype(np.int32)).to(device)
        self.gain = torch.from_numpy(self.label_gain.astype(np.float32)[
            np.clip(lab, 0, top)]).to(device)

    def get_gradients(self, score):
        return lambdarank_grads(score, self.query_boundaries, self.label_int,
                                self.gain, self.inv_max_dcg, self.sigmoid,
                                self.weights)


_PORTED = {
    "regression": RegressionL2,
    "regression_l2": RegressionL2,
    "mean_squared_error": RegressionL2,
    "mse": RegressionL2,
    "l2": RegressionL2,
    "l2_root": RegressionL2,
    "rmse": RegressionL2,
    "binary": BinaryLogloss,
    "lambdarank": LambdarankNDCG,
}

# the JAX package's other objectives (lightgbm_tpu/objectives.py
# _OBJECTIVE_REGISTRY): known names, refused until their slice
_NOT_PORTED = (
    "regression_l1", "l1", "mean_absolute_error", "mae", "huber", "fair",
    "poisson", "multiclass", "softmax", "multiclassova", "multiclass_ova",
    "ova", "ovr", "xentropy", "cross_entropy", "xentlambda",
    "cross_entropy_lambda")


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference: ObjectiveFunction::CreateObjectiveFunction,
    objective_function.cpp:10-36). None for objective='none'."""
    name = config.objective
    if name in ("none", "null", "custom", ""):
        return None
    if name in _NOT_PORTED:
        log.fatal("objective %s is not ported to lightgbm_tpu_torch yet "
                  "(ported: %s)" % (name, ", ".join(sorted(_PORTED))))
    if name not in _PORTED:
        log.fatal("Unknown objective type name: %s" % name)
    return _PORTED[name](config)
