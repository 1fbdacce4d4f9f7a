"""Public Booster API (the serving half).

Counterpart of `lightgbm_tpu/basic.py` `Booster` (reference
python-package basic.py:1223): a model loaded from text, predicted on
the CUDA card through the port's kernels. The one argument the JAX
Booster does not have is `device`: None means "cuda" and raises where
there is no card; `device="cpu"` runs the plain versions of the kernels.
Training (`train_set=`) arrives with the training slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from . import log
from .boosting import create_boosting
from .config import Config
from .device import resolve_device
from .objectives import create_objective

LightGBMError = log.LightGBMError


def _data_to_2d(data) -> np.ndarray:
    if isinstance(data, str):
        raise LightGBMError("predicting from a data file is not ported to "
                            "lightgbm_tpu_torch yet; pass an array")
    try:
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            return data.values.astype(np.float64)
    except ImportError:
        pass
    try:
        import scipy.sparse as sp
        if sp.issparse(data):
            return np.asarray(data.todense(), np.float64)
    except ImportError:
        pass
    arr = np.asarray(data, np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return arr


def objective_params(objective: Optional[str]) -> Dict[str, str]:
    """Params from a model text's `objective=` value, e.g. "binary
    sigmoid:1" -> {"objective": "binary", "sigmoid": "1"}."""
    if not objective:
        return {}
    obj = objective.split()
    params = {"objective": obj[0]}
    for tok in obj[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            params[k] = v
    return params


class Booster:
    """Reference: basic.py:1223+ over c_api Booster (c_api.cpp:28-308)."""

    def __init__(self, params: Optional[dict] = None, train_set=None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, silent: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        if train_set is not None:
            raise LightGBMError("training is not ported to "
                                "lightgbm_tpu_torch yet (train_set=)")
        self.params = dict(params or {})
        self.device = resolve_device(device)
        if model_file is not None:
            with open(model_file) as fh:
                text = fh.read()
            self._from_string(text)
        elif model_str is not None:
            self._from_string(model_str)
        else:
            raise LightGBMError("Booster needs model_file or model_str")

    @classmethod
    def _assemble(cls, boosting_type: str, objective: Optional[str],
                  fill: Callable, params: Optional[dict] = None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> "Booster":
        """A Booster whose engine `fill` installs the ensemble into
        (convert.booster_from_numpy; the text route is __init__)."""
        self = cls.__new__(cls)
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self._load(boosting_type, objective, fill)
        return self

    def _from_string(self, text: str) -> None:
        first = text.strip().splitlines()[0].strip()
        boosting_type = {"tree": "gbdt", "gbdt": "gbdt", "dart": "dart",
                         "goss": "goss"}.get(first, "gbdt")
        # objective from model text so convert_output works
        objective = None
        for line in text.splitlines()[:20]:
            if line.startswith("objective="):
                objective = line.split("=", 1)[1]
                break
        self._load(boosting_type, objective,
                   lambda gbdt: gbdt.load_model_from_string(text))

    def _load(self, boosting_type: str, objective: Optional[str],
              fill: Callable) -> None:
        """Build the engine, `fill(engine)` it with the ensemble, then
        attach the objective (shared by the text and array routes)."""
        params = dict(self.params)
        for k, v in objective_params(objective).items():
            params.setdefault(k, v)
        cfg = Config.from_params(params)
        self.config = cfg
        self._inner = create_boosting(boosting_type, cfg, self.device)
        fill(self._inner)
        if "objective" in params:
            self._inner.objective = create_objective(cfg)
        # the shared Predictor (if any) is bound to the replaced engine
        self._serving_default = None

    # ------------------------------------------------------------------
    def num_trees(self) -> int:
        return self._inner.num_trees()

    def num_feature(self) -> int:
        return self._inner.max_feature_idx + 1

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._inner.save_model_to_string(num_iteration)

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        self._inner.save_model(filename, num_iteration)
        return self

    # ------------------------------------------------------------------
    def serving_predictor(self, **kwargs):
        """A serving front end bound to this booster (reference:
        Predictor, predictor.hpp:24-205). Kwargs fix the default predict
        arguments (num_iteration, raw_score, pred_leaf, ...)."""
        from .serving import Predictor
        return Predictor(self, **kwargs)

    def _serving(self):
        """Shared default Predictor every Booster.predict routes
        through, so serving counters accumulate per booster."""
        p = self._serving_default
        if p is None:
            p = self.serving_predictor()
            self._serving_default = p
        return p

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False, pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0):
        arr = _data_to_2d(data)
        return self._serving().predict(
            arr, num_iteration=num_iteration, raw_score=raw_score,
            pred_leaf=pred_leaf, pred_contrib=pred_contrib,
            pred_early_stop=pred_early_stop,
            pred_early_stop_freq=pred_early_stop_freq,
            pred_early_stop_margin=pred_early_stop_margin)
