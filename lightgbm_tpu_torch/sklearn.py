"""scikit-learn API wrappers.

The port's copy of `lightgbm_tpu/sklearn.py` (reference
python-package/lightgbm/sklearn.py:584-759): `LGBMModel` and
`LGBMRegressor`, `LGBMClassifier` (binary) and `LGBMRanker` over
`engine.train`, with get_params / set_params / clone, eval sets, early
stopping and the serving front end. scikit-learn is optional: without
it the classes stand on their own bases. The one argument the JAX
classes do not have is `device` (None: the CUDA card, raising where
there is none; "cpu": the plain versions of the kernels). What the port
does not carry raises a named LightGBMError: multiclass
classification, a callable objective and a callable eval_metric.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .basic import Booster, Dataset, LightGBMError
from .engine import train

try:
    from sklearn.base import (BaseEstimator as _SKBase,
                              ClassifierMixin as _SKClassifierMixin,
                              RegressorMixin as _SKRegressorMixin)
except ImportError:  # scikit-learn is optional
    class _SKBase:
        pass

    class _SKClassifierMixin:
        pass

    class _SKRegressorMixin:
        pass


class LGBMModel(_SKBase):
    """Reference: sklearn.py:96-583 (LGBMModel)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, max_bin: int = 255,
                 subsample_for_bin: int = 200000,
                 objective: Optional[str] = None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 linear_tree: bool = False, linear_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 silent: bool = True, device=None, **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.max_bin = max_bin
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.linear_tree = linear_tree
        self.linear_lambda = linear_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.device = device
        self._other_params: Dict = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._n_features = 0

    _PARAM_NAMES = (
        "boosting_type", "num_leaves", "max_depth", "learning_rate",
        "n_estimators", "max_bin", "subsample_for_bin", "objective",
        "min_split_gain", "min_child_weight", "min_child_samples",
        "subsample", "subsample_freq", "colsample_bytree", "reg_alpha",
        "reg_lambda", "linear_tree", "linear_lambda", "random_state",
        "n_jobs", "silent", "device")

    # -- sklearn protocol -------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict:
        params = {k: getattr(self, k) for k in self._PARAM_NAMES}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if key in self._PARAM_NAMES:
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    # ---------------------------------------------------------------------
    def _default_objective(self) -> str:
        return "regression"

    def _train_params(self) -> Dict:
        """The training params the estimator's attributes stand for
        (lightgbm_tpu/sklearn.py:148-177)."""
        if callable(self.objective):
            raise LightGBMError("a callable objective (custom objective) is "
                                "not ported to lightgbm_tpu_torch yet")
        params = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "max_bin": self.max_bin,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "linear_tree": self.linear_tree,
            "linear_lambda": self.linear_lambda,
            "verbose": -1 if self.silent else 1,
        }
        if self.random_state is not None:
            params["seed"] = self.random_state
        params["objective"] = self.objective or self._default_objective()
        params.update(self._other_params)
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            early_stopping_rounds=None, verbose: bool = False,
            feature_name="auto", categorical_feature="auto",
            callbacks=None) -> "LGBMModel":
        params = self._train_params()
        if callable(eval_metric):
            raise LightGBMError("a callable eval_metric (custom metric) is "
                                "not ported to lightgbm_tpu_torch yet")
        if eval_metric is not None:
            params["metric"] = eval_metric
        X = np.asarray(X, np.float64) if not hasattr(X, "dtypes") else X
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets, valid_names = [], []
        if isinstance(eval_set, tuple):
            eval_set = [eval_set]
        for i, (vx, vy) in enumerate(eval_set or []):
            if np.asarray(vx).shape == np.asarray(X).shape and np.array_equal(
                    np.asarray(vx, np.float64), np.asarray(X, np.float64)):
                valid_sets.append(train_set)
            else:
                valid_sets.append(train_set.create_valid(
                    vx, label=vy,
                    weight=eval_sample_weight[i] if eval_sample_weight
                    else None,
                    group=eval_group[i] if eval_group else None,
                    init_score=eval_init_score[i] if eval_init_score
                    else None))
            valid_names.append(eval_names[i] if eval_names else f"valid_{i}")
        self._evals_result = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=valid_names,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self._evals_result, verbose_eval=verbose,
            callbacks=callbacks, device=self.device)
        self._best_iteration = self._Booster.best_iteration
        self._n_features = self._Booster.num_feature()
        return self

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                pred_leaf: bool = False, pred_contrib: bool = False):
        """Through the booster's shared serving Predictor."""
        return self.booster_.predict(X, num_iteration=num_iteration,
                                     raw_score=raw_score, pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib)

    def serving_predictor(self, **kwargs):
        """The serving front end over the fitted booster
        (`lightgbm_tpu_torch.serving.Predictor`)."""
        return self.booster_.serving_predictor(**kwargs)

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found; call fit first")
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance()

    @property
    def n_features_(self) -> int:
        return self._n_features


class LGBMRegressor(_SKRegressorMixin, LGBMModel):
    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(_SKClassifierMixin, LGBMModel):
    """Binary classification (the JAX class's multiclass branch is
    refused until multiclass training is ported)."""

    def _default_objective(self) -> str:
        return "binary"

    def fit(self, X, y, **kwargs):
        y = np.asarray(y).ravel()
        self._classes, y_enc = np.unique(y, return_inverse=True)
        if len(self._classes) > 2:
            raise LightGBMError("multiclass classification (%d classes) is "
                                "not ported to lightgbm_tpu_torch yet"
                                % len(self._classes))
        super().fit(X, y_enc, **kwargs)
        return self

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> int:
        return len(self._classes)

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                pred_leaf: bool = False, pred_contrib: bool = False):
        result = self.predict_proba(X, raw_score, num_iteration, pred_leaf,
                                    pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        return self._classes[(result[:, 1] > 0.5).astype(int)]

    def predict_proba(self, X, raw_score: bool = False,
                      num_iteration: int = -1, pred_leaf: bool = False,
                      pred_contrib: bool = False):
        result = super().predict(X, raw_score, num_iteration, pred_leaf,
                                 pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        return np.vstack([1.0 - result, result]).T


class LGBMRanker(LGBMModel):
    """Learning to rank with lambdarank; `eval_at` sets the NDCG/MAP
    cut-offs (ndcg_eval_at)."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, eval_set=None, eval_group=None,
            eval_at=None, **kwargs):
        if group is None:
            raise LightGBMError("Should set group for ranking task")
        if eval_set is not None:
            n_sets = 1 if isinstance(eval_set, tuple) else len(eval_set)
            if eval_group is None or len(eval_group) != n_sets \
                    or any(g is None for g in eval_group):
                raise LightGBMError("Should set eval_group for every "
                                    "eval_set of a ranking task")
        self._eval_at = eval_at
        super().fit(X, y, group=group, eval_set=eval_set,
                    eval_group=eval_group, **kwargs)
        return self

    def _train_params(self) -> Dict:
        params = super()._train_params()
        if getattr(self, "_eval_at", None) is not None:
            params["ndcg_eval_at"] = list(self._eval_at)
        return params
