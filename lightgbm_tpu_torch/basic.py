"""Public Dataset / Booster API.

Counterpart of `lightgbm_tpu/basic.py` (reference python-package
basic.py: the lazy `Dataset` at :548, `Booster` at :1223) for numpy
input: a `Dataset` bins its matrix on the host when first needed (a
valid set through its `reference`); `Booster(params, train_set=)`
trains on the CUDA card through the port's kernels (`update`,
`add_valid`, `eval_train`, `eval_valid`, `rollback_one_iter`), and a
Booster from model text serves. The one argument the JAX Booster does
not have is `device`: None means "cuda" and raises where there is no
card; `device="cpu"` runs the plain versions of the kernels.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import log
from .boosting import create_boosting
from .boosting.gbdt import refuse_unported_training
from .config import Config, _parse_value, key_alias_transform
from .dataset import Dataset as _InnerDataset
from .device import resolve_device
from .metrics import default_metric_for_objective
from .objectives import create_objective

LightGBMError = log.LightGBMError


def _data_to_2d(data) -> np.ndarray:
    if isinstance(data, str):
        # a data file's features, its label column dropped
        # (lightgbm_tpu/basic.py:31-35)
        from .io.parser import load_data_file
        arr, _ = load_data_file(data)
        return arr
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


class Dataset:
    """Lazy dataset (reference: basic.py:548-1222), numpy input only."""

    def __init__(self, data, label=None, max_bin: int = 255,
                 reference: Optional["Dataset"] = None, weight=None,
                 group=None, init_score=None, silent: bool = False,
                 feature_name: Union[str, Sequence[str]] = "auto",
                 categorical_feature: Union[str, Sequence] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = False):
        if isinstance(data, str):
            raise LightGBMError("training from a data file is not ported "
                                "to lightgbm_tpu_torch yet; pass an array")
        self.data = data
        self.label = label
        self.max_bin = max_bin
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.params = dict(params or {})
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        # taken as the JAX package takes it (lightgbm_tpu/basic.py:99);
        # the port keeps a Dataset's raw values when its params say
        # linear_tree, whatever this says
        self.free_raw_data = free_raw_data
        self._inner: Optional[_InnerDataset] = None

    def _update_params(self, params: Dict[str, Any]) -> "Dataset":
        """Training params reach a dataset not yet constructed; a
        constructed one keeps its bins, and says so when max_bin differs
        (lightgbm_tpu/basic.py:141)."""
        if not params:
            return self
        if self._inner is None:
            self.params.update(params)
            return self
        new_bin = key_alias_transform(dict(params)).get("max_bin")
        built = self._inner.max_bin
        if new_bin is not None and int(new_bin) != built:
            log.warning("Dataset already constructed with max_bin=%d; "
                        "ignoring max_bin=%s from training params",
                        built, new_bin)
        return self

    def _lazy_init(self) -> _InnerDataset:
        if self._inner is not None:
            return self._inner
        params = key_alias_transform(self.params)
        if self.categorical_feature not in ("auto", None, []) \
                or params.get("categorical_column"):
            raise LightGBMError("categorical features are not ported to "
                                "lightgbm_tpu_torch training yet")
        data = _data_to_2d(self.data)
        names = None if self.feature_name in ("auto", None) \
            else list(self.feature_name)
        ref = self.reference._lazy_init() if self.reference is not None \
            else None
        self._inner = _InnerDataset.from_numpy(
            data, label=None if self.label is None else np.asarray(
                self.label, np.float32).ravel(),
            max_bin=int(params.get("max_bin", self.max_bin)),
            min_data_in_bin=int(params.get("min_data_in_bin", 3)),
            bin_construct_sample_cnt=int(params.get(
                "bin_construct_sample_cnt", 200000)),
            data_random_seed=int(params.get("data_random_seed", 1)),
            use_missing=_parse_value(params.get("use_missing", True), bool),
            zero_as_missing=_parse_value(
                params.get("zero_as_missing", False), bool),
            feature_names=names, weight=self.weight, group=self.group,
            init_score=self.init_score, reference=ref,
            enable_bundle=_parse_value(params.get("enable_bundle", True),
                                       bool),
            max_conflict_rate=float(params.get("max_conflict_rate", 0.0)),
            sparse_threshold=float(params.get("sparse_threshold", 0.8)),
            chunk_rows=int(params.get("tpu_ingest_chunk_rows", 65536)),
            # linear trees regress on raw values: linear_tree in the
            # params keeps them (lightgbm_tpu/basic.py:307-320)
            keep_raw=_parse_value(params.get("linear_tree", False), bool))
        return self._inner

    def construct(self) -> "Dataset":
        self._lazy_init()
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, silent: bool = False,
                     params: Optional[dict] = None) -> "Dataset":
        """Reference: basic.py Dataset.create_valid."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, silent=silent,
                       params=params or self.params)

    def set_group(self, group) -> "Dataset":
        """Per-query sizes (lightgbm_tpu/basic.py:377-381)."""
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_group(group)
        return self

    def get_group(self):
        return self.group

    def get_field(self, name: str):
        """lightgbm_tpu/basic.py:413-423; "group" gives per-query sizes."""
        meta = self._lazy_init().metadata
        if name == "label":
            return meta.label
        if name == "weight":
            return meta.weights
        if name == "group":
            qb = meta.query_boundaries
            return None if qb is None else np.diff(qb)
        if name == "init_score":
            return meta.init_score
        raise LightGBMError(f"Unknown field {name}")

    def set_field(self, name: str, data) -> None:
        """lightgbm_tpu/basic.py:425-436."""
        meta = self._lazy_init().metadata
        if name == "label":
            meta.set_label(data)
        elif name == "weight":
            meta.set_weights(data)
        elif name == "group":
            meta.set_group(data)
        elif name == "init_score":
            meta.set_init_score(data)
        else:
            raise LightGBMError(f"Unknown field {name}")


class Booster:
    """Reference: basic.py:1223+ over c_api Booster (c_api.cpp:28-308)."""

    def __init__(self, params: Optional[dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, silent: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self.train_set = train_set
        self._valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_data_name = "training"
        self._serving_default = None
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise LightGBMError(
                    "training is not ported to lightgbm_tpu_torch for a "
                    "train_set of type %s; pass a lightgbm_tpu_torch.Dataset"
                    % type(train_set).__name__)
            cfg = Config.from_params(self.params)
            self.config = cfg
            refuse_unported_training(cfg)
            inner = train_set._lazy_init()
            objective = create_objective(cfg)
            self._inner = create_boosting(cfg.boosting_type, cfg,
                                          self.device)
            self._metric_names = cfg.metric.metric_types or \
                [default_metric_for_objective(cfg.objective)]
            self._inner.init(inner, objective, self._metric_names)
        elif model_file is not None:
            with open(model_file) as fh:
                text = fh.read()
            self._from_string(text)
        elif model_str is not None:
            self._from_string(model_str)
        else:
            raise LightGBMError("Booster needs train_set, model_file or "
                                "model_str")

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
    # training (reference: basic.py Booster.update / add_valid / eval)
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if data.reference is None and self.train_set is not None:
            data.reference = self.train_set
        inner = data._lazy_init()
        self._valid_sets.append(data)
        self.name_valid_sets.append(name)
        self._inner.add_valid(inner, name, self._metric_names)
        return self

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True when no tree could split."""
        if fobj is not None or train_set is not None:
            raise LightGBMError("custom objectives (fobj) and a new "
                                "train_set in update() are not ported to "
                                "lightgbm_tpu_torch yet")
        self._serving_default = None
        return self._inner.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        self._inner.rollback_one_iter()
        self._serving_default = None
        return self

    def current_iteration(self) -> int:
        return self._inner.current_iteration()

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def eval_train(self, feval=None) -> List:
        self._refuse_feval(feval)
        score = self._inner._train_score_unpadded()
        return [(self._train_data_name, name, val, m.is_bigger_better)
                for m in self._inner.metrics
                for name, val in m.eval(score, self._inner.objective)]

    def eval_valid(self, feval=None) -> List:
        self._refuse_feval(feval)
        out = []
        for i, name in enumerate(self.name_valid_sets):
            score = self._inner.valid_score(i)
            for m in self._inner.valid_metrics[i]:
                for mname, val in m.eval(score, self._inner.objective):
                    out.append((name, mname, val, m.is_bigger_better))
        return out

    @staticmethod
    def _refuse_feval(feval) -> None:
        if feval is not None:
            raise LightGBMError("custom metrics (feval) are not ported to "
                                "lightgbm_tpu_torch yet")

    def num_trees(self) -> int:
        return self._inner.num_trees()

    def num_feature(self) -> int:
        return self._inner.max_feature_idx + 1

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        return self._inner.feature_importance(importance_type, iteration)

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._inner.save_model_to_string(num_iteration)

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        self._inner.save_model(filename, num_iteration)
        return self

    def dump_model(self, num_iteration: int = -1) -> dict:
        """The model as JSON (lightgbm_tpu/basic.py:763)."""
        return self._inner.dump_model(num_iteration)

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
