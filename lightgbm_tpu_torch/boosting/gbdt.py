"""Gradient-boosted decision trees: the prediction and model-IO half.

Counterpart of `lightgbm_tpu/boosting/gbdt.py` (reference: class GBDT,
gbdt.h:25-441) for serving: model text in and out, the model-version
bookkeeping that keeps device-resident stacks fresh, and `predict` over
the forest-walk kernels of `ops/predict.py`. Training (`init`,
`train_one_iter`, ...) arrives with the training slice.

Every option this slice does not carry raises a named LightGBMError
instead of answering with something else: `pred_contrib`,
`pred_early_stop`, `tpu_predict_quantize` other than "none", linear-leaf
models and multiclass models.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import log
from ..config import Config
from ..objectives import ObjectiveFunction
from ..ops.predict import (OutputTransform, forest_leaf_walk,
                           forest_value_walk)
from ..serving.forest import CompiledForest
from ..tree import Tree


class GBDT:
    """Reference: class GBDT, gbdt.h:25-441 (prediction and model IO)."""

    def __init__(self, config: Config, device: torch.device):
        self.config = config
        self.device = device
        self.iter_ = 0
        self.models: List[Tree] = []          # flat: iter-major, class-minor
        self.num_class = max(config.objective_config.num_class, 1)
        self.num_tree_per_iteration = 1
        self.objective: Optional[ObjectiveFunction] = None
        self.init_score_bias = 0.0
        self.average_output = False  # RF mode
        self.max_feature_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos_: List[str] = []
        # device-resident stacked-forest cache (serving/forest.py):
        # every ensemble mutation goes through _bump_model_version() so
        # a cached stack can never outlive the model it was built from
        self._compiled_forest = CompiledForest(device)

    # ------------------------------------------------------------------
    # model-version bookkeeping: the version only ever increases
    def _bump_model_version(self) -> None:
        self._compiled_forest.invalidate()

    def num_trees(self) -> int:
        return len(self.models)

    # ------------------------------------------------------------------
    # prediction (reference: gbdt_prediction.cpp + Predictor)

    # rows per kernel launch: bounds the [rows, trees] int32 leaf output
    # held on the device before its copy to the host (262 MB at 2^17
    # rows x 500 trees)
    _PREDICT_ROW_CHUNK = 1 << 17

    def _capped_total(self, num_iteration: int) -> int:
        """Trees used under a num_iteration cap."""
        total = len(self.models)
        if num_iteration > 0:
            total = min(total, num_iteration * self.num_tree_per_iteration)
        return total

    def _forest_cache(self) -> CompiledForest:
        """The cache with its enable bit refreshed from config."""
        self._compiled_forest.enabled = bool(self.config.io.tpu_predict_cache)
        return self._compiled_forest

    def _predict_chunk_rows(self) -> int:
        c = int(self.config.io.tpu_predict_chunk)
        return c if c > 0 else self._PREDICT_ROW_CHUNK

    def _check_supported(self, pred_contrib: bool,
                         pred_early_stop: bool) -> None:
        """Refuse what this slice does not carry (linear-leaf trees are
        refused where the forest is stacked, ops/predict.stack_trees)."""
        if pred_contrib:
            log.fatal("pred_contrib (SHAP values) is not ported to "
                      "lightgbm_tpu_torch yet")
        if pred_early_stop:
            log.fatal("pred_early_stop is not ported to lightgbm_tpu_torch "
                      "yet (its kernel is still to be written)")
        mode = str(self.config.io.tpu_predict_quantize).lower()
        if mode != "none":
            log.fatal("tpu_predict_quantize=%s is not ported to "
                      "lightgbm_tpu_torch yet; serve with "
                      "tpu_predict_quantize=none" % mode)
        if self.num_tree_per_iteration > 1:
            log.fatal("multiclass models (num_tree_per_iteration=%d) are "
                      "not ported to lightgbm_tpu_torch yet"
                      % self.num_tree_per_iteration)

    def _chunks(self, data: np.ndarray, walk, out: np.ndarray) -> np.ndarray:
        """Run `walk(rows_on_device)` over row chunks of `data` into the
        host array `out` (each copy to the host waits for its launch)."""
        c = self._predict_chunk_rows()
        for i in range(0, data.shape[0], c):
            rows = torch.from_numpy(data[i:i + c]).to(self.device)
            out[i:i + c] = walk(rows).cpu().numpy()
        return out

    def _predict_raw_matrix(self, data: np.ndarray, num_iteration: int = -1,
                            transform: Optional[OutputTransform] = None
                            ) -> np.ndarray:
        """[num_data] raw scores of the single-class model (or, with
        `transform`, the converted output computed in the kernel's
        epilogue). Without a transform the f32 raws are averaged and
        biased on the host in f64, as the JAX package does."""
        data = np.ascontiguousarray(data, np.float32)
        n = data.shape[0]
        total = self._capped_total(num_iteration)
        out = np.zeros(n, np.float64)
        if total > 0 and n > 0:
            forest = self._forest_cache().value_stacks(self.models, total)
            self._chunks(data, lambda x: forest_value_walk(
                forest, x, transform), out)
        if transform is None:
            if self.average_output and total > 0:
                out /= max(total // self.num_tree_per_iteration, 1)
            out += self.init_score_bias
        return out

    def predict(self, data: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False,
                pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0) -> np.ndarray:
        self._check_supported(pred_contrib, pred_early_stop)
        total = self._capped_total(num_iteration)
        if pred_leaf:
            data = np.ascontiguousarray(data, np.float32)
            if total == 0 or data.shape[0] == 0:
                return np.zeros((data.shape[0], total), np.int32)
            forest = self._forest_cache().value_stacks(self.models, total)
            return self._chunks(data, lambda x: forest_leaf_walk(forest, x),
                                np.zeros((data.shape[0], total), np.int32))
        if not raw_score and self.objective is not None and total > 0:
            # single-class fast path: averaging, bias and the output
            # transform run in the kernel's epilogue (f32) before the copy
            obj = self.objective
            tr = OutputTransform(
                obj.OUTPUT_KIND,
                denom=float(max(total, 1)) if self.average_output else 1.0,
                bias=float(self.init_score_bias), sigmoid=float(obj.sigmoid))
            return self._predict_raw_matrix(data, num_iteration,
                                            transform=tr)
        raw = self._predict_raw_matrix(data, num_iteration)
        if raw_score or self.objective is None:
            return raw
        # zero-tree model: the transformed bias prior
        conv = self.objective.convert_output(
            torch.from_numpy(raw.astype(np.float32)))
        return conv.numpy().astype(np.float64)

    # ------------------------------------------------------------------
    # model text IO (reference: gbdt_model.cpp:170-370)
    def model_name(self) -> str:
        return "tree"

    def save_model_to_string(self, num_iteration: int = -1) -> str:
        out = [self.model_name()]
        out.append("version=v2_tpu")
        out.append(f"num_class={self.num_class}")
        out.append(f"num_tree_per_iteration={self.num_tree_per_iteration}")
        out.append("label_index=0")
        out.append(f"max_feature_idx={self.max_feature_idx}")
        if self.objective is not None:
            out.append(f"objective={self.objective.to_string()}")
        if self.average_output:
            out.append("average_output")
        out.append("feature_names=" + " ".join(self.feature_names))
        out.append("feature_infos=" + " ".join(
            self.feature_infos_ or ["none"] * (self.max_feature_idx + 1)))
        if self.init_score_bias != 0.0:
            out.append(f"init_score_bias={self.init_score_bias}")
        out.extend(self._extra_model_header(num_iteration))
        out.append("")
        total = self._capped_total(num_iteration)
        for i in range(total):
            out.append(f"Tree={i}")
            out.append(self.models[i].to_string())
        out.append("end of trees")
        out.append("")
        imp = self.feature_importance("split")
        pairs = sorted(((v, self.feature_names[i])
                        for i, v in enumerate(imp) if v > 0), reverse=True)
        out.append("feature importances:")
        for v, name in pairs:
            out.append(f"{name}={int(v)}")
        return "\n".join(out) + "\n"

    def _extra_model_header(self, num_iteration: int = -1) -> List[str]:
        """Subclass hook for extra `key=value` header lines (DART's drop
        ledger), emitted before the tree blocks."""
        return []

    def save_model(self, filename: str, num_iteration: int = -1) -> None:
        # tmp + fsync + rename: an interrupted save never leaves a
        # truncated file that still parses as a shorter model
        tmp = "%s.tmp.%d" % (filename, os.getpid())
        with open(tmp, "w") as fh:
            fh.write(self.save_model_to_string(num_iteration))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, filename)
        log.info("Saved model to %s", filename)

    def load_model_from_string(self, text: str) -> None:
        """Reference: GBDT::LoadModelFromString, gbdt_model.cpp:247-330."""
        kv: Dict[str, str] = {}
        tree_blocks: List[List[str]] = []
        cur: Optional[List[str]] = None
        for line in text.splitlines():
            ls = line.strip()
            if ls.startswith("Tree="):
                if cur is not None:
                    tree_blocks.append(cur)
                cur = []
                continue
            if ls == "end of trees":
                if cur is not None:
                    tree_blocks.append(cur)
                cur = None
                continue
            if cur is not None:
                if ls:
                    cur.append(ls)
            elif "=" in ls:
                k, v = ls.split("=", 1)
                kv[k] = v
            elif ls == "average_output":
                kv["average_output"] = "1"
        if cur:
            tree_blocks.append(cur)
        self.set_model(
            {"num_class": int(kv.get("num_class", 1)),
             "num_tree_per_iteration": int(kv.get(
                 "num_tree_per_iteration", kv.get("num_class", 1))),
             "max_feature_idx": int(kv.get("max_feature_idx", 0)),
             "feature_names": kv.get("feature_names", "").split(),
             "feature_infos": kv.get("feature_infos", "").split(),
             "init_score_bias": float(kv.get("init_score_bias", 0.0)),
             "average_output": "average_output" in kv},
            [Tree.from_string("\n".join(b)) for b in tree_blocks])

    def set_model(self, header: dict, models: List[Tree]) -> None:
        """Install an ensemble and its header (the shared end of the text
        route and of `convert.booster_from_numpy`)."""
        self.num_class = int(header.get("num_class", 1))
        self.num_tree_per_iteration = int(header.get(
            "num_tree_per_iteration", self.num_class))
        self.max_feature_idx = int(header.get("max_feature_idx", 0))
        self.feature_names = list(header.get("feature_names") or [
            f"Column_{i}" for i in range(self.max_feature_idx + 1)])
        self.feature_infos_ = list(header.get("feature_infos") or [])
        self.init_score_bias = float(header.get("init_score_bias", 0.0))
        self.average_output = bool(header.get("average_output", False))
        self.models = list(models)
        self.iter_ = len(self.models) // max(self.num_tree_per_iteration, 1)
        self._bump_model_version()

    # ------------------------------------------------------------------
    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """Reference: GBDT::FeatureImportance (gbdt_model.cpp:335-370)."""
        imp = np.zeros(self.max_feature_idx + 1, np.float64)
        for t in self.models[:self._capped_total(num_iteration)]:
            for j in range(t.num_leaves - 1):
                if importance_type == "split":
                    imp[t.split_feature[j]] += 1
                else:
                    imp[t.split_feature[j]] += max(t.split_gain[j], 0.0)
        return imp
