"""Gradient-boosted decision trees: training, prediction and model IO.

Counterpart of `lightgbm_tpu/boosting/gbdt.py` (reference: class GBDT,
gbdt.h:25-441). Serving: model text in and out, the model-version
bookkeeping that keeps device-resident stacks fresh, and `predict` over
the forest-walk kernels of `ops/predict.py`. Training, the synchronous
serial path (`init`, `train_one_iter`, `add_valid`, `eval_once`,
`rollback_one_iter`): the binned matrix and the scores live on the
device; each iteration takes the objective's gradients (kernel L for
lambdarank), draws the bagging mask when `bagging_freq > 0` and
`bagging_fraction < 1` (kernel M, JAX's threefry stream, `ops/rng.py`),
under `tpu_hist_quantize=int8|int16` quantizes the gradients (kernel Q)
and grows on int32 histograms (kernel HQ), else on f32 ones (kernel H),
grows one tree with `learner/grow.py` (kernels S and R), adds its shrunk
leaf values to the train scores (R's score update) and to every valid
set's scores (kernel W), and keeps the tree on the host. With
`linear_tree` each grown tree's leaves get linear models fitted on the
raw values of their path features (`linear/solver.py`: kernels LF and
LS), and the scores get each row's leaf value plus its linear term
(kernel LA; valid sets find the leaves with W's leaf mode). A quantized
run first passes the JAX package's train-time gate
(`_hist_quant_gate`): one small tree grown quantized and one in f32 on
the leading `tpu_hist_chunk` rows must agree within
`tpu_hist_quantize_tol`.

GOSS, DART and RF train through subclasses (`goss.py`, `dart.py`,
`rf.py`) over the hooks here: `_bagging_weights(iter, grad, hess)` gives
the [n] f32 row weight of an iteration (M's 0/1 bag, or GOSS's weights
from kernels GT and GW) and `_grow_tree` grows and extracts one tree
from given gradients, weight and feature mask. f32 histograms are
summed in bf16 hi+lo halves under `tpu_hist_bf16` (true by default, as
in the JAX package), in f32 otherwise.

Serving takes the JAX package's options: `pred_leaf`, `pred_contrib`
(TreeSHAP on the host, `shap.py`), `pred_early_stop` (kernel ES, for a
binary objective; ignored for any other, as in the JAX package, and it
turns quantize off) and `tpu_predict_quantize=f16|int8` (K1's f16 mode,
kernels QC and QW) behind the JAX package's accuracy gate
(`_quant_gate`); `dump_model` gives the JSON dump. Every option the
port does not carry raises a named LightGBMError instead of answering
with something else: in serving multiclass models; in training
multiclass and the distributed tree learners. Categorical features
train (S's one-vs-rest variant, R's equality route, W's bin-space
bitsets), as do quantized histograms on uint16 bins (HQ's uint16
mode).
GOSS, RF and linear trees keep the JAX package's own refusals (GOSS with
bagging or a rate <= 0; RF without bagging or without a feature_fraction
in (0, 1); linear trees with dart or rf, multiclass, more than one
machine, `pred_contrib`, quantized serving layouts).
The JAX package's other schedule keys (`tpu_batch_k`,
`tpu_hist_subtract`, `tpu_hist_compact`, `tpu_compact_threshold`)
choose how its TPU programs run, not which trees grow; the port takes
them and ignores them. `tpu_hist_chunk` does the same, except that it
sizes the quantize gate's calibration slice, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import log
from ..config import Config
from ..ingest.landing import hist_chunk
from ..learner.grow import GrowerConfig, SerialGrower, leaf_path_features
from ..linear.solver import fit_leaves
from ..metrics import create_metric
from ..objectives import ObjectiveFunction
from ..ops.histogram import (TRAIN_QUANTIZE_MODES, quantize_gradients,
                             train_qmax)
from ..ops.linear import check_linear_features, linear_addend
from ..ops.predict import (OutputTransform, QuantRefused, binned_tree,
                           forest_early_stop_walk, forest_leaf_walk,
                           forest_quant_walk, forest_value_walk,
                           forest_value_walk_f16, quant_codes,
                           tree_leaf_walk_binned, tree_value_walk_binned,
                           walk_by_columns, walk_layout)
from ..ops.rng import bagging_mask, fold_in, prng_key
from ..ops.route import score_update
from ..serving.forest import QUANTIZE_MODES, CompiledForest
from ..tree import Tree

_K_EPSILON = 1e-15


def feature_fraction_mask(rng: np.random.RandomState, frac: float,
                          num_features: int) -> np.ndarray:
    """One per-tree feature_fraction sample, drawing from `rng` exactly
    as lightgbm_tpu/boosting/gbdt.py:124 does
    (serial_tree_learner.cpp:239-257)."""
    if frac >= 1.0:
        return np.ones(num_features, bool)
    used = max(1, int(num_features * frac))
    idx = rng.choice(num_features, size=used, replace=False)
    mask = np.zeros(num_features, bool)
    mask[idx] = True
    return mask


def boosting_kind(boosting_type: str) -> str:
    """The boosting type with `random_forest` named `rf`, as
    lightgbm_tpu/boosting/__init__.py creates it."""
    return "rf" if boosting_type == "random_forest" else boosting_type


def refuse_unported_training(config: Config) -> None:
    """Raise by name for what the training slice does not carry: it
    trains boosting=gbdt, goss, dart and rf, with or without bagging
    (`bagging_freq=0` is no bagging, as in the JAX package), with f32 or
    quantized (`tpu_hist_quantize=int8|int16`) histograms, with constant
    or linear leaves. GOSS, RF and linear trees keep the JAX package's
    refusals (lightgbm_tpu/boosting/goss.py:19-22, rf.py:21-25,
    gbdt.py:656-672)."""
    cfg = config
    bc = cfg.boosting
    kind = boosting_kind(cfg.boosting_type)
    if cfg.tree.linear_tree:
        if kind not in ("gbdt", "goss"):
            log.fatal("linear_tree supports boosting=gbdt/goss only (got "
                      "%s): dart re-normalization and RF averaging replay "
                      "trees through the binned-only path"
                      % cfg.boosting_type)
        if cfg.objective_config.num_class > 1:
            log.fatal("linear_tree does not support multiclass training "
                      "(num_tree_per_iteration=%d); train one-vs-all "
                      "boosters or set linear_tree=false"
                      % cfg.objective_config.num_class)
        if cfg.network.num_machines > 1:
            log.fatal("linear_tree does not support multi-host training "
                      "(the leaf regression needs the global raw matrix "
                      "resident on every process); set linear_tree=false")
    if kind == "goss":
        if bc.top_rate <= 0 or bc.other_rate <= 0:
            log.fatal("GOSS requires top_rate > 0 and other_rate > 0")
        if bc.bagging_freq > 0 and bc.bagging_fraction != 1.0:
            log.fatal("Cannot use bagging in GOSS")
    if kind == "rf":
        if not (bc.bagging_freq > 0 and 0.0 < bc.bagging_fraction < 1.0):
            log.fatal("RF mode requires bagging "
                      "(bagging_freq > 0 and bagging_fraction in (0,1))")
        if not 0.0 < cfg.tree.feature_fraction < 1.0:
            log.fatal("RF mode requires feature_fraction in (0, 1)")
        if str(cfg.tree.tpu_hist_quantize or "none").lower() != "none":
            log.fatal("RF mode grows its trees from the f32 gradients of "
                      "the zero score: train it with tpu_hist_quantize=none")
    if kind not in ("gbdt", "goss", "dart", "rf"):
        log.fatal("boosting=%s is not a boosting type lightgbm_tpu_torch "
                  "trains (gbdt, goss, dart, rf)" % cfg.boosting_type)
    if cfg.objective_config.num_class > 1:
        log.fatal("multiclass training (num_class=%d) is not ported to "
                  "lightgbm_tpu_torch yet" % cfg.objective_config.num_class)
    if cfg.tree_learner != "serial":
        log.fatal("tree_learner=%s is not ported to lightgbm_tpu_torch yet "
                  "(train with tree_learner=serial)" % cfg.tree_learner)


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
        self.shrinkage_rate = config.boosting.learning_rate
        self.train_data = None
        self.metrics: list = []
        self.valid_sets: list = []
        self.valid_names: List[str] = []
        self.valid_metrics: list = []
        self._valid_binned: List[torch.Tensor] = []
        self._valid_raw: List[Optional[torch.Tensor]] = []
        self._valid_score: List[torch.Tensor] = []
        # device-resident stacked-forest cache (serving/forest.py):
        # every ensemble mutation goes through _bump_model_version() so
        # a cached stack can never outlive the model it was built from
        self._compiled_forest = CompiledForest(device)
        # set while Predictor.warmup runs: the quantize gate waits for
        # the first real batch (_quant_gate)
        self._quant_gate_defer = False

    # ------------------------------------------------------------------
    # model-version bookkeeping: the version only ever increases
    def _bump_model_version(self) -> None:
        self._compiled_forest.invalidate()

    def num_trees(self) -> int:
        return len(self.models)

    # ------------------------------------------------------------------
    # training (reference: gbdt.cpp; lightgbm_tpu/boosting/gbdt.py)
    def _device_bins(self, binned: np.ndarray) -> torch.Tensor:
        """The binned matrix on the device: uint8, or uint16 where a group
        has more than 256 bins (efb.py FeatureGroups.dtype). A read-only
        matrix (a mapped binary cache) is copied first."""
        binned = np.ascontiguousarray(binned)
        if not binned.flags.writeable:
            binned = binned.copy()
        return torch.from_numpy(binned).to(self.device)

    def init(self, train_data, objective: Optional[ObjectiveFunction],
             metric_names=()) -> None:
        """Reference: GBDT::Init, gbdt.cpp:65-193
        (lightgbm_tpu/boosting/gbdt.py:481); Booster has refused what is
        not ported (refuse_unported_training) before building the
        objective."""
        if objective is None:
            log.fatal("training with a custom objective (objective=none, "
                      "fobj) is not ported to lightgbm_tpu_torch yet")
        if train_data.metadata.label is None:
            log.fatal("Training data must have a label")
        if train_data.num_features == 0:
            log.fatal("every feature of the training data is constant; "
                      "there is nothing to split on")
        self.train_data = train_data
        self.objective = objective
        self.num_tree_per_iteration = 1
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos_ = train_data.feature_infos()
        n = train_data.num_data
        self._n = n
        self._binned = self._device_bins(train_data.binned)
        objective.init(train_data.metadata, n, self.device)
        self._score = torch.zeros((1, n), dtype=torch.float32,
                                  device=self.device)
        init_score = train_data.metadata.init_score
        if init_score is not None:
            self._score += torch.from_numpy(
                np.asarray(init_score, np.float32).reshape(1, n)).to(
                    self.device)
        self.metrics = []
        for name in metric_names:
            m = create_metric(name, self.config)
            if m is not None:
                m.init(train_data.metadata, n)
                self.metrics.append(m)
        tc = self.config.tree
        # quantized training (lightgbm_tpu/boosting/gbdt.py:792-841): the
        # clip magnitude adapts to the row count so no int32 bin sum can
        # overflow; a constant hessian is coded exactly
        quant = str(tc.tpu_hist_quantize or "none").lower()
        if quant not in TRAIN_QUANTIZE_MODES:
            log.fatal("tpu_hist_quantize must be one of %s (got %r)"
                      % (TRAIN_QUANTIZE_MODES, quant))
        self._quant_mode = quant
        self._quant_qmax = train_qmax(quant, n) if quant != "none" else 0
        self._quant_hess_const = bool(
            quant != "none" and objective.is_constant_hessian()
            and self.config.boosting_type == "gbdt")
        self._quant_seed = int(self.config.io.data_random_seed)
        self._chunk = hist_chunk(n, train_data.num_groups,
                                 train_data.max_num_bin(), tc.tpu_hist_chunk)
        self._grower_args = (
            train_data.feature_meta_arrays(),
            GrowerConfig(
                num_leaves=tc.num_leaves, lambda_l1=tc.lambda_l1,
                lambda_l2=tc.lambda_l2,
                min_gain_to_split=tc.min_gain_to_split,
                min_data_in_leaf=tc.min_data_in_leaf,
                min_sum_hessian_in_leaf=tc.min_sum_hessian_in_leaf,
                max_depth=tc.max_depth, hist_quantize=quant,
                hist_qmax=self._quant_qmax,
                hist_bf16=bool(tc.tpu_hist_bf16)),
            train_data.max_num_bin(),
            int(train_data.num_bins_per_feature().max()),
            train_data.groups.group_num_bin.copy())
        fm, gcfg, num_bins, feature_bins, group_bins = self._grower_args
        self._grower = SerialGrower(self._binned, fm, gcfg, num_bins,
                                    feature_bins, group_bins)
        self._feature_rng = np.random.RandomState(tc.feature_fraction_seed)
        self._ones = torch.ones(n, dtype=torch.float32, device=self.device)
        bc = self.config.boosting
        self._bag = None
        if bc.bagging_fraction < 1.0 and bc.bagging_freq > 0:
            self._bag = torch.empty(n, dtype=torch.float32,
                                    device=self.device)
        self._bag_drawn = False
        # linear leaves (lightgbm_tpu/boosting/gbdt.py:646-688): the fit
        # after each tree regresses on the raw values of the used
        # features, kept on the device once
        self._linear = bool(tc.linear_tree)
        self._raw = None
        if self._linear:
            self._linear_k = int(tc.tpu_linear_max_features)
            check_linear_features(self._linear_k)
            if train_data.raw is None:
                log.fatal("linear_tree requires raw feature values: "
                          "construct the training Dataset with keep_raw="
                          "true (params routed through engine.train/sklearn "
                          "arm this automatically)")
            self._raw = torch.from_numpy(train_data.raw).to(self.device)
        # boost from average (gbdt.cpp:358-378): the scores move now, and
        # the bias is folded into the first tree that splits (AddBias,
        # gbdt.cpp:446) so the saved model stands alone
        self.init_score_bias = 0.0
        if (objective.boost_from_average()
                and self.config.objective_config.boost_from_average):
            self.init_score_bias = objective.bias()
            if self.init_score_bias != 0.0:
                self._score += self.init_score_bias
                log.info("Start training from score %f", self.init_score_bias)
        self._pending_bias = self.init_score_bias
        # after boost-from-average, so the calibration gradients are the
        # first iteration's (gbdt.py:975-981)
        if quant != "none":
            self._hist_quant_gate()

    def _quantize(self, grad, hess, row_weight, iteration: int, n: int,
                  qmax: int, reciprocal_scale: bool):
        """Q with the JAX package's key chain (gbdt.py:363-405):
        fold_in(fold_in(fold_in(PRNGKey(data_random_seed), iteration),
        class 0), 0 for the gradients | 1 for the hessians), folded on
        the host. A training iteration takes the scales of the JAX
        package's jitted program (`reciprocal_scale`: max * f32(1 /
        qmax)), the gate those of its op-by-op call (max / qmax)."""
        kc = fold_in(fold_in(prng_key(self._quant_seed), iteration), 0)
        return quantize_gradients(
            grad[:n], hess[:n], row_weight[:n], qmax=qmax,
            key_g=fold_in(kc, 0), key_h=fold_in(kc, 1),
            hess_const=self._quant_hess_const,
            reciprocal_scale=reciprocal_scale)

    def _hist_quant_gate(self) -> None:
        """The train-time gate of tpu_hist_quantize (gbdt.py:983-1051):
        one tree of min(31, num_leaves) leaves grown quantized and one in
        f32 on the leading min(n, chunk) rows from the first iteration's
        gradients; refuses the config when the largest per-row leaf-value
        difference, relative to the f32 tree's largest leaf value
        (floored at 1), exceeds tpu_hist_quantize_tol. The delta is kept
        in `quant_gate_delta`, the two trees' leaf counts in
        `quant_gate_leaves`."""
        mode = self._quant_mode
        n_cal = min(self._n, self._chunk)
        grad, hess = self.objective.get_gradients(self._score[0])
        fm, gcfg, num_bins, feature_bins, group_bins = self._grower_args
        cfg = dataclasses.replace(
            gcfg, num_leaves=min(31, self.config.tree.num_leaves))
        qmax = train_qmax(mode, n_cal)
        ones = self._ones[:n_cal]
        q = self._quantize(grad, hess, ones, 0, n_cal, qmax,
                           reciprocal_scale=False)
        binned = self._binned[:n_cal]
        mask = np.ones(self.train_data.num_features, bool)
        values = []
        for chans, qscale, gc in (
                ((q.codes, q.w01), q.qscale,
                 dataclasses.replace(cfg, hist_qmax=qmax)),
                (torch.stack([grad[:n_cal], hess[:n_cal], ones], 1)
                 .contiguous(), None,
                 dataclasses.replace(cfg, hist_quantize="none",
                                     hist_qmax=0))):
            st = SerialGrower(binned, fm, gc, num_bins, feature_bins,
                              group_bins).grow(chans, mask, qscale)
            table = torch.from_numpy(st.leaf_value).to(self.device)
            values.append((table[st.leaf_id.long()], st.leaf_value,
                           st.num_leaves_used))
        (vq, _, used_q), (vf, lv_f, used_f) = values
        self.quant_gate_leaves = (used_q, used_f)
        scale = max(float(np.max(np.abs(lv_f))), 1.0)
        delta = float((vq - vf).abs().max()) / scale
        self.quant_gate_delta = delta
        log.debug("Hist-quantize gate (%s, qmax=%d): relative leaf-value "
                  "delta %.3g on %d calibration rows", mode, qmax, delta,
                  n_cal)
        tol = float(self.config.tree.tpu_hist_quantize_tol)
        if delta > tol:
            raise log.LightGBMError(
                "tpu_hist_quantize=%s refused: max calibration leaf-value "
                "delta %.3g vs the f32 grower exceeds "
                "tpu_hist_quantize_tol=%.3g (relative to the f32 tree's "
                "leaf-value scale, %d calibration rows). Raise the "
                "tolerance or train with tpu_hist_quantize=none."
                % (mode, delta, tol, n_cal))

    def add_valid(self, valid_data, name: str, metric_names=()) -> None:
        """Reference: GBDT::AddValidDataset, gbdt.cpp:204-224
        (lightgbm_tpu/boosting/gbdt.py:1053): the valid set's bins go to
        the device, its scores start at its init score plus the bias,
        and the trees already grown are replayed with W."""
        self.valid_sets.append(valid_data)
        self.valid_names.append(name)
        ms = []
        for mname in metric_names:
            m = create_metric(mname, self.config)
            if m is not None:
                m.init(valid_data.metadata, valid_data.num_data)
                ms.append(m)
        self.valid_metrics.append(ms)
        # W walks wide valid bins column-major on the card (walk_layout)
        vb = walk_layout(self._device_bins(valid_data.binned))
        self._valid_binned.append(vb)
        # linear trees score a valid set from its raw values (inner space,
        # gbdt.py:1074-1085)
        vraw = None
        if getattr(self, "_linear", False) or any(t.is_linear
                                                  for t in self.models):
            if valid_data.raw is None:
                log.fatal("linear_tree validation needs raw feature values: "
                          "construct the valid Dataset with keep_raw=true")
            vraw = torch.from_numpy(valid_data.raw).to(self.device)
        self._valid_raw.append(vraw)
        nv = valid_data.num_data
        vs = torch.zeros(nv, dtype=torch.float32, device=self.device)
        if valid_data.metadata.init_score is not None:
            vs += torch.from_numpy(np.asarray(
                valid_data.metadata.init_score, np.float32)).to(self.device)
        if self.init_score_bias != 0.0:
            vs += self.init_score_bias
        # the trees already grown, replayed into a zero accumulator that
        # is averaged under average_output (RF) and then added once
        # (gbdt.py:1097-1107)
        if self.models:
            acc = torch.zeros(nv, dtype=torch.float32, device=self.device)
            for tree in self.models:
                self._add_tree_values(tree, vb, vraw, acc)
            if self.average_output and self.iter_ > 0:
                acc = acc / torch.tensor(float(self.iter_),
                                         dtype=torch.float32,
                                         device=self.device)
            vs = vs + acc
        self._valid_score.append(vs.reshape(1, nv))

    def _feature_mask(self) -> np.ndarray:
        return feature_fraction_mask(self._feature_rng,
                                     self.config.tree.feature_fraction,
                                     self.train_data.num_features)

    def _bagging_weights(self, iter_idx: int,
                         grad: Optional[torch.Tensor] = None,
                         hess: Optional[torch.Tensor] = None
                         ) -> Optional[torch.Tensor]:
        """The [n] f32 row weight of iteration `iter_idx`, or None when
        every row weighs 1 (lightgbm_tpu/boosting/gbdt.py
        `_bagging_weights`, :1111-1132; GOSS overrides it from the
        gradients): here the 0/1 in-bag mask, per-row Bernoulli(
        bagging_fraction) from JAX's threefry stream keyed by
        fold_in(PRNGKey(bagging_seed), iter // bagging_freq), redrawn when
        iter % bagging_freq == 0 (kernel M); None without bagging."""
        if self._bag is None:
            return None
        bc = self.config.boosting
        if iter_idx % bc.bagging_freq == 0 or not self._bag_drawn:
            bagging_mask(fold_in(prng_key(bc.bagging_seed),
                                 iter_idx // bc.bagging_freq),
                         bc.bagging_fraction, self._bag)
            self._bag_drawn = True
        return self._bag

    def _check_gradients(self, grad, hess) -> None:
        if self.config.boosting.tpu_guard_nonfinite and not bool(
                torch.isfinite(grad).all() & torch.isfinite(hess).all()):
            raise log.LightGBMError(
                "Objective '%s' produced non-finite gradients/hessians at "
                "iteration %d; set tpu_guard_nonfinite=false to disable "
                "this check." % (self.objective.name, self.iter_))

    def _grow_tree(self, grad, hess, weight, mask):
        """One tree from the [n] f32 gradients and hessians, the row
        weight (None: every row weighs 1) and the feature mask: quantized
        (Q, then HQ) or on f32 channels (g*w, h*w, w) (H). Any row of
        weight 0 makes the growth `bagged`. Returns the grower's state
        and the tree (linear leaves fitted, LF and LS, and the train
        scores updated with LA when `linear_tree`; the train scores are
        the caller's otherwise)."""
        if self._quant_mode != "none":
            q = self._quantize(grad, hess,
                               self._ones if weight is None else weight,
                               self.iter_, self._n, self._quant_qmax,
                               reciprocal_scale=True)
            state = self._grower.grow((q.codes, q.w01), mask, q.qscale,
                                      bagged=weight is not None)
        else:
            # (g*w, h*w, w): the all-ones weight of unweighted training,
            # the 0/1 bag mask or GOSS's weights
            w3 = torch.stack([grad, hess, self._ones] if weight is None else
                             [grad * weight, hess * weight, weight],
                             dim=1).contiguous()
            state = self._grower.grow(w3, mask, bagged=weight is not None)
        if self._linear and state.num_leaves_used > 1:
            return state, self._fit_linear(state, grad, hess, weight)
        return state, Tree.from_grower_state(state, self.train_data)

    def train_one_iter(self) -> bool:
        """One boosting iteration (reference: GBDT::TrainOneIter,
        gbdt.cpp:380-474; the synchronous serial branch of
        lightgbm_tpu/boosting/gbdt.py:1191-1357). Returns True when no
        tree could split (training should stop)."""
        grad, hess = self.objective.get_gradients(self._score[0])
        self._check_gradients(grad, hess)
        weight = self._bagging_weights(self.iter_, grad, hess)
        state, tree = self._grow_tree(grad, hess, weight,
                                      self._feature_mask())
        if tree.num_leaves > 1 and not tree.is_linear:
            # the train-score update of gbdt.py:185-190: f32 leaf values
            # gathered by leaf id times the f32 shrinkage, fused
            score_update(self._score[0], state.leaf_id,
                         torch.from_numpy(
                             state.leaf_value[:tree.num_leaves]).to(
                                 self.device), self.shrinkage_rate)
        if tree.num_leaves > 1:
            tree.apply_shrinkage(self.shrinkage_rate)
            self._update_valid_scores(tree)
            # fold boost-from-average into the first tree AFTER the score
            # updates (the scores moved at init): gbdt.cpp:445-447
            if abs(self._pending_bias) > _K_EPSILON:
                tree.add_bias(self._pending_bias)
                self._pending_bias = 0.0
                self.init_score_bias = 0.0
        self.models.append(tree)
        return self._finish_iter(tree.num_leaves > 1)

    def _fit_linear(self, state, grad, hess, weight) -> Tree:
        """The linear leaves of a grown tree (gbdt.py:1269-1301): the fit
        (LF + LS) on the f32 gradients before any quantization and the
        row weight (None: all ones), then the train scores get f32(shrinkage) * (value +
        row_ok * coeff . x) from the unshrunk fit (LA). Returns the tree
        with the fitted tables."""
        dev = self.device
        L = self.config.tree.num_leaves
        feats = leaf_path_features(state.leaf_parent, state.node_feature,
                                   state.node_left, state.node_right,
                                   state.num_leaves_used, self._linear_k)
        feats_dev = torch.from_numpy(feats).to(dev)
        value, coeff, _ = fit_leaves(
            self._raw, grad, hess, self._ones if weight is None else weight,
            None,
            feats_dev, torch.from_numpy(state.leaf_value).to(dev),
            self.config.tree.linear_lambda, L, perm=state.perm,
            leaf_begin=state.leaf_begin, leaf_rows=state.leaf_rows)
        linear_addend(self._raw, state.leaf_id, value, coeff, feats_dev,
                      self._score[0], float(np.float32(self.shrinkage_rate)))
        fitted = dataclasses.replace(state, leaf_value=value.cpu().numpy())
        fitted.leaf_coeff = coeff.cpu().numpy()
        fitted.leaf_features_inner = feats
        return Tree.from_grower_state(fitted, self.train_data)

    @property
    def _walk_binned(self) -> torch.Tensor:
        """The train bins as W walks them (`walk_layout`'s rule): the
        grower's column-major copy, the one R reads, where rows are wide
        on the card; else the matrix itself."""
        return self._grower._route_bins if walk_by_columns(self._binned) \
            else self._binned

    def _add_tree_values(self, tree: Tree, binned: torch.Tensor,
                         raw: Optional[torch.Tensor], score: torch.Tensor,
                         sign: float = 1.0) -> None:
        """score += sign * the tree's values on a binned matrix: W adds a
        constant tree's leaf values (sign times them in f64, then rounded
        to f32, as DART's rescaled copies are); a linear tree's leaves
        come from W's leaf mode and LA adds value + row_ok * coeff . x
        from the raw matrix (gbdt.py:1563-1581). sign -1 rolls the tree
        back."""
        if not tree.is_linear:
            values = tree.leaf_value * sign
            tree_value_walk_binned(binned_tree(tree, self.device, values),
                                   binned, score)
            return
        if raw is None:
            log.fatal("linear_tree score replay needs raw feature values "
                      "for this dataset: construct it with keep_raw=true")
        dev = self.device
        leaf = tree_leaf_walk_binned(binned_tree(tree, dev), binned)
        linear_addend(
            raw, leaf,
            torch.from_numpy(tree.leaf_value.astype(np.float32)).to(dev),
            torch.from_numpy(tree.leaf_coeff.astype(np.float32)).to(dev),
            torch.from_numpy(tree.leaf_features_inner).to(dev), score, sign)

    def _update_valid_scores(self, tree: Tree) -> None:
        for vi, vb in enumerate(self._valid_binned):
            self._add_tree_values(tree, vb, self._valid_raw[vi],
                                  self._valid_score[vi][0])

    def _finish_iter(self, could_split: bool) -> bool:
        """Advance the iteration, or roll it back when no tree could
        split (gbdt.cpp:466-472)."""
        self._bump_model_version()
        self.iter_ += 1
        if not could_split:
            self.models.pop()
            self.iter_ -= 1
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        return False

    def rollback_one_iter(self) -> None:
        """Reference: GBDT::RollbackOneIter, gbdt.cpp:476-492: the last
        tree's values come off every score (W with negated values; for a
        linear tree LA with sign -1 on its values and coefficients,
        gbdt.py:1645-1660)."""
        if self.iter_ <= 0:
            return
        tree = self.models.pop()
        if tree.num_leaves > 1:
            self._add_tree_values(tree, self._walk_binned, self._raw,
                                  self._score[0], -1.0)
            for vi, vb in enumerate(self._valid_binned):
                self._add_tree_values(tree, vb, self._valid_raw[vi],
                                      self._valid_score[vi][0], -1.0)
        self.iter_ -= 1
        self._bump_model_version()

    def eval_once(self):
        """All metrics as (data_name, metric_name, value,
        is_bigger_better) (reference: GBDT::OutputMetric,
        gbdt.cpp:575-632)."""
        out = []
        if self.metrics and self.config.metric.is_provide_training_metric:
            score = self._train_score_unpadded()
            for m in self.metrics:
                for name, val in m.eval(score, self.objective):
                    out.append(("training", name, val, m.is_bigger_better))
        for vi, ms in enumerate(self.valid_metrics):
            score = self.valid_score(vi)
            for m in ms:
                for name, val in m.eval(score, self.objective):
                    out.append((self.valid_names[vi], name, val,
                                 m.is_bigger_better))
        return out

    def valid_score(self, i: int) -> np.ndarray:
        return self._valid_score[i].cpu().numpy().astype(np.float64).ravel()

    def _train_score_unpadded(self) -> np.ndarray:
        return self._score.cpu().numpy().astype(np.float64).ravel()

    def current_iteration(self) -> int:
        return self.iter_

    def finalize_training(self) -> None:
        """Nothing is pending: the port trains synchronously."""

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

    def _check_supported(self, pred_contrib: bool) -> None:
        """Refuse what the port does not carry, worded as the JAX package
        words it: multiclass models, and pred_contrib of a linear forest
        (quantized layouts of a linear forest are refused where they are
        stacked, `_predict_raw_matrix`)."""
        if self.num_tree_per_iteration > 1:
            log.fatal("multiclass models (num_tree_per_iteration=%d) are "
                      "not ported to lightgbm_tpu_torch yet"
                      % self.num_tree_per_iteration)
        if pred_contrib and any(t.is_linear for t in self.models):
            log.fatal("predict_contrib does not support linear_tree models: "
                      "the TreeSHAP recursion attributes constant leaf "
                      "outputs only and would silently drop the per-leaf "
                      "linear terms; use predict() or retrain with "
                      "linear_tree=false")

    def _chunks(self, data: np.ndarray, walk, out: np.ndarray) -> np.ndarray:
        """Run `walk(rows_on_device)` over row chunks of `data` into the
        host array `out` (each copy to the host waits for its launch)."""
        c = self._predict_chunk_rows()
        for i in range(0, data.shape[0], c):
            rows = torch.from_numpy(data[i:i + c]).to(self.device)
            out[i:i + c] = walk(rows).cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # quantized serving layouts (tpu_predict_quantize,
    # lightgbm_tpu/boosting/gbdt.py:1740-1824)

    # calibration rows of the accuracy gate
    _QUANT_CALIB_ROWS = 256

    def _quantize_mode(self) -> str:
        mode = str(self.config.io.tpu_predict_quantize or "none").lower()
        if mode not in QUANTIZE_MODES:  # config validates; double belt
            raise log.LightGBMError(
                "tpu_predict_quantize must be one of %s (got %r)"
                % (QUANTIZE_MODES, mode))
        return mode

    @staticmethod
    def _value_walker(mode: str, stack, transform=None):
        """The value walk of a layout: K1 (f32), K1's f16 mode, or QC then
        QW (int8), each with the fused f32 epilogue when `transform`."""
        if mode == "f16":
            return lambda x: forest_value_walk_f16(stack, x, transform)
        if mode == "int8":
            return lambda x: forest_quant_walk(stack, quant_codes(stack, x),
                                               x, transform)
        return lambda x: forest_value_walk(stack, x, transform)

    def _quant_gate(self, cache: CompiledForest, mode: str, total: int,
                    q_stack, data: np.ndarray) -> None:
        """The build-time accuracy gate: on the first predict of a
        quantized layout, its raw scores and the f32 stack's on the
        leading _QUANT_CALIB_ROWS rows of the call; the worst difference,
        relative to the f32 scores' largest magnitude floored at 1, is
        kept per (layout, model version), and a layout past
        tpu_predict_quantize_tol is refused. A later call re-judges the
        kept delta against the tolerance it finds. While
        Predictor.warmup runs (`_quant_gate_defer`) nothing is measured:
        its all-zero rows would make a useless calibration."""
        key = ("value", total, 1, mode)
        delta = cache.gate_delta(key)
        if delta is None and self._quant_gate_defer:
            return
        if delta is None:
            n_cal = min(data.shape[0], self._QUANT_CALIB_ROWS)
            calib = torch.from_numpy(np.ascontiguousarray(
                data[:n_cal], np.float32)).to(self.device)
            f32 = cache.value_stacks(self.models, total)
            fr = self._value_walker("none", f32)(calib).cpu().numpy()
            qr = self._value_walker(mode, q_stack)(calib).cpu().numpy()
            fr, qr = fr.astype(np.float64), qr.astype(np.float64)
            delta = float(np.max(np.abs(fr - qr))) if n_cal else 0.0
            scale = max(1.0, float(np.max(np.abs(fr))) if n_cal else 1.0)
            delta = delta / scale
            cache.record_gate(key, delta)
            log.debug("Quantize gate (%s, %d trees): relative raw-score "
                      "delta %.3g on %d calibration rows", mode, total,
                      delta, n_cal)
        tol = float(self.config.io.tpu_predict_quantize_tol)
        if delta > tol:
            raise log.LightGBMError(
                "tpu_predict_quantize=%s refused: max raw-score delta "
                "%.3g vs the f32 stack exceeds tpu_predict_quantize_tol"
                "=%.3g (relative to the calibration batch's score "
                "scale). Raise the tolerance or serve with "
                "tpu_predict_quantize=none." % (mode, delta, tol))

    def _predict_raw_matrix(self, data: np.ndarray, num_iteration: int = -1,
                            pred_early_stop: bool = False,
                            pred_early_stop_freq: int = 10,
                            pred_early_stop_margin: float = 10.0,
                            transform: Optional[OutputTransform] = None
                            ) -> np.ndarray:
        """[num_data] raw scores of the single-class model (or, with
        `transform`, the converted output computed in the kernel's
        epilogue). Without a transform the f32 raws are averaged and
        biased on the host in f64, as the JAX package does. Early stop
        (ES) runs for a binary objective only (predictor.hpp:34-60) and
        keeps the f32 layout; otherwise tpu_predict_quantize picks the
        layout, behind the accuracy gate."""
        data = np.ascontiguousarray(data, np.float32)
        n = data.shape[0]
        k = self.num_tree_per_iteration
        total = self._capped_total(num_iteration)
        out = np.zeros(n, np.float64)
        use_es = (pred_early_stop and total > 0
                  and (k > 1 or (self.objective is not None
                                 and self.objective.name == "binary")))
        mode = self._quantize_mode() if not use_es else "none"
        cache = self._forest_cache()
        walk = None
        if use_es:
            forest = cache.early_stop_stacks(self.models, k, total // k)
            margin = float(pred_early_stop_margin)
            freq = int(pred_early_stop_freq)
            walk = lambda x: forest_early_stop_walk(  # noqa: E731
                forest, x, margin, freq)[0]
        elif total > 0:
            try:
                stack = cache.value_stacks(self.models, total, quantize=mode)
            except QuantRefused as exc:
                raise log.LightGBMError(
                    "tpu_predict_quantize=%s refused for this model: %s"
                    % (mode, exc)) from exc
            if mode != "none" and n > 0:
                self._quant_gate(cache, mode, total, stack, data)
            walk = self._value_walker(mode, stack, transform)
        if walk is not None and n > 0:
            self._chunks(data, walk, out)
        if transform is None:
            if self.average_output and total > 0:
                out /= max(total // k, 1)
            out += self.init_score_bias
        return out

    def predict(self, data: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False,
                pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0) -> np.ndarray:
        self._check_supported(pred_contrib)
        total = self._capped_total(num_iteration)
        if pred_leaf:
            data = np.ascontiguousarray(data, np.float32)
            if total == 0 or data.shape[0] == 0:
                return np.zeros((data.shape[0], total), np.int32)
            forest = self._forest_cache().value_stacks(self.models, total)
            return self._chunks(data, lambda x: forest_leaf_walk(forest, x),
                                np.zeros((data.shape[0], total), np.int32))
        if pred_contrib:
            from ..shap import predict_contrib
            return predict_contrib(self, np.asarray(data, np.float64),
                                   num_iteration)
        if (not raw_score and self.objective is not None and total > 0
                and not pred_early_stop):
            # single-class fast path: averaging, bias and the output
            # transform run in the kernel's epilogue (f32) before the copy
            obj = self.objective
            tr = OutputTransform(
                obj.OUTPUT_KIND,
                denom=float(max(total, 1)) if self.average_output else 1.0,
                bias=float(self.init_score_bias), sigmoid=float(obj.sigmoid))
            return self._predict_raw_matrix(data, num_iteration,
                                            transform=tr)
        raw = self._predict_raw_matrix(
            data, num_iteration, pred_early_stop=pred_early_stop,
            pred_early_stop_freq=pred_early_stop_freq,
            pred_early_stop_margin=pred_early_stop_margin)
        if raw_score or self.objective is None:
            return raw
        conv = self.objective.convert_output(
            torch.from_numpy(raw.astype(np.float32)))
        return conv.numpy().astype(np.float64)

    def dump_model(self, num_iteration: int = -1) -> dict:
        """The model as JSON (lightgbm_tpu/boosting/gbdt.py:2293)."""
        total = self._capped_total(num_iteration)
        return {
            "name": "tree",
            "version": "v2_tpu",
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": 0,
            "max_feature_idx": self.max_feature_idx,
            "feature_names": self.feature_names,
            "tree_info": [t.to_json() for t in self.models[:total]],
        }

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
