"""train(): the training entry point.

The port's copy of `lightgbm_tpu/engine.py` `train` (:26-220; reference
python-package engine.py:18-230) with its callback protocol (before and
after each iteration) and the EarlyStopException unwinding. It takes
`valid_sets`, `valid_names`, `early_stopping_rounds`, `evals_result`,
`verbose_eval`, `learning_rates`, `callbacks` and continued training
from `init_model` (a model file or a Booster, `_continue_from`); custom
objectives and metrics (`fobj`, `feval`) are refused by name, and
checkpointing, `cv` and `train_sweep` wait for a later slice (the
scikit-learn estimators over `train` are in `sklearn.py`). `device`
picks the card (None: CUDA) or the plain CPU versions ("cpu").
"""
from __future__ import annotations

import collections
import copy
from typing import Any, Dict, List, Optional, Union

import torch

from . import callback as callback_mod
from .basic import Booster, Dataset, LightGBMError
from .config import key_alias_transform
from .ops.predict import binned_tree, tree_value_walk_binned

# XLA's CPU backend sums a [T, N] array over T in order for T <= 32 and
# splits a longer one into two halves of ceil(T / 2) and T - ceil(T / 2)
# first (probed bitwise for T <= 64; past 64 its order is another)
_XLA_SEQUENTIAL_SUM = 32


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          fobj=None, feval=None, init_model=None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None, verbose_eval=True,
          learning_rates=None, callbacks: Optional[List] = None,
          device: Optional[Union[str, torch.device]] = None) -> Booster:
    """Train one model (lightgbm_tpu/engine.py:26)."""
    if fobj is not None or feval is not None:
        raise LightGBMError("custom objectives and metrics (fobj, feval) "
                            "are not ported to lightgbm_tpu_torch yet")
    params = key_alias_transform(dict(params))
    num_boost_round = int(params.pop("num_iterations", num_boost_round))
    if "early_stopping_round" in params:
        early_stopping_rounds = int(params.pop("early_stopping_round"))
    valid_sets = valid_sets or []
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    valid_sets = list(valid_sets)
    train_set._update_params(params)
    for vs in valid_sets:
        vs._update_params(params)

    booster = Booster(params=params, train_set=train_set, device=device)
    if init_model is not None:
        init_booster = init_model if isinstance(init_model, Booster) \
            else Booster(model_file=init_model, params=params,
                         device=booster.device)
        # continued training: the loaded trees, their replayed scores
        _continue_from(booster, init_booster)
    valid_names = valid_names or [f"valid_{i}"
                                  for i in range(len(valid_sets))]
    is_valid_contain_train = False
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            is_valid_contain_train = True
            booster.set_train_data_name(valid_names[i])
            continue
        booster.add_valid(vs, valid_names[i])
    if is_valid_contain_train:
        booster._inner.config.metric.is_provide_training_metric = True

    callbacks = list(callbacks or [])
    if verbose_eval is True:
        callbacks.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval:
        callbacks.append(callback_mod.print_evaluation(int(verbose_eval)))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.append(callback_mod.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if learning_rates is not None:
        callbacks.append(callback_mod.reset_parameter(
            learning_rate=learning_rates))
    if evals_result is not None:
        callbacks.append(callback_mod.record_evaluation(evals_result))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))

    for i in range(num_boost_round):
        for cb in before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        if booster.update():
            break
        results = []
        if is_valid_contain_train:
            results.extend(booster.eval_train())
        if valid_sets:
            results.extend(booster.eval_valid())
        try:
            for cb in after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=results))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for data_name, eval_name, score, _ in e.best_score:
                booster.best_score.setdefault(
                    data_name, collections.OrderedDict())
                booster.best_score[data_name][eval_name] = score
            break
    return booster


def _replay_sum(gbdt, trees, score: torch.Tensor) -> None:
    """score += the trees' summed values on the training bins, summed
    as XLA sums the JAX package's [T, N] replay (`predict_forest_binned`:
    vals.sum(axis=0)): each block of up to _XLA_SEQUENTIAL_SUM trees
    walked by W into a zero buffer in tree order, blocks combined by
    halves, then one add."""
    def total(block):
        if len(block) > _XLA_SEQUENTIAL_SUM:
            half = -(-len(block) // 2)
            return total(block[:half]) + total(block[half:])
        buf = torch.zeros_like(score)
        for t in block:
            tree_value_walk_binned(binned_tree(t, gbdt.device), gbdt._binned,
                                   buf)
        return buf
    score += total(trees)


def _continue_from(booster: Booster, init_booster: Booster) -> None:
    """Seed a new booster's state from a loaded model
    (lightgbm_tpu/engine.py:484-555; reference boosting.cpp:29-62): the
    loaded trees, iteration, best iteration and score (the port's GBDT
    keeps no eval history of its own: the callbacks do); the fresh
    booster's own boost-from-average undone, since the loaded trees
    carry it; bin metadata re-attached from the training Dataset; then
    the train score replayed per class: constant trees summed by W as
    the JAX package sums them (`_replay_sum`), linear trees one at a time
    through W's leaf mode and LA on the raw values."""
    inner = booster._inner
    init_inner = init_booster._inner
    inner.models = copy.deepcopy(init_inner.models)
    inner.iter_ = init_inner.iter_
    inner._bump_model_version()
    if getattr(init_booster, "best_iteration", -1) > 0:
        booster.best_iteration = init_booster.best_iteration
        booster.best_score = copy.deepcopy(init_booster.best_score)
    if inner.init_score_bias != 0.0:
        inner._score -= inner.init_score_bias
    inner.init_score_bias = init_inner.init_score_bias
    inner._pending_bias = 0.0
    same_data = init_inner.train_data is inner.train_data
    for tree in inner.models:
        if tree.num_leaves > 1 and (not tree.has_bin_metadata
                                    or not same_data):
            tree.attach_bin_metadata(inner.train_data)
    inner._score += init_inner.init_score_bias
    k = inner.num_tree_per_iteration
    for cls in range(k):
        class_trees = [t for i, t in enumerate(inner.models)
                       if i % k == cls and t.num_leaves > 1]
        if not class_trees:
            continue
        if any(t.is_linear for t in class_trees):
            if inner._raw is None:
                raise LightGBMError(
                    "Continued training from a linear_tree init_model "
                    "requires linear_tree=true in the continuing params "
                    "(the score replay needs the raw feature matrix)")
            for t in class_trees:
                inner._add_tree_values(t, inner._binned, inner._raw,
                                       inner._score[cls])
        else:
            _replay_sum(inner, class_trees, inner._score[cls])
