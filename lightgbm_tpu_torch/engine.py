"""train(): the training entry point.

The port's copy of `lightgbm_tpu/engine.py` `train` (:26-220; reference
python-package engine.py:18-230) with its callback protocol (before and
after each iteration) and the EarlyStopException unwinding. It takes
`valid_sets`, `valid_names`, `early_stopping_rounds`, `evals_result`,
`verbose_eval`, `learning_rates` and `callbacks`; custom objectives and
metrics (`fobj`, `feval`) and continued training (`init_model`) are
refused by name, and checkpointing, `cv` and `train_sweep` wait for a
later slice (the scikit-learn estimators over `train` are in
`sklearn.py`). `device` picks the card (None: CUDA) or
the plain CPU versions ("cpu").
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Union

import torch

from . import callback as callback_mod
from .basic import Booster, Dataset, LightGBMError
from .config import key_alias_transform


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
    if init_model is not None:
        raise LightGBMError("continued training (init_model) is not ported "
                            "to lightgbm_tpu_torch yet")
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
