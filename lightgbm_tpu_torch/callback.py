"""Training callbacks (the port's copy of `lightgbm_tpu/callback.py`
without the checkpoint protocol, which arrives with checkpointing).

Mirrors the reference python-package callback protocol: callbacks get a
CallbackEnv before or after each iteration, and `EarlyStopException`
unwinds the training loop.
"""
from __future__ import annotations

import collections
from typing import Callable, List

from . import log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value) -> str:
    return f"{value[0]}'s {value[1]}: {value[2]:g}"


def print_evaluation(period: int = 1) -> Callable:
    """Reference: callback.py print_evaluation."""
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            log.info("[%d]\t%s", env.iteration + 1, "\t".join(
                _format_eval_result(x) for x in env.evaluation_result_list))
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: dict) -> Callable:
    """Reference: callback.py record_evaluation."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dict")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for data_name, eval_name, result, _ in env.evaluation_result_list:
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Reference: callback.py reset_parameter; this slice carries the
    learning_rate schedule (a list or a callable of the iteration)."""
    unknown = set(kwargs) - {"learning_rate"}
    if unknown:
        log.fatal("reset_parameter of %s is not ported to "
                  "lightgbm_tpu_torch yet" % ", ".join(sorted(unknown)))

    def _callback(env: CallbackEnv) -> None:
        value = kwargs["learning_rate"]
        i = env.iteration - env.begin_iteration
        if isinstance(value, list):
            if len(value) != env.end_iteration - env.begin_iteration:
                raise ValueError("Length of list learning_rate has to "
                                 "equal num_boost_round")
            rate = value[i]
        else:
            rate = value(i)
        env.model._inner.shrinkage_rate = float(rate)
        env.params["learning_rate"] = rate
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, verbose: bool = True) -> Callable:
    """Reference: callback.py early_stopping."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []

    def _init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        for _, _, _, is_higher_better in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if is_higher_better:
                best_score.append(float("-inf"))
                cmp_op.append(lambda a, b: a > b)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda a, b: a < b)

    def _callback(env: CallbackEnv) -> None:
        if not cmp_op:
            _init(env)
        for i, (_, _, score, _) in enumerate(env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info("Early stopping, best iteration is: [%d]",
                             best_iter[i] + 1)
                raise EarlyStopException(best_iter[i], best_score_list[i])
    _callback.order = 30
    return _callback
