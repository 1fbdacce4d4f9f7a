"""lightgbm_tpu_torch's scikit-learn wrappers.

LGBMRegressor, LGBMClassifier (binary) and LGBMRanker must write the
model text that `train` writes with the params they stand for; the
estimators round-trip through get_params / set_params / clone; a
ranking eval_set needs its eval_group; what the port does not carry
raises by name; and the wrappers import and fit in a child process in
which scikit-learn cannot be imported (the card's machine has none).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from sklearn.base import clone

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import LightGBMError

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent

rng = np.random.RandomState(7)
X = rng.randn(900, 6)
F = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.4 * rng.randn(900)
SIZES = [90] * 10
XV, FV = X[:300] + 0.1 * rng.randn(300, 6), F[:300]
KW = {"n_estimators": 4, "num_leaves": 7, "learning_rate": 0.2,
      "min_child_samples": 5, "max_bin": 31, "device": "cpu"}
# the train() params the estimator arguments above stand for
TRAIN = {"num_leaves": 7, "learning_rate": 0.2, "min_data_in_leaf": 5,
         "min_sum_hessian_in_leaf": 1e-3, "max_bin": 31, "verbose": -1}


def rank_labels(f):
    return np.clip(np.rint(f + 1.5), 0, 4)


CASES = {
    "regressor": (tlgb.LGBMRegressor, "regression", F, {}),
    "classifier": (tlgb.LGBMClassifier, "binary", (F > 0).astype(int), {}),
    "ranker": (tlgb.LGBMRanker, "lambdarank", rank_labels(F),
               {"group": SIZES}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_estimators_write_the_model_text_of_train(name):
    cls, objective, y, fit_kw = CASES[name]
    est = cls(**KW).fit(X, y, **fit_kw)
    ds = tlgb.Dataset(X, y, group=fit_kw.get("group"),
                      params=dict(TRAIN, objective=objective))
    ref = tlgb.train(dict(TRAIN, objective=objective), ds, 4,
                     verbose_eval=False, device="cpu")
    assert est.booster_.model_to_string() == ref.model_to_string()
    pred = est.predict(X[:50])
    if name == "classifier":
        assert set(np.unique(pred)) <= {0, 1}
        proba = est.predict_proba(X[:50])
        assert proba.shape == (50, 2)
        assert np.allclose(proba[:, 1], ref.predict(X[:50]))
        assert est.n_classes_ == 2 and list(est.classes_) == [0, 1]
    else:
        assert np.array_equal(pred, ref.predict(X[:50]))
    assert est.n_features_ == 6
    assert est.feature_importances_.shape == (6,)


def test_ranker_eval_set_early_stopping_and_eval_at():
    y, yv = rank_labels(F), rank_labels(FV)
    est = tlgb.LGBMRanker(**dict(KW, n_estimators=30)).fit(
        X, y, group=SIZES, eval_set=[(XV, yv)], eval_group=[[30] * 10],
        eval_at=[2, 5], early_stopping_rounds=3)
    assert list(est.evals_result_["valid_0"]) == ["ndcg@2", "ndcg@5"]
    assert 0 < est.best_iteration_ < 30
    assert "ndcg_eval_at" not in est.get_params()
    with pytest.raises(LightGBMError, match="eval_group"):
        tlgb.LGBMRanker(**KW).fit(X, y, group=SIZES, eval_set=[(XV, yv)])
    with pytest.raises(LightGBMError, match="eval_group"):
        tlgb.LGBMRanker(**KW).fit(X, y, group=SIZES,
                                  eval_set=[(XV, yv), (XV, yv)],
                                  eval_group=[[30] * 10])


def test_get_set_params_and_clone():
    est = tlgb.LGBMRanker(num_leaves=9, device="cpu", lambdarank_truncation=5)
    params = est.get_params()
    assert params["num_leaves"] == 9 and params["device"] == "cpu"
    assert params["lambdarank_truncation"] == 5
    est.set_params(num_leaves=11, min_data_per_group=3)
    assert est.num_leaves == 11
    assert est.get_params()["min_data_per_group"] == 3
    twin = clone(est)
    assert type(twin) is tlgb.LGBMRanker
    assert twin.get_params() == est.get_params()


@pytest.mark.parametrize("what", ["multiclass", "objective", "eval_metric",
                                  "ranker_group"])
def test_what_the_port_does_not_carry_raises_by_name(what):
    words = {"multiclass": "multiclass", "objective": "callable objective",
             "eval_metric": "callable eval_metric",
             "ranker_group": "group"}
    with pytest.raises(LightGBMError, match=words[what]):
        if what == "multiclass":
            tlgb.LGBMClassifier(**KW).fit(X, np.arange(900) % 3)
        elif what == "objective":
            tlgb.LGBMRegressor(objective=lambda y, p: (p - y, p * 0 + 1),
                               **KW).fit(X, F)
        elif what == "eval_metric":
            tlgb.LGBMRegressor(**KW).fit(
                X, F, eval_set=[(XV, FV)],
                eval_metric=lambda y, p: ("m", 0.0, False))
        else:
            tlgb.LGBMRanker(**KW).fit(X, rank_labels(F))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(LightGBMError, match="device='cpu'"):
        tlgb.LGBMRanker(n_estimators=2).fit(X, rank_labels(F), group=SIZES)


_CHILD = textwrap.dedent("""
    import json, sys

    def blocked(name):
        return name == "sklearn" or name.startswith("sklearn.")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Blocker())
    import numpy as np
    import lightgbm_tpu_torch as lgb
    rng = np.random.RandomState(0)
    x = rng.randn(400, 4)
    y = np.clip(np.rint(x[:, 0] + 1.5), 0, 4)
    est = lgb.LGBMRanker(n_estimators=3, num_leaves=5, device="cpu")
    est.fit(x, y, group=[40] * 10, eval_set=[(x, y)], eval_group=[[40] * 10],
            eval_at=[3])
    cls = lgb.LGBMClassifier(n_estimators=2, num_leaves=5, device="cpu")
    cls.fit(x, (y > 1).astype(int))
    print(json.dumps({
        "trees": est.booster_.num_trees(),
        "ndcg": est.evals_result_["valid_0"]["ndcg@3"],
        "proba": cls.predict_proba(x[:3]).shape[1],
        "base": [c.__module__ for c in type(est).__mro__],
        "loaded": sorted(m for m in sys.modules if blocked(m))}))
""")


def test_wrappers_work_without_scikit_learn():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [] and out["trees"] == 3 and out["proba"] == 2
    assert len(out["ndcg"]) == 3
    assert not any(m.startswith("sklearn") for m in out["base"])
