"""lightgbm_tpu_torch imports nothing of JAX or of the JAX package.

A child process with `jax` and `lightgbm_tpu` import-blocked (the
meta-path blocker pattern of tests/test_export.py) loads model text and
predicts on the CPU, trains a small model through every training
module (dataset, ingest, binning, EFB, objectives, metrics, callbacks,
the grower and kernels H, S, R and W in their plain versions), and a
small ranker through the ranking modules (query groups, NDCG and MAP,
kernel L's plain version, the scikit-learn wrappers), and a small
linear-tree model through the linear modules (kernels LF, LS, LA and
LM's plain versions, rollback), and walks the serving extras and the
model API (early stop, the f16 and int8 layouts with kernels ES, QC,
QW and K1's f16 mode in their plain versions, TreeSHAP contributions,
the JSON dump, a data file through `io.parser`, continued training
from `init_model`), and trains GOSS (kernels GT and GW), DART and RF
(R's average mode) models with H's hi+lo mode in their plain versions,
and a model from a data file through the streamed build, the binary
cache and the durable writer;
an AST scan finds no such import in the package or in chip_smoke.py.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent

_CHILD = textwrap.dedent("""
    import json, sys

    def blocked(name):
        return (name == "jax" or name.startswith("jax.")
                or name == "jaxlib" or name.startswith("jaxlib.")
                or name == "lightgbm_tpu" or name.startswith("lightgbm_tpu."))

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Blocker())
    import numpy as np
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.testing.synth import (synthetic_forest_text,
                                                  synthetic_rows)
    text = synthetic_forest_text(0, 5, 15, 6, cat_features=1)
    booster = lgb.Booster(model_str=text, device="cpu")
    rows = synthetic_rows(1, 16, 6, 1)
    pred = booster.predict(rows)
    leaf = booster.predict(rows, pred_leaf=True)
    rng = np.random.RandomState(0)
    x = rng.randn(400, 5)
    x[rng.rand(400) < 0.2, 1] = np.nan
    y = (x[:, 0] + np.nan_to_num(x[:, 1]) > 0).astype(float)
    train = lgb.Dataset(x[:300], y[:300])
    valid = train.create_valid(x[300:], y[300:])
    evals = {}
    trained = lgb.train({"objective": "binary", "num_leaves": 7,
                         "max_bin": 31, "metric": "auc", "verbose": -1},
                        train, 3, valid_sets=[valid], evals_result=evals,
                        early_stopping_rounds=2, verbose_eval=False,
                        device="cpu")
    xr = rng.randn(600, 5)
    yr = np.clip(np.rint(xr[:, 0] + 1.5), 0, 4)
    ranked = lgb.Dataset(xr[:400], yr[:400], group=[50] * 8)
    rank_evals = {}
    ranker = lgb.train({"objective": "lambdarank", "metric": "ndcg,map",
                        "ndcg_eval_at": [5], "num_leaves": 7,
                        "verbose": -1}, ranked, 3,
                       valid_sets=[ranked.create_valid(
                           xr[400:], yr[400:], group=[100, 100])],
                       evals_result=rank_evals, verbose_eval=False,
                       device="cpu")
    served = lgb.Booster(model_str=ranker.model_to_string(), device="cpu")
    sk = lgb.LGBMRanker(n_estimators=2, num_leaves=7, device="cpu").fit(
        xr[:400], yr[:400], group=[50] * 8)
    from lightgbm_tpu_torch.convert import dataset_from_numpy
    linear = lgb.train({"objective": "regression", "num_leaves": 7,
                        "linear_tree": True, "linear_lambda": 0.01,
                        "tpu_hist_quantize": "int8", "verbose": -1},
                       lgb.Dataset(x[:300], x[:300, 0]), 3,
                       valid_sets=[lgb.Dataset(x[:300], x[:300, 0]).
                                   create_valid(x[300:], x[300:, 0])],
                       verbose_eval=False, device="cpu")
    linear.rollback_one_iter()
    import torch
    from lightgbm_tpu_torch.linear import leaf_feature_moments
    moments = leaf_feature_moments(
        torch.zeros((8, 2), dtype=torch.uint8), torch.ones(8, 2),
        torch.ones(8, 3), torch.zeros(8, dtype=torch.int32), [0], 4)
    import os, tempfile
    extras = {
        "early_stop": booster.predict(rows, pred_early_stop=True,
                                      pred_early_stop_freq=2,
                                      pred_early_stop_margin=1.0).shape,
        "contrib": booster.predict(rows, pred_contrib=True).shape,
        "dump": len(booster.dump_model()["tree_info"])}
    for mode in ("f16", "int8"):
        q = lgb.Booster(model_str=text, device="cpu",
                        params={"tpu_predict_quantize": mode,
                                "tpu_predict_quantize_tol": 1.0})
        extras[mode] = bool(np.isfinite(q.predict(rows)).all())
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "rows.tsv")
    np.savetxt(path, np.column_stack([np.zeros(16), rows]), delimiter="\t")
    extras["file"] = bool(np.array_equal(booster.predict(path),
                                         booster.predict(rows)))
    model_path = os.path.join(tmp, "model.txt")
    trained.save_model(model_path)
    extras["continued"] = lgb.train(
        {"objective": "binary", "num_leaves": 7, "max_bin": 31,
         "verbose": -1}, lgb.Dataset(x[:300], y[:300]), 2,
        init_model=model_path, verbose_eval=False,
        device="cpu").num_trees()
    fpath = os.path.join(tmp, "train.tsv")
    np.savetxt(fpath, np.column_stack([y[:300], x[:300]]), delimiter="\t")
    fds = lgb.Dataset(fpath, params={"tpu_ingest_chunk_rows": 64})
    cache = os.path.join(tmp, "train.bin")
    fds.save_binary(cache)
    from lightgbm_tpu_torch.dataset import Dataset as Inner
    cached = lgb.Dataset._from_inner(Inner.load_binary(cache))
    files = [lgb.train({"objective": "binary", "num_leaves": 7,
                        "verbose": -1}, cached, 2, verbose_eval=False,
                       device="cpu").num_trees(),
             bool(np.array_equal(cached._inner.binned,
                                 fds._inner.binned))]
    modes = []
    for extra in ({"boosting": "goss", "learning_rate": 0.5},
                  {"boosting": "dart"},
                  {"boosting": "rf", "bagging_fraction": 0.5,
                   "bagging_freq": 1, "feature_fraction": 0.6}):
        modes.append(lgb.train(
            dict({"objective": "binary", "num_leaves": 7, "max_bin": 31,
                  "verbose": -1}, **extra), lgb.Dataset(x[:300], y[:300]),
            4, verbose_eval=False, device="cpu").num_trees())
    modules = ["lightgbm_tpu_torch." + m for m in (
        "engine", "callback", "metrics", "dataset", "efb", "binning",
        "ingest.build", "learner.grow", "ops.histogram", "ops.split",
        "ops.route", "ops.rank", "ops.linear", "linear.solver",
        "linear.stats", "objectives", "sklearn", "convert", "shap",
        "io.parser", "ops.goss", "boosting.goss", "boosting.dart",
        "boosting.rf", "ingest.sources", "ingest.cache", "durable")]
    print(json.dumps({"pred": [float(v) for v in pred],
                      "leaf_shape": list(leaf.shape),
                      "round_trip": booster.model_to_string() == text,
                      "trained": trained.num_trees(),
                      "auc": evals["valid_0"]["auc"],
                      "ndcg": rank_evals["valid_0"]["ndcg@5"],
                      "map": rank_evals["valid_0"]["map@5"],
                      "served": bool(np.array_equal(
                          served.predict(xr[400:]),
                          ranker.predict(xr[400:]))),
                      "sk_trees": sk.booster_.num_trees(),
                      "linear": [linear.num_trees(),
                                 all(t.is_linear
                                     for t in linear._inner.models),
                                 bool(np.isfinite(linear.predict(x)).all()),
                                 float(moments[0, 0, 0])],
                      "extras": [list(extras["early_stop"]),
                                 list(extras["contrib"]), extras["dump"],
                                 extras["f16"], extras["int8"],
                                 extras["file"], extras["continued"]],
                      "modes": modes, "files": files,
                      "modules": all(m in sys.modules for m in modules),
                      "loaded": sorted(m for m in sys.modules if blocked(m))}))
""")


def test_port_runs_with_jax_and_the_jax_package_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["round_trip"] and out["leaf_shape"] == [16, 5]
    assert all(0.0 < p < 1.0 for p in out["pred"])
    assert out["trained"] == 3 and out["modules"]
    assert len(out["auc"]) == 3 and out["auc"][-1] > 0.8
    assert len(out["ndcg"]) == len(out["map"]) == 3
    assert out["ndcg"][-1] > 0.5 and out["served"] and out["sk_trees"] == 2
    assert out["linear"] == [2, True, True, 8.0]
    assert out["extras"] == [[16], [16, 7], 5, True, True, True,
                             out["trained"] + 2]
    assert out["modes"] == [4, 4, 4]
    assert out["files"] == [2, True]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    files = sorted((REPO / "lightgbm_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"lightgbm_tpu_torch/ingest/sources.py",
            "lightgbm_tpu_torch/ingest/cache.py",
            "lightgbm_tpu_torch/durable.py"} <= names
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu")]
    assert bad == []
