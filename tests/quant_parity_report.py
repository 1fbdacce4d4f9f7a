"""Report how far lightgbm_tpu_torch's quantized and bagged trees stay
from the JAX package's, run by run, on the fixture of
tests/test_torch_quant_train.py (CPU, a few minutes):

    JAX_PLATFORMS=cpu python tests/quant_parity_report.py

For each run of that file's RUNS: the largest leaf difference of every
tree relative to max(1, |ref|) (a trailing * marks a tree whose
structure differs), the largest relative difference of the raw valid
predictions, and, for the quantized runs, the first iteration at which
a stochastic-rounding code of the port differs from the JAX package's,
each side quantizing its own gradients of its own scores with the same
keys (the JAX side through its training program's jitted quantizer). The test file's tolerances and ROADMAP.md queue C quote it.
"""
import os
import sys

import numpy as np
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lightgbm_tpu as jlgb  # noqa: E402
import lightgbm_tpu_torch as tlgb  # noqa: E402
from lightgbm_tpu.boosting.gbdt import _quantize_iter_device  # noqa: E402
import test_torch_quant_train as fixture  # noqa: E402

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)


def same_structure(a, b):
    m = a.num_leaves - 1
    return a.num_leaves == b.num_leaves and all(
        np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m])
        for k in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"))


def drift(name):
    (jb, _), (tb, _) = (fixture.train_with(jlgb, name),
                        fixture.train_with(tlgb, name, device="cpu"))
    cells = []
    for a, b in zip(jb._inner.models, tb._inner.models):
        rel = np.max(np.abs(a.leaf_value - b.leaf_value)
                     / np.maximum(1.0, np.abs(a.leaf_value)))
        cells.append("%.1e%s" % (rel, "" if same_structure(a, b) else "*"))
    ref = jb.predict(fixture.XV, raw_score=True)
    got = tb.predict(fixture.XV, raw_score=True)
    pred = np.max(np.abs(got - ref) / np.maximum(1.0, np.abs(ref)))
    return "predictions %.1e; leaves by tree: %s" % (pred, " ".join(cells))


def first_code(name):
    """Train both packages one iteration at a time and quantize each
    side's own gradients before every iteration."""
    params, rounds, _ = fixture.RUNS[name]
    y, _ = fixture.LABELS[params["objective"]]
    p = dict(fixture.BASE, **params)
    n = len(fixture.X)
    jb = jlgb.Booster(dict(p), train_set=jlgb.Dataset(fixture.X, y))
    tb = tlgb.Booster(dict(p), train_set=tlgb.Dataset(fixture.X, y),
                      device="cpu")
    ji, ti = jb._inner, tb._inner
    for it in range(rounds):
        ji.finalize_training()
        jg, jh = (np.asarray(v).reshape(-1)[:n]
                  for v in ji._compute_gradients(ji._score))
        tg, th = ti.objective.get_gradients(ti._score[0])
        bag = ti._bagging_weights(it)
        w = np.ones(n, np.float32) if bag is None else bag.numpy()
        qg, qh, _, _ = _quantize_iter_device(
            jnp.asarray(jg)[None], jnp.asarray(jh)[None], jnp.asarray(w), it,
            seed=ti._quant_seed, n=n, qmax=ti._quant_qmax,
            hess_const=ti._quant_hess_const)
        q = ti._quantize(tg, th, torch.from_numpy(w), it, n, ti._quant_qmax,
                         reciprocal_scale=True)
        ref = np.stack([np.asarray(qg)[0], np.asarray(qh)[0]], 1)
        bad = np.argwhere(ref != q.codes.numpy())
        if len(bad):
            r, c = bad[0]
            words = int((jg.view(np.int32) != tg.numpy().view(np.int32))
                        .sum())
            return ("first differing code: iteration %d, row %d, %s code %d "
                    "in the port, %d in JAX (%d codes differ; %d of %d "
                    "gradients differ in their bits)"
                    % (it, r, ("gradient", "hessian")[c],
                       q.codes[r, c], ref[r, c], len(bad), words, n))
        jb.update()
        tb.update()
    return "no code differs in %d iterations" % rounds


if __name__ == "__main__":
    for run in fixture.RUNS:
        print("%s: %s" % (run, drift(run)))
        if "tpu_hist_quantize" in fixture.RUNS[run][0]:
            print("%s: %s" % (run, first_code(run)))
