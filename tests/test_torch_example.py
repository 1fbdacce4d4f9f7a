"""examples/python-guide/advanced_example.py runs under the port, on the
CPU, from a copy.

The copy lives in a temporary directory, beside the binary data that
examples/gen_data.py's `binary` generator writes there; its only edits
are `import lightgbm_tpu_torch as lgb` and `device="cpu"` in its two
`lgb.train` calls. It walks the slice's model API: per-row weights,
`free_raw_data`, `dump_model`, `save_model`, continued training from
`init_model` and `predict` with `pred_early_stop`. The JAX original runs
on the same data; the port's continued model has its 20 trees, its JSON
dump has the JAX dump's shape, and its early-stop predictions equal the
JAX package's on the same model (raw scores bitwise). Between the two
runs, full and early-stop predictions agree within 1e-5 on all rows but
at most 2 of 2,100 (1 on this data): both packages sum the weighted
histograms in bf16 hi+lo halves (the default `tpu_hist_bf16`) and scan
them in XLA's cumsum order, and the first nine trees are the same; at
tree 9, node 26, the JAX package splits feature 20 at bin 69 (gain
8.7435226) and the port at bin 68 (gain 8.7435217), adjacent thresholds
whose gains differ in the last bits (ROADMAP C), and the row that the
split moves differs by 0.031.
"""
import importlib.util
import json
import pathlib
import runpy

import numpy as np
import torch

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _gen_data(root):
    spec = importlib.util.spec_from_file_location(
        "gen_data", EXAMPLES / "gen_data.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.HERE = str(root)
    gen.binary()


def _copy(src, dst, port):
    text = src.read_text()
    if port:
        edits = [("import lightgbm_tpu as lgb",
                  "import lightgbm_tpu_torch as lgb"),
                 ("verbose_eval=5)", 'verbose_eval=5, device="cpu")'),
                 ("verbose_eval=False)",
                  'verbose_eval=False, device="cpu")')]
        for old, new in edits:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(text)
    return dst


def test_advanced_example_runs_under_the_port(tmp_path, capsys):
    for side in ("port", "jax"):
        _gen_data(tmp_path / side)
    src = EXAMPLES / "python-guide" / "advanced_example.py"
    port = runpy.run_path(str(_copy(
        src, tmp_path / "port" / "python-guide" / "advanced_example.py",
        port=True)))
    port_json = json.loads((tmp_path / "port" / "python-guide"
                            / "model.json").read_text())
    jax = runpy.run_path(str(_copy(
        src, tmp_path / "jax" / "python-guide" / "advanced_example.py",
        port=False)))
    jax_json = json.loads((tmp_path / "jax" / "python-guide"
                           / "model.json").read_text())
    out = capsys.readouterr().out
    assert out.count("Continued model has 20 trees") == 2
    assert type(port["gbm2"]).__module__ == "lightgbm_tpu_torch.basic"
    assert port["gbm2"].num_trees() == jax["gbm2"].num_trees() == 20
    assert sorted(port_json) == sorted(jax_json)
    assert len(port_json["tree_info"]) == len(jax_json["tree_info"]) == 10
    for a, b in zip(port_json["tree_info"], jax_json["tree_info"]):
        assert a["num_leaves"] == b["num_leaves"]
    got, ref = port["pred"], jax["pred"]
    assert got.shape == ref.shape == (2100,)
    assert np.isfinite(got).all() and ((got > 0) & (got < 1)).all()
    # the same continued model early-stops as the JAX package does
    es = dict(pred_early_stop=True, pred_early_stop_freq=5,
              pred_early_stop_margin=4.0)
    x_test = port["X_test"]
    same_model = jax["lgb"].Booster(
        model_str=port["gbm2"].model_to_string())
    assert np.array_equal(
        port["gbm2"].predict(x_test, raw_score=True, **es),
        same_model.predict(x_test, raw_score=True, **es))
    assert np.abs(got - same_model.predict(x_test, **es)).max() <= 1e-6
    # the two runs' models: see the module docstring
    full = np.abs(port["gbm2"].predict(x_test)
                  - jax["gbm2"].predict(x_test))
    assert (full > 1e-5).sum() <= 2
    assert (np.abs(got - ref) > 1e-5).sum() <= 2
    assert len(port["evals_result"]["valid_0"]["binary_logloss"]) == 10
