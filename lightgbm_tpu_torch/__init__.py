"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one, which stays the reference it is
tested against; it imports torch and numpy and nothing of JAX or of
`lightgbm_tpu`. Its device kernels are written by hand in CUDA C++ for
Hopper (`csrc/`). It trains, `train(params, Dataset(X, y, group=...),
...)` or the scikit-learn style `LGBMRegressor`, `LGBMClassifier`
(binary) and `LGBMRanker`, for the regression, binary and lambdarank
objectives on numeric and categorical features (uint8 or uint16 EFB
group bins, from arrays, data files or the binary cache), with bagging,
GOSS, DART, RF, linear trees and quantized gradients
(`tpu_hist_quantize`), and serves: model text -> `Booster` ->
`Booster.predict` (value, raw_score, pred_leaf, pred_contrib,
num_iteration, early stop, f16 and int8 layouts) and the
`serving.Predictor` front end. Entry points run on the CUDA card unless
the caller passes `device="cpu"`, which runs the plain PyTorch versions
of the kernels.
"""
from . import log, serving
from .basic import Booster, Dataset
from .callback import early_stopping, print_evaluation, record_evaluation
from .engine import train
from .log import LightGBMError
from .serving import Predictor

# the estimators import scikit-learn, which takes seconds: on first use
_ESTIMATORS = ("LGBMClassifier", "LGBMModel", "LGBMRanker", "LGBMRegressor")


def __getattr__(name):
    if name in _ESTIMATORS:
        from . import sklearn
        return getattr(sklearn, name)
    raise AttributeError(
        "module 'lightgbm_tpu_torch' has no attribute %r" % name)


__all__ = ["Booster", "Dataset", "LGBMClassifier", "LGBMModel",
           "LGBMRanker", "LGBMRegressor", "LightGBMError", "Predictor",
           "early_stopping", "log", "print_evaluation", "record_evaluation",
           "serving", "train"]
__version__ = "0.1.0"
