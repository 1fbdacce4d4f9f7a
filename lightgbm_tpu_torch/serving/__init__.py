"""Serving: the device-resident forest cache (forest.py), the request
front end with micro-batching (predictor.py) and its admission control
(admission.py). Counterpart of `lightgbm_tpu/serving/`; the model
registry arrives with a later slice."""
from .admission import (AdmissionController, DeadlineExceeded,
                        PredictorShutdown, ServingOverload)
from .forest import CompiledForest
from .predictor import Predictor

__all__ = ["AdmissionController", "CompiledForest", "DeadlineExceeded",
           "Predictor", "PredictorShutdown", "ServingOverload"]
