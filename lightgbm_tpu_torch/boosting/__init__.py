from .dart import DART
from .gbdt import GBDT

from .. import log


class GOSS(GBDT):
    """GOSS models predict like GBDT; only the model-text name differs
    (the sampling itself arrives with training)."""

    def model_name(self) -> str:
        return "goss"


def create_boosting(boosting_type: str, config, device):
    """Factory for the model kinds model text names (reference:
    Boosting::CreateBoosting, boosting.cpp:29-76). RF models serialise
    as `tree` with `average_output` and load as GBDT."""
    if boosting_type == "gbdt":
        return GBDT(config, device)
    if boosting_type == "dart":
        return DART(config, device)
    if boosting_type == "goss":
        return GOSS(config, device)
    log.fatal("Unknown boosting type %s" % boosting_type)
