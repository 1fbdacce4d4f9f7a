from .dart import DART
from .gbdt import GBDT, boosting_kind
from .goss import GOSS
from .rf import RF

from .. import log


def create_boosting(boosting_type: str, config, device):
    """Factory (reference: Boosting::CreateBoosting, boosting.cpp:29-76;
    lightgbm_tpu/boosting/__init__.py). RF models serialise as `tree`
    with `average_output` and load as GBDT."""
    kind = boosting_kind(boosting_type)
    if kind == "gbdt":
        return GBDT(config, device)
    if kind == "dart":
        return DART(config, device)
    if kind == "goss":
        return GOSS(config, device)
    if kind == "rf":
        return RF(config, device)
    log.fatal("Unknown boosting type %s" % boosting_type)
