"""Carry a model across as arrays instead of model text.

`trees_from_numpy` takes one dict of numpy arrays per tree, keyed by the
attribute names of the JAX package's `Tree` (lightgbm_tpu/tree.py:38-80:
`num_leaves`, `split_feature`, `threshold`, `decision_type`,
`left_child`, `right_child`, `leaf_value`, `leaf_count`,
`internal_value`, `internal_count`, `split_gain`, `shrinkage`,
`num_cat`, `cat_boundaries`, `cat_threshold`, ...), i.e. `vars()` of a
JAX Tree with its arrays as numpy. `booster_from_numpy` builds a port
Booster from such trees and a header. Both give the same Booster as
loading the model's text does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .basic import Booster
from .log import LightGBMError
from .tree import Tree

_SCALARS = {"num_leaves": int, "num_cat": int, "shrinkage": float,
            "has_bin_metadata": bool}


def trees_from_numpy(trees: List[Dict[str, np.ndarray]]) -> List[Tree]:
    """Port Trees from per-tree attribute dicts. Arrays keep the port
    Tree's dtypes; `node_missing` is rebuilt from `decision_type` when
    absent, as a text load does. Unknown keys are an error."""
    out = []
    for i, spec in enumerate(trees):
        if "num_leaves" not in spec:
            raise LightGBMError("tree %d: num_leaves is required" % i)
        t = Tree(int(spec["num_leaves"]))
        for key, value in spec.items():
            if key in _SCALARS:
                setattr(t, key, _SCALARS[key](value))
            elif isinstance(getattr(t, key, None), np.ndarray):
                ref = getattr(t, key)
                arr = np.array(value, dtype=ref.dtype)
                if arr.ndim != ref.ndim:
                    raise LightGBMError("tree %d: %s has %d dims, not %d"
                                        % (i, key, arr.ndim, ref.ndim))
                setattr(t, key, arr)
            else:
                raise LightGBMError("tree %d: unknown Tree field %r"
                                    % (i, key))
        if "node_missing" not in spec and t.num_leaves > 1:
            t.node_missing = np.asarray(
                [t.missing_type_node(j) for j in range(t.num_leaves - 1)],
                np.int32)
        out.append(t)
    return out


def booster_from_numpy(header: dict, trees: List[Dict[str, np.ndarray]],
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Booster:
    """A Booster from a header and per-tree arrays. The header carries
    `num_class`, `num_tree_per_iteration`, `max_feature_idx`, `objective`
    (its model-text value, e.g. "binary sigmoid:1"), `init_score_bias`
    and `average_output`, and optionally `feature_names`,
    `feature_infos` and `boosting` ("gbdt", "dart" or "goss")."""
    models = trees_from_numpy(trees)
    return Booster._assemble(header.get("boosting", "gbdt"),
                             header.get("objective"),
                             lambda gbdt: gbdt.set_model(header, models),
                             device=device)
