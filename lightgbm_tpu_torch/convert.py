"""Carry a model or a binned dataset across as arrays.

`trees_from_numpy` takes one dict of numpy arrays per tree, keyed by the
attribute names of the JAX package's `Tree` (lightgbm_tpu/tree.py:38-80:
`num_leaves`, `split_feature`, `threshold`, `decision_type`,
`left_child`, `right_child`, `leaf_value`, `leaf_count`,
`internal_value`, `internal_count`, `split_gain`, `shrinkage`,
`num_cat`, `cat_boundaries`, `cat_threshold`, ...), i.e. `vars()` of a
JAX Tree with its arrays as numpy; a linear tree's `leaf_coeff`,
`leaf_features` and `leaf_features_inner` [L, k] come across with them. `booster_from_numpy` builds a port
Booster from such trees and a header. Both give the same Booster as
loading the model's text does. `dataset_from_numpy` builds the port's
binned Dataset from a JAX Dataset's arrays (with its query groups), so
both packages can be fed the very same bins.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .basic import Booster
from .binning import BinMapper
from .dataset import Dataset, Metadata
from .efb import FeatureGroups
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


def dataset_from_numpy(d: dict) -> Dataset:
    """The port's Dataset from a JAX `lightgbm_tpu.dataset.Dataset` given
    as plain arrays: `binned` [N, G], `mappers` (each mapper's
    `to_dict()`, one per original column), `groups` (`groups.to_dict()`),
    `label` and optionally `weight`, `query_boundaries` and
    `query_weights` (its metadata's, for ranking), `feature_meta` (its
    `feature_meta_arrays()`, checked against the rebuilt one),
    `feature_names` and `max_bin`."""
    ds = Dataset()
    ds.mappers = [BinMapper.from_dict(m) for m in d["mappers"]]
    ds.num_total_features = len(ds.mappers)
    ds.used_features = [j for j, m in enumerate(ds.mappers)
                        if not m.is_trivial]
    ds.feature_names = list(d.get("feature_names") or [
        f"Column_{i}" for i in range(ds.num_total_features)])
    ds.max_bin = int(d.get("max_bin", 255))
    num_bins = np.asarray([ds.mappers[j].num_bin for j in ds.used_features],
                          np.int32)
    ds.groups = FeatureGroups([[int(j) for j in g]
                               for g in d["groups"]["groups"]], num_bins)
    ds.binned = np.ascontiguousarray(d["binned"])
    if ds.binned.ndim != 2 or ds.binned.shape[1] != ds.groups.num_groups:
        raise LightGBMError("binned has %s columns for %d groups"
                            % (ds.binned.shape[1:], ds.groups.num_groups))
    ds.metadata = Metadata(ds.binned.shape[0])
    if d.get("label") is not None:
        ds.metadata.set_label(d["label"])
    if d.get("weight") is not None:
        ds.metadata.set_weights(d["weight"])
    if d.get("query_boundaries") is not None:
        qb = np.asarray(d["query_boundaries"], np.int64)
        if qb[0] != 0:
            raise LightGBMError("query_boundaries must start at 0")
        ds.metadata.set_group(np.diff(qb))
    if d.get("query_weights") is not None:
        ds.metadata.query_weights = np.asarray(d["query_weights"], np.float32)
    meta = d.get("feature_meta")
    if meta is not None:
        mine = ds.feature_meta_arrays()
        bad = [k for k in mine if not np.array_equal(mine[k],
                                                     np.asarray(meta[k]))]
        if bad:
            raise LightGBMError("feature_meta disagrees with the mappers "
                                "and groups on %s" % ", ".join(bad))
    return ds
