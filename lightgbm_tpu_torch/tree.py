"""Host-side tree model: fixed-capacity struct-of-arrays + text round-trip.

The port's copy of `lightgbm_tpu/tree.py` (reference `Tree`,
include/LightGBM/tree.h:20-450, src/io/tree.cpp): a leaf-wise tree stored
as parallel arrays over internal nodes (children encode leaves as
`~leaf`), with LightGBM's `Tree=` text block format (tree.cpp:208-260).
The text format, the attribute names and the scalar oracle `predict_row`
are the JAX package's, so both packages read and write the same bytes.
The bin-space metadata (`tpu_*` lines) is parsed and written back
unchanged. `from_grower_state` builds a tree from the grower's arrays
(learner/grow.py), and `attach_bin_metadata` rebuilds the bin-space
fields of a tree loaded from reference model text.
"""
from __future__ import annotations

import numpy as np

from . import log
from .binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO

# decision_type bit layout (reference: tree.h:268-284)
_CAT_MASK = 1
_DEFAULT_LEFT_MASK = 2


def _avoid_inf(x: float) -> float:
    """Reference: Common::AvoidInf (clamps +-inf thresholds for text IO)."""
    if np.isnan(x):
        return 0.0
    if x >= 1e300:
        return 1e300
    if x <= -1e300:
        return -1e300
    return float(x)


class Tree:
    """One decision tree (host representation)."""

    def __init__(self, num_leaves: int = 1):
        self.num_leaves = num_leaves
        # False for models loaded from reference-LightGBM text (no tpu_*
        # lines); binned-matrix traversal needs the bin metadata rebuilt
        # from a Dataset first (lightgbm_tpu Tree.attach_bin_metadata)
        self.has_bin_metadata = True
        m = max(num_leaves - 1, 1)
        self.split_feature_inner = np.zeros(m, np.int32)   # used-feature space
        self.split_feature = np.zeros(m, np.int32)         # original columns
        self.threshold_in_bin = np.zeros(m, np.int32)
        self.threshold = np.zeros(m, np.float64)
        self.decision_type = np.zeros(m, np.int32)
        self.split_gain = np.zeros(m, np.float64)
        self.left_child = np.full(m, -1, np.int32)
        self.right_child = np.full(m, -1, np.int32)
        self.leaf_value = np.zeros(num_leaves, np.float64)
        self.leaf_count = np.zeros(num_leaves, np.int64)
        self.internal_value = np.zeros(m, np.float64)
        self.internal_count = np.zeros(m, np.int64)
        self.shrinkage = 1.0
        # categorical bitsets (reference: tree.h:355-359, tree.cpp:71-97):
        # a categorical node stores a cat_idx in threshold=; the category
        # set is bits [cat_boundaries[idx], cat_boundaries[idx+1]) words of
        # cat_threshold (raw category values) / cat_threshold_inner (bins)
        self.num_cat = 0
        self.cat_boundaries = np.zeros(1, np.int32)        # word offsets
        self.cat_threshold = np.zeros(0, np.uint32)        # raw-value bitset
        self.cat_boundaries_inner = np.zeros(1, np.int32)
        self.cat_threshold_inner = np.zeros(0, np.uint32)  # bin-space bitset
        # traversal metadata (node_missing is not serialized: it is
        # rebuilt from decision_type on load)
        self.node_missing = np.zeros(m, np.int32)
        self.node_nan_bin = np.zeros(m, np.int32)
        self.node_default_bin = np.zeros(m, np.int32)
        # EFB locators for binned traversal (efb.py): the stored column and
        # bin offset of each node's feature
        self.node_group = np.zeros(m, np.int32)
        self.node_offset = np.zeros(m, np.int32)
        self.node_bundled = np.zeros(m, bool)
        self.node_num_bin = np.zeros(m, np.int32)
        # piecewise-linear leaves (linear_tree=true): per-leaf slope
        # tables [L, k]; k=0 marks a constant-leaf tree. Feature slots
        # are -1-padded; leaf_value doubles as the fitted intercept.
        self.leaf_coeff = np.zeros((num_leaves, 0), np.float64)
        self.leaf_features = np.full((num_leaves, 0), -1, np.int32)        # original columns
        self.leaf_features_inner = np.full((num_leaves, 0), -1, np.int32)  # used-feature space

    # ------------------------------------------------------------------
    @staticmethod
    def _bitset(values) -> np.ndarray:
        """Reference: Common::ConstructBitset (common.h)."""
        values = [int(v) for v in values if v >= 0]
        nwords = (max(values) // 32 + 1) if values else 1
        words = np.zeros(nwords, np.uint32)
        for v in values:
            words[v // 32] |= np.uint32(1) << np.uint32(v % 32)
        return words

    @staticmethod
    def _in_bitset(words: np.ndarray, val: int) -> bool:
        """Reference: Common::FindInBitset."""
        if val < 0:
            return False
        w = val // 32
        if w >= len(words):
            return False
        return bool((int(words[w]) >> (val % 32)) & 1)

    # ------------------------------------------------------------------
    def _push_cat(self, raw_values, bin_values) -> int:
        """Append one categorical node's bitsets; returns its cat_idx."""
        idx = self.num_cat
        raw_words = self._bitset(raw_values)
        bin_words = self._bitset(bin_values)
        self.cat_threshold = np.concatenate([self.cat_threshold, raw_words])
        self.cat_boundaries = np.append(
            self.cat_boundaries, self.cat_boundaries[-1] + len(raw_words)
        ).astype(np.int32)
        self.cat_threshold_inner = np.concatenate(
            [self.cat_threshold_inner, bin_words])
        self.cat_boundaries_inner = np.append(
            self.cat_boundaries_inner,
            self.cat_boundaries_inner[-1] + len(bin_words)).astype(np.int32)
        self.num_cat += 1
        return idx

    # ------------------------------------------------------------------
    @classmethod
    def from_grower_state(cls, state, dataset) -> "Tree":
        """A host Tree from the grower's arrays (learner/grow.py
        GrowerState, or any object with the same attributes), with bin
        thresholds resolved to raw values through the BinMappers
        (lightgbm_tpu/tree.py:131; reference: SerialTreeLearner::Split,
        serial_tree_learner.cpp:519-560)."""
        nl = int(state.num_leaves_used)
        t = cls(nl)
        m = nl - 1
        if m <= 0:
            t.leaf_value[0] = float(np.asarray(state.leaf_value)[0])
            t.leaf_count[0] = int(np.asarray(state.count)[0])
            return t
        feat = np.asarray(state.node_feature)[:m]
        thr = np.asarray(state.node_threshold)[:m]
        dl = np.asarray(state.node_default_left)[:m]
        cat = np.asarray(state.node_is_cat)[:m]
        t.split_feature_inner = feat.astype(np.int32)
        t.split_feature = np.asarray(
            [dataset.real_feature_index(int(j)) for j in feat], np.int32)
        t.threshold_in_bin = thr.astype(np.int32)
        t.split_gain = np.asarray(state.node_gain)[:m].astype(np.float64)
        t.left_child = np.asarray(state.node_left)[:m].astype(np.int32)
        t.right_child = np.asarray(state.node_right)[:m].astype(np.int32)
        t.internal_value = np.asarray(state.node_value)[:m].astype(np.float64)
        t.internal_count = np.asarray(state.node_count)[:m].astype(np.int64)
        t.leaf_value = np.asarray(state.leaf_value)[:nl].astype(np.float64)
        t.leaf_count = np.asarray(state.count)[:nl].astype(np.int64)
        fm = dataset.feature_meta_arrays()
        for i in range(m):
            mapper = dataset.feature_mapper(int(feat[i]))
            t.node_missing[i] = mapper.missing_type
            t.node_nan_bin[i] = mapper.num_bin - 1
            t.node_default_bin[i] = mapper.default_bin
            t.node_group[i] = fm["group"][feat[i]]
            t.node_offset[i] = fm["offset"][feat[i]]
            t.node_bundled[i] = fm["is_bundled"][feat[i]]
            t.node_num_bin[i] = mapper.num_bin
            dt = 0
            if cat[i]:
                dt |= _CAT_MASK
                # one-vs-rest: the bin in thr goes left; serialised as a
                # cat_idx into single-category bitsets (tree.cpp:71-97)
                raw_val = int(mapper.bin_to_value(int(thr[i])))
                cat_idx = t._push_cat([raw_val], [int(thr[i])])
                t.threshold[i] = float(cat_idx)
                t.threshold_in_bin[i] = cat_idx
            else:
                if dl[i]:
                    dt |= _DEFAULT_LEFT_MASK
                t.threshold[i] = _avoid_inf(mapper.bin_to_value(int(thr[i])))
            # missing type bits 2-3 (tree.h:268-284)
            dt |= {MISSING_NONE: 0, MISSING_ZERO: 1 << 2,
                   MISSING_NAN: 2 << 2}[mapper.missing_type]
            t.decision_type[i] = dt
        t._take_linear(state, dataset, nl)
        return t

    def _take_linear(self, state, dataset, nl: int) -> None:
        """Adopt the linear-leaf tables of a grower state, mapping the
        inner feature slots to real columns (lightgbm_tpu/tree.py:
        191-203); a constant-leaf state has no `leaf_coeff`."""
        coeff = getattr(state, "leaf_coeff", None)
        if coeff is None:
            return
        inner = np.asarray(state.leaf_features_inner)[:nl].astype(np.int32)
        self.leaf_coeff = np.asarray(coeff)[:nl].astype(np.float64)
        self.leaf_features_inner = inner
        self.leaf_features = np.asarray(
            [[dataset.real_feature_index(int(j)) if j >= 0 else -1
              for j in row] for row in inner], np.int32).reshape(inner.shape)

    def attach_bin_metadata(self, dataset) -> None:
        """Rebuild the bin-space walk fields from a Dataset's BinMappers
        for a tree loaded from reference model text (raw thresholds
        only; lightgbm_tpu/tree.py:207). The bin threshold is the bin of
        the raw threshold, matching `left = value <= threshold`. Linear
        leaves' features are remapped to the dataset's inner space
        (lightgbm_tpu/tree.py:253-267)."""
        inner_of = {real: inner for inner, real
                    in enumerate(dataset.used_features)}
        inner_sets = {}
        fm = dataset.feature_meta_arrays()
        for i in range(self.num_leaves - 1):
            real = int(self.split_feature[i])
            if real not in inner_of:
                log.fatal("Loaded model splits on feature %d which is "
                          "trivial/absent in the dataset" % real)
            inner = inner_of[real]
            mapper = dataset.feature_mapper(inner)
            self.split_feature_inner[i] = inner
            self.node_missing[i] = mapper.missing_type
            self.node_nan_bin[i] = mapper.num_bin - 1
            self.node_default_bin[i] = mapper.default_bin
            self.node_group[i] = fm["group"][inner]
            self.node_offset[i] = fm["offset"][inner]
            self.node_bundled[i] = fm["is_bundled"][inner]
            self.node_num_bin[i] = mapper.num_bin
            if self.is_categorical_node(i):
                idx = int(self.threshold[i])
                lo, hi = self.cat_boundaries[idx], self.cat_boundaries[idx + 1]
                words = self.cat_threshold[lo:hi]
                raw = [w * 32 + b for w in range(len(words))
                       for b in range(32) if (int(words[w]) >> b) & 1]
                inner_sets[idx] = self._bitset(
                    [mapper.categorical_2_bin[c] for c in raw
                     if c in mapper.categorical_2_bin])
                self.threshold_in_bin[i] = idx
            else:
                self.threshold_in_bin[i] = mapper.value_to_bin(
                    float(self.threshold[i]))
        if self.num_cat > 0:
            sets = [inner_sets.get(i, np.zeros(1, np.uint32))
                    for i in range(self.num_cat)]
            self.cat_boundaries_inner = np.concatenate(
                [[0], np.cumsum([len(w) for w in sets])]).astype(np.int32)
            self.cat_threshold_inner = np.concatenate(sets)
        if self.is_linear:
            remap = np.full(self.leaf_features.shape, -1, np.int32)
            for (r, c), real in np.ndenumerate(self.leaf_features):
                if real < 0:
                    continue
                if int(real) not in inner_of:
                    log.fatal("Loaded linear_tree model regresses on "
                              "feature %d which is trivial/absent in "
                              "the dataset" % int(real))
                remap[r, c] = inner_of[int(real)]
            self.leaf_features_inner = remap
        self.has_bin_metadata = True

    def apply_shrinkage(self, rate: float) -> None:
        """Reference: Tree::Shrinkage (tree.h:166-173)."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.leaf_coeff *= rate
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        """Reference: Tree::AddBias (the boost_from_average fold)."""
        self.leaf_value += val
        self.internal_value += val

    @property
    def is_linear(self) -> bool:
        """True when this tree carries piecewise-linear leaf models."""
        return self.leaf_coeff.shape[1] > 0

    def is_categorical_node(self, i: int) -> bool:
        return bool(self.decision_type[i] & _CAT_MASK)

    def default_left_node(self, i: int) -> bool:
        return bool(self.decision_type[i] & _DEFAULT_LEFT_MASK)

    def missing_type_node(self, i: int) -> int:
        return int(self.decision_type[i] >> 2) & 3

    # ------------------------------------------------------------------
    def _leaf_output(self, leaf: int, row: np.ndarray) -> float:
        """Leaf value plus the linear term. A row with a non-finite value
        in any live feature slot gets the intercept only (the solver
        excluded such rows from the fit the same way)."""
        val = float(self.leaf_value[leaf])
        acc = 0.0
        for j in range(self.leaf_coeff.shape[1]):
            f = int(self.leaf_features[leaf, j])
            if f < 0:
                continue
            fval = row[f]
            if not np.isfinite(fval):
                return val
            acc += float(self.leaf_coeff[leaf, j]) * float(fval)
        return val + acc

    def predict_row(self, row: np.ndarray) -> float:
        """Scalar reference traversal (tree.h:416-450) for testing/host paths."""
        if self.num_leaves <= 1:
            return self._leaf_output(0, row)
        node = 0
        while node >= 0:
            fval = row[self.split_feature[node]]
            if self.is_categorical_node(node):
                idx = int(self.threshold[node])
                lo, hi = self.cat_boundaries[idx], self.cat_boundaries[idx + 1]
                go_left = (not np.isnan(fval)) and self._in_bitset(
                    self.cat_threshold[lo:hi], int(fval))
            else:
                mt = self.missing_type_node(node)
                is_missing = (mt == MISSING_NAN and np.isnan(fval)) or \
                             (mt == MISSING_ZERO and (np.isnan(fval) or abs(fval) <= 1e-35))
                if is_missing:
                    go_left = self.default_left_node(node)
                else:
                    go_left = fval <= self.threshold[node]
            node = self.left_child[node] if go_left else self.right_child[node]
        return self._leaf_output(~node, row)

    def cat_values(self, node: int) -> list:
        """Raw category values going left at a categorical node."""
        idx = int(self.threshold[node])
        lo, hi = self.cat_boundaries[idx], self.cat_boundaries[idx + 1]
        words = self.cat_threshold[lo:hi]
        return [w * 32 + b for w in range(len(words)) for b in range(32)
                if (int(words[w]) >> b) & 1]

    def to_json(self) -> dict:
        """Reference: Tree::ToJSON (tree.cpp:262-330); the dict of
        lightgbm_tpu/tree.py:522."""
        def node_json(idx: int) -> dict:
            if idx < 0:
                leaf = ~idx
                d = {"leaf_index": int(leaf),
                     "leaf_value": float(self.leaf_value[leaf]),
                     "leaf_count": int(self.leaf_count[leaf])}
                if self.is_linear:
                    live = self.leaf_features[leaf] >= 0
                    d["leaf_features"] = [
                        int(f) for f in self.leaf_features[leaf][live]]
                    d["leaf_coeff"] = [
                        float(c) for c in self.leaf_coeff[leaf][live]]
                return d
            cat = self.is_categorical_node(idx)
            thr = "||".join(str(c) for c in self.cat_values(idx)) if cat \
                else float(self.threshold[idx])
            return {
                "split_index": int(idx),
                "split_feature": int(self.split_feature[idx]),
                "split_gain": float(self.split_gain[idx]),
                "threshold": thr,
                "decision_type": "==" if cat else "<=",
                "default_left": self.default_left_node(idx),
                "missing_type": ["None", "Zero", "NaN"][
                    self.missing_type_node(idx)],
                "internal_value": float(self.internal_value[idx]),
                "internal_count": int(self.internal_count[idx]),
                "left_child": node_json(int(self.left_child[idx])),
                "right_child": node_json(int(self.right_child[idx])),
            }
        return {"num_leaves": int(self.num_leaves),
                "shrinkage": self.shrinkage,
                "tree_structure": node_json(0) if self.num_leaves > 1 else
                {"leaf_value": float(self.leaf_value[0])}}

    # ------------------------------------------------------------------
    # text model format (reference: Tree::ToString, tree.cpp:208-260)
    def to_string(self) -> str:
        m = self.num_leaves - 1
        out = []
        out.append(f"num_leaves={self.num_leaves}")
        out.append(f"num_cat={self.num_cat}")
        out.append("split_feature=" + " ".join(str(int(x)) for x in self.split_feature[:m]))
        out.append("split_gain=" + " ".join(repr(float(x)) for x in self.split_gain[:m]))
        out.append("threshold=" + " ".join(repr(float(x)) for x in self.threshold[:m]))
        out.append("decision_type=" + " ".join(str(int(x)) for x in self.decision_type[:m]))
        out.append("left_child=" + " ".join(str(int(x)) for x in self.left_child[:m]))
        out.append("right_child=" + " ".join(str(int(x)) for x in self.right_child[:m]))
        out.append("leaf_value=" + " ".join(repr(float(x)) for x in self.leaf_value[:self.num_leaves]))
        out.append("leaf_count=" + " ".join(str(int(x)) for x in self.leaf_count[:self.num_leaves]))
        out.append("internal_value=" + " ".join(repr(float(x)) for x in self.internal_value[:m]))
        out.append("internal_count=" + " ".join(str(int(x)) for x in self.internal_count[:m]))
        if self.num_cat > 0:
            out.append("cat_boundaries=" + " ".join(
                str(int(x)) for x in self.cat_boundaries[:self.num_cat + 1]))
            out.append("cat_threshold=" + " ".join(
                str(int(x)) for x in self.cat_threshold))
        out.append(f"shrinkage={self.shrinkage}")
        # extension over the reference format: bin-space metadata so loaded
        # models can still traverse binned matrices on device
        out.append("tpu_threshold_in_bin=" + " ".join(str(int(x)) for x in self.threshold_in_bin[:m]))
        out.append("tpu_split_feature_inner=" + " ".join(str(int(x)) for x in self.split_feature_inner[:m]))
        out.append("tpu_nan_bin=" + " ".join(str(int(x)) for x in self.node_nan_bin[:m]))
        out.append("tpu_default_bin=" + " ".join(str(int(x)) for x in self.node_default_bin[:m]))
        # EFB/group locators: without these a text-loaded tree cannot
        # traverse the stored (group-major) binned matrix — they used to
        # be silently zero after load, which corrupted continued-training
        # score replay on any dataset whose groups aren't all column 0
        out.append("tpu_node_group=" + " ".join(str(int(x)) for x in self.node_group[:m]))
        out.append("tpu_node_offset=" + " ".join(str(int(x)) for x in self.node_offset[:m]))
        out.append("tpu_node_bundled=" + " ".join(str(int(x)) for x in self.node_bundled[:m].astype(np.int32)))
        out.append("tpu_node_num_bin=" + " ".join(str(int(x)) for x in self.node_num_bin[:m]))
        if self.num_cat > 0:
            out.append("tpu_cat_boundaries_inner=" + " ".join(
                str(int(x)) for x in self.cat_boundaries_inner[:self.num_cat + 1]))
            out.append("tpu_cat_threshold_inner=" + " ".join(
                str(int(x)) for x in self.cat_threshold_inner))
        if self.is_linear:
            # piecewise-linear leaf tables, flattened row-major [L, k];
            # repr() keeps the f64 coefficients round-trip exact
            out.append(f"tpu_linear_k={self.leaf_coeff.shape[1]}")
            out.append("tpu_leaf_features=" + " ".join(
                str(int(x)) for x in self.leaf_features.ravel()))
            out.append("tpu_leaf_features_inner=" + " ".join(
                str(int(x)) for x in self.leaf_features_inner.ravel()))
            out.append("tpu_leaf_coeff=" + " ".join(
                repr(float(x)) for x in self.leaf_coeff.ravel()))
        return "\n".join(out) + "\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv = {}
        for line in text.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        nl = int(kv["num_leaves"])
        t = cls(nl)
        m = nl - 1

        def arr(key, dtype, size, default=0):
            if key not in kv or not kv[key]:
                return np.full(size, default, dtype)
            vals = kv[key].split()
            return np.asarray([dtype(v) for v in vals], dtype)

        if m > 0:
            t.split_feature = arr("split_feature", np.int32, m)
            t.split_gain = arr("split_gain", np.float64, m)
            t.threshold = arr("threshold", np.float64, m)
            t.decision_type = arr("decision_type", np.int32, m)
            t.left_child = arr("left_child", np.int32, m)
            t.right_child = arr("right_child", np.int32, m)
            t.internal_value = arr("internal_value", np.float64, m)
            t.internal_count = arr("internal_count", np.int64, m)
            # complete bin metadata needs the group locators too: text
            # without them (reference models, or models saved before the
            # locators were serialized) must go through
            # attach_bin_metadata before binned traversal
            t.has_bin_metadata = ("tpu_threshold_in_bin" in kv
                                  and "tpu_node_group" in kv)
            t.threshold_in_bin = arr("tpu_threshold_in_bin", np.int32, m)
            t.split_feature_inner = arr("tpu_split_feature_inner", np.int32, m,
                                        default=-1)
            if (t.split_feature_inner < 0).all():
                t.split_feature_inner = t.split_feature.copy()
            t.node_nan_bin = arr("tpu_nan_bin", np.int32, m)
            t.node_default_bin = arr("tpu_default_bin", np.int32, m)
            t.node_group = arr("tpu_node_group", np.int32, m)
            t.node_offset = arr("tpu_node_offset", np.int32, m)
            t.node_bundled = arr("tpu_node_bundled", np.int32, m).astype(bool)
            t.node_num_bin = arr("tpu_node_num_bin", np.int32, m)
            t.node_missing = np.asarray(
                [t.missing_type_node(i) for i in range(m)], np.int32)
            t.num_cat = int(kv.get("num_cat", 0))
            if t.num_cat > 0:
                t.cat_boundaries = arr("cat_boundaries", np.int32, t.num_cat + 1)
                t.cat_threshold = np.asarray(
                    [np.uint32(v) for v in kv.get("cat_threshold", "").split()],
                    np.uint32)
                inner = kv.get("tpu_cat_threshold_inner", "")
                if inner:
                    t.cat_boundaries_inner = arr(
                        "tpu_cat_boundaries_inner", np.int32, t.num_cat + 1)
                    t.cat_threshold_inner = np.asarray(
                        [np.uint32(v) for v in inner.split()], np.uint32)
                else:
                    # reference text lacks bin-space bitsets; rebuilt on
                    # demand by attach_bin_metadata
                    t.has_bin_metadata = False
        t.leaf_value = arr("leaf_value", np.float64, nl)
        t.leaf_count = arr("leaf_count", np.int64, nl)
        t.shrinkage = float(kv.get("shrinkage", 1.0))
        k = int(kv.get("tpu_linear_k", 0))
        if k > 0:
            t.leaf_features = arr(
                "tpu_leaf_features", np.int32, nl * k, default=-1
            ).reshape(nl, k)
            t.leaf_features_inner = arr(
                "tpu_leaf_features_inner", np.int32, nl * k, default=-1
            ).reshape(nl, k)
            t.leaf_coeff = arr(
                "tpu_leaf_coeff", np.float64, nl * k).reshape(nl, k)
        return t
