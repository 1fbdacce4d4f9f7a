"""Forest prediction: the stacked layout, the two walk kernels' wrappers
and their plain PyTorch versions; and the bin-space walk of one tree
(kernel W) that training uses to score its valid sets.

Counterpart of `lightgbm_tpu/ops/predict.py` on the raw-feature path:
`predict_forest_raw` (:305) over `stack_trees_raw` (:277), the leaf walk
`predict_forest_leaf_raw` (:656) and, on the TPU's serving path, the
gather-free `predict_forest_raw_matmul` (:585) and
`predict_forest_leaf_matmul` (:629). All compute the same function:
per (row, tree) the leaf that `_decide_raw` (:118) routes the row to,
then either the leaf index or the sum of the leaf values in tree order.

On a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/forest_walk.cu`, built and bound by `ops/_build.py`) or raises;
on a CPU tensor it runs the plain version beside it. Nothing switches
from one to the other on failure. Each wrapper counts its launches in
a plain integer attribute (`forest_value_walk.launches`), so a run can
show that its main path went through the kernels.

W, `tree_value_walk_binned`, is the counterpart of `predict_value_binned`
(:182) with `predict_leaf_binned` (:87) and `_decide_binned` (:75): one
tree walked in the stored-group bin space of a binned matrix (EFB
decode, bin thresholds), its leaf value added to each row's score
(`csrc/binned_walk.cu`); its leaf mode, `tree_leaf_walk_binned`, returns
the rows' leaves instead (a linear tree's valid-set scoring).

Linear forests (`linear_tree`): the stack carries each leaf's
coefficients and real feature columns, and K1 adds the leaf's linear
term at the leaf it reaches (`predict_value_raw` :193 with
`linear_leaf_addend` :163; `csrc/linear_term.cuh`, `ops/linear.py`).
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..binning import MISSING_NAN, MISSING_ZERO
from ..log import LightGBMError
from . import _build

K_ZERO_THRESHOLD = 1e-35
# smallest normal f32. The JAX package's walk runs with subnormals
# flushed to zero (XLA's CPU backend and the TPU both flush), so a
# subnormal feature value or threshold compares as a signed zero; the
# port flushes both explicitly (thresholds when stacking, values in the
# walk) rather than depend on a floating-point mode.
_F32_TINY = float(np.finfo(np.float32).tiny)

# per-node decision byte (the Tree's decision_type bit layout,
# tree.h:268-284): bit 0 categorical, bit 1 default_left, bits 2-3 the
# missing type of the node's feature
_CAT_BIT = 1
_DEFAULT_LEFT_BIT = 2


@dataclass
class Forest:
    """Trees stacked for the raw-feature walk: node arrays [T, M] padded
    to the widest tree, leaf values [T, L], categorical bitsets per tree.
    The fields are the ones `_decide_raw` reads from a stacked
    DeviceTree, with default_left / is_categorical / node_missing packed
    into one byte per node."""
    num_leaves: torch.Tensor      # [T] i32
    split_feature: torch.Tensor   # [T, M] i32 original column
    threshold: torch.Tensor       # [T, M] f32 (category index at cat nodes)
    decision: torch.Tensor        # [T, M] u8, see _CAT_BIT/_DEFAULT_LEFT_BIT
    left_child: torch.Tensor      # [T, M] i32 (negative = ~leaf, pad -1)
    right_child: torch.Tensor     # [T, M] i32
    cat_boundaries: torch.Tensor  # [T, C+2] i32 word offsets, last-padded
    cat_bitset: torch.Tensor      # [T, W] i32 holding u32 bitset words
    leaf_value: torch.Tensor      # [T, L] f32
    leaf_coeff: torch.Tensor      # [T, L, K] f32 (K = 0: constant leaves)
    leaf_feat: torch.Tensor       # [T, L, K] i32 real columns, -1 padded
    max_depth: int                # deepest leaf: the plain walk's steps
    num_features: int             # 1 + the largest feature read

    @property
    def num_trees(self) -> int:
        return int(self.num_leaves.shape[0])

    @property
    def linear_k(self) -> int:
        return int(self.leaf_coeff.shape[2])

    @property
    def device(self) -> torch.device:
        return self.leaf_value.device

    def nbytes(self) -> int:
        tensors = [getattr(self, f.name) for f in fields(self)]
        return sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor))


def _tree_depth(tree) -> int:
    """Depth of the deepest leaf (0 for a one-leaf tree)."""
    if tree.num_leaves <= 1:
        return 0
    deepest = 0
    stack = [(0, 1)]
    while stack:
        node, depth = stack.pop()
        for child in (tree.left_child[node], tree.right_child[node]):
            if child < 0:
                deepest = max(deepest, depth)
            else:
                stack.append((int(child), depth + 1))
    return deepest


def stack_trees(trees, device: torch.device) -> Forest:
    """Stack host Trees into one Forest on `device`, padded like the JAX
    package's `stack_trees`/`stack_trees_raw` (ops/predict.py:202-291):
    pad nodes have children -1, and cat_boundaries pad with their last
    offset so an out-of-range category index finds an empty slice.
    Thresholds are clipped to the f32 range and rounded to f32 exactly
    as the JAX package does, so rows on a threshold go the same way
    (and subnormal ones flushed to zero, see _F32_TINY). Linear leaves'
    coefficients and real feature columns are padded to the widest k
    with zero coefficients and column -1."""
    if not trees:
        raise LightGBMError("cannot stack an empty forest")
    max_m = max(max(t.num_leaves - 1, 1) for t in trees)
    max_l = max(t.num_leaves for t in trees)
    max_cat = max(t.num_cat for t in trees)
    max_w = max(max(len(t.cat_threshold), 1) for t in trees)
    fmax = np.finfo(np.float32).max

    def pad(get, size, dtype, fill=0):
        out = np.full((len(trees), size), fill, dtype)
        for i, t in enumerate(trees):
            arr = np.asarray(get(t))
            out[i, :len(arr)] = arr
        return out

    def decision(t):
        m = max(t.num_leaves - 1, 0)
        return [(_CAT_BIT if t.is_categorical_node(i) else 0)
                | (_DEFAULT_LEFT_BIT if t.default_left_node(i) else 0)
                | (int(t.node_missing[i]) << 2) for i in range(m)]

    def split_features(t):
        return t.split_feature[:max(t.num_leaves - 1, 0)]

    max_k = max(t.leaf_coeff.shape[1] for t in trees)
    coeff = np.zeros((len(trees), max_l, max_k), np.float32)
    feat = np.full((len(trees), max_l, max_k), -1, np.int32)
    for i, t in enumerate(trees):
        lk = t.leaf_coeff.shape[1]
        coeff[i, :t.num_leaves, :lk] = t.leaf_coeff
        feat[i, :t.num_leaves, :lk] = t.leaf_features
    threshold = pad(lambda t: np.clip(t.threshold, -fmax, fmax),
                    max_m, np.float32)
    threshold[np.abs(threshold) < _F32_TINY] = 0.0
    arrays = dict(
        num_leaves=np.asarray([t.num_leaves for t in trees], np.int32),
        split_feature=pad(split_features, max_m, np.int32),
        threshold=threshold,
        decision=pad(decision, max_m, np.uint8),
        left_child=pad(lambda t: t.left_child, max_m, np.int32, fill=-1),
        right_child=pad(lambda t: t.right_child, max_m, np.int32, fill=-1),
        cat_boundaries=pad(
            lambda t: np.concatenate(
                [t.cat_boundaries,
                 np.full(max_cat + 2 - len(t.cat_boundaries),
                         t.cat_boundaries[-1], np.int32)]),
            max_cat + 2, np.int32),
        cat_bitset=pad(lambda t: t.cat_threshold, max_w,
                       np.uint32).view(np.int32),
        leaf_value=pad(lambda t: t.leaf_value, max_l, np.float32),
        leaf_coeff=coeff, leaf_feat=feat,
    )
    used = [int(np.max(split_features(t))) + 1 for t in trees
            if t.num_leaves > 1] + [int(feat.max()) + 1 if feat.size else 0]
    return Forest(
        **{k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
        max_depth=max(_tree_depth(t) for t in trees),
        num_features=max(used, default=0))


@dataclass(frozen=True)
class OutputTransform:
    """The single-class output epilogue of `GBDT.predict`
    (lightgbm_tpu/boosting/gbdt.py:1993-2016): convert_output(raw /
    denom + bias) in f32, where convert_output is the identity or
    1 / (1 + exp(-sigmoid * x))."""
    kind: str            # "identity" | "sigmoid"
    denom: float = 1.0
    bias: float = 0.0
    sigmoid: float = 1.0


# epilogue codes of the kernel's C interface (0 = raw, no epilogue)
_EPILOGUE = {"identity": 1, "sigmoid": 2}


# ----------------------------------------------------------------------
# plain versions: the same walk in torch ops, lockstep over [T, N]
def _go_left_plain(forest: Forest, node, fval):
    """`_decide_raw` over [T, N] node/value pairs."""
    dec = forest.decision.gather(1, node)
    thr = forest.threshold.gather(1, node)
    fval = torch.where(fval.abs() < _F32_TINY, fval * 0.0, fval)
    is_nan = torch.isnan(fval)
    miss = (dec >> 2) & 3
    is_missing = (((miss == MISSING_NAN) & is_nan)
                  | ((miss == MISSING_ZERO)
                     & (is_nan | (fval.abs() <= K_ZERO_THRESHOLD))))
    fsafe = torch.where(is_nan, 0.0, fval)
    numeric_left = torch.where(is_missing, (dec & _DEFAULT_LEFT_BIT) != 0,
                               fsafe <= thr)
    # categorical: floor(x) in the node's bitset; NaN, negative and
    # beyond-the-bitset categories go right
    is_cat = (dec & _CAT_BIT) != 0
    cat_idx = torch.where(is_cat, thr, 0.0).long()
    lo = forest.cat_boundaries.gather(1, cat_idx).long()
    nwords = forest.cat_boundaries.gather(1, cat_idx + 1).long() - lo
    cat = torch.floor(fsafe)
    valid = is_cat & ~is_nan & (cat >= 0) & (cat < nwords * 32)
    value = torch.where(valid, cat, 0.0).long()
    word = forest.cat_bitset.gather(
        1, torch.where(valid, lo + value // 32, 0)).long()
    cat_left = valid & (((word >> (value % 32)) & 1) == 1)
    return torch.where(is_cat, cat_left, numeric_left)


def _leaves_plain(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """[T, N] int64 leaf index per (tree, row): every row descends every
    tree one level per step, for the forest's max depth."""
    n = x.shape[0]
    xt = x.t()
    node = torch.where(forest.num_leaves > 1, 0, -1).long()
    node = node[:, None].expand(-1, n).contiguous()
    split = forest.split_feature.long()
    left = forest.left_child.long()
    right = forest.right_child.long()
    for _ in range(forest.max_depth):
        nd = node.clamp(min=0)
        fval = xt.gather(0, split.gather(1, nd))
        nxt = torch.where(_go_left_plain(forest, nd, fval),
                          left.gather(1, nd), right.gather(1, nd))
        node = torch.where(node >= 0, nxt, node)
    return ~node


def apply_output_plain(raw: torch.Tensor,
                       transform: OutputTransform) -> torch.Tensor:
    """The kernel epilogue in torch ops (f32 throughout)."""
    denom = torch.tensor(transform.denom, dtype=torch.float32,
                         device=raw.device)
    y = raw / denom + transform.bias
    if transform.kind == "sigmoid":
        y = 1.0 / (1.0 + torch.exp(-transform.sigmoid * y))
    return y


def forest_value_walk_plain(forest: Forest, x: torch.Tensor,
                            transform: Optional[OutputTransform] = None
                            ) -> torch.Tensor:
    """[N] f32: sum over trees 0..T-1, in that order, of each tree's leaf
    value, plus its linear term in a linear forest (the order K1 sums
    in, so the two agree bitwise)."""
    from .linear import gather_values, linear_dot_plain
    leaf = _leaves_plain(forest, x)
    vals = forest.leaf_value.gather(1, leaf)
    out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    rows = torch.arange(x.shape[0], device=x.device)
    for t in range(forest.num_trees):
        v = vals[t]
        if forest.linear_k:
            xv, ok = gather_values(x, rows, forest.leaf_feat[t][leaf[t]])
            lin = linear_dot_plain(forest.leaf_coeff[t][leaf[t]], xv)
            v = v + torch.where(ok, lin, torch.zeros_like(lin))
        out += v
    return out if transform is None else apply_output_plain(out, transform)


def forest_leaf_walk_plain(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """[N, T] i32 leaf index per (row, tree)."""
    return _leaves_plain(forest, x).t().to(torch.int32).contiguous()


# ----------------------------------------------------------------------
# kernel wrappers
_launch_lock = threading.Lock()


def _check_inputs(forest: Forest, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise LightGBMError("forest walk takes a 2-D float32 row matrix "
                            "(got %s %s)" % (x.dtype, tuple(x.shape)))
    if not x.is_contiguous() or x.shape[0] >= 2 ** 31:
        raise LightGBMError("forest walk takes a contiguous row matrix "
                            "of fewer than 2**31 rows")
    if x.shape[1] < forest.num_features:
        raise LightGBMError(
            "rows have %d feature column(s); the forest splits on column "
            "%d" % (x.shape[1], forest.num_features - 1))
    if x.device != forest.device:
        raise LightGBMError("rows on %s, forest on %s"
                            % (x.device, forest.device))
    if x.device.type not in ("cpu", "cuda"):
        raise LightGBMError("forest walk runs on cpu or cuda, not %s"
                            % x.device)


def _launch(wrapper, entry: str, forest: Forest, x: torch.Tensor,
            extra: tuple, out: torch.Tensor) -> None:
    """Launch one walk kernel on the current stream of x's device and
    count it; raises on any CUDA error the launch reports."""
    lib = _build.load_library("forest")
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (
        forest.num_leaves, forest.split_feature, forest.threshold,
        forest.decision, forest.left_child, forest.right_child,
        forest.cat_boundaries, forest.cat_bitset, forest.leaf_value,
        forest.leaf_coeff, forest.leaf_feat)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            ctypes.c_void_p(x.data_ptr()), x.shape[0], x.shape[1], *ptr,
            forest.num_trees, forest.split_feature.shape[1],
            forest.leaf_value.shape[1], forest.cat_boundaries.shape[1],
            forest.cat_bitset.shape[1], forest.linear_k, *extra,
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if rc != 0:
        raise LightGBMError("%s launch failed: CUDA error %d (%s)" % (
            entry, rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        wrapper.launches += 1


def forest_value_walk(forest: Forest, x: torch.Tensor,
                      transform: Optional[OutputTransform] = None
                      ) -> torch.Tensor:
    """K1: [N] f32 raw score (or, with `transform`, the converted
    output) of the forest on rows x [N, F]."""
    _check_inputs(forest, x)
    if x.device.type == "cpu":
        return forest_value_walk_plain(forest, x, transform)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0]:
        extra = (0, 1.0, 0.0, 1.0) if transform is None else (
            _EPILOGUE[transform.kind], float(transform.denom),
            float(transform.bias), float(transform.sigmoid))
        _launch(forest_value_walk, "lgbt_forest_value_walk", forest, x,
                extra, out)
    return out


def forest_leaf_walk(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """K2: [N, T] i32 leaf index per (row, tree)."""
    _check_inputs(forest, x)
    if x.device.type == "cpu":
        return forest_leaf_walk_plain(forest, x)
    out = torch.empty((x.shape[0], forest.num_trees), dtype=torch.int32,
                      device=x.device)
    if x.shape[0]:
        _launch(forest_leaf_walk, "lgbt_forest_leaf_walk", forest, x, (),
                out)
    return out


forest_value_walk.launches = 0
forest_leaf_walk.launches = 0


# ----------------------------------------------------------------------
# W: one tree in bin space
# node record fields of csrc/binned_walk.cu, int32 each
_NODE_FIELDS = ("node_group", "node_offset", "node_num_bin", "node_bundled",
                "node_default_bin", "node_nan_bin", "node_missing",
                "threshold_in_bin", "flags", "left_child", "right_child")


@dataclass
class BinnedTree:
    """One tree as the bin-space walk reads it: node records [M, 11]
    int32 (see _NODE_FIELDS; flags = default_left | categorical << 1),
    bin-space categorical bitsets and f32 leaf values."""
    nodes: torch.Tensor         # [max(L-1, 1), 11] i32
    cat_bounds: torch.Tensor    # [C+2] i32
    cat_bits: torch.Tensor      # [W] i32 holding u32 words
    leaf_value: torch.Tensor    # [L] f32
    num_leaves: int
    max_depth: int


def binned_tree(tree, device: torch.device,
                leaf_value: Optional[np.ndarray] = None) -> BinnedTree:
    """A host Tree (with bin metadata) laid out for W; `leaf_value`
    overrides the tree's own (rollback adds the negated values). A
    linear tree's values are its intercepts: W's leaf mode serves it."""
    if not tree.has_bin_metadata:
        raise LightGBMError("the binned walk needs a tree with bin "
                            "metadata (Tree.attach_bin_metadata)")
    m = max(tree.num_leaves - 1, 1)
    rec = np.zeros((m, len(_NODE_FIELDS)), np.int32)
    nodes = max(tree.num_leaves - 1, 0)
    for j, name in enumerate(_NODE_FIELDS):
        if name == "flags":
            col = [(1 if tree.default_left_node(i) else 0)
                   | (2 if tree.is_categorical_node(i) else 0)
                   for i in range(nodes)]
        elif name == "node_missing":
            col = [tree.missing_type_node(i) for i in range(nodes)]
        else:
            col = np.asarray(getattr(tree, name))[:nodes]
        rec[:nodes, j] = np.asarray(col, np.int64)
    values = tree.leaf_value if leaf_value is None else leaf_value
    bounds = np.asarray(tree.cat_boundaries_inner, np.int32)
    bounds = np.concatenate([bounds, np.full(2, bounds[-1], np.int32)])
    bits = np.asarray(tree.cat_threshold_inner, np.uint32)
    if bits.size == 0:
        bits = np.zeros(1, np.uint32)
    return BinnedTree(
        nodes=torch.from_numpy(rec).to(device),
        cat_bounds=torch.from_numpy(bounds).to(device),
        cat_bits=torch.from_numpy(bits.view(np.int32)).to(device),
        leaf_value=torch.from_numpy(
            np.asarray(values, np.float32).copy()).to(device),
        num_leaves=int(tree.num_leaves), max_depth=_tree_depth(tree))


def tree_leaf_binned_plain(tree: BinnedTree,
                           binned: torch.Tensor) -> torch.Tensor:
    """[N] int64 leaf of each row: every row descends one level a step,
    for the tree's depth (`predict_leaf_binned`)."""
    n = binned.shape[0]
    node = torch.full((n,), 0 if tree.num_leaves > 1 else -1,
                      dtype=torch.long, device=binned.device)
    rec = tree.nodes.long()
    f = {name: rec[:, j] for j, name in enumerate(_NODE_FIELDS)}
    rows = torch.arange(n, device=binned.device)
    for _ in range(tree.max_depth):
        nd = node.clamp(min=0)
        b = binned[rows, f["node_group"][nd]].long()
        off, nb = f["node_offset"][nd], f["node_num_bin"][nd]
        dbin = f["node_default_bin"][nd]
        in_slice = (b >= off) & (b < off + nb)
        b = torch.where(f["node_bundled"][nd] != 0,
                        torch.where(in_slice, b - off, dbin), b)
        miss = f["node_missing"][nd]
        is_missing = (((miss == MISSING_NAN) & (b == f["node_nan_bin"][nd]))
                      | ((miss == MISSING_ZERO) & (b == dbin)))
        flags = f["flags"][nd]
        thr = f["threshold_in_bin"][nd]
        numeric = torch.where(is_missing, (flags & 1) != 0, b <= thr)
        is_cat = (flags & 2) != 0
        idx = torch.where(is_cat, thr, 0).clamp(
            0, tree.cat_bounds.shape[0] - 2)
        lo = tree.cat_bounds.long()[idx]
        words = tree.cat_bounds.long()[idx + 1] - lo
        at = (lo + (b >> 5)).clamp(0, tree.cat_bits.shape[0] - 1)
        word = tree.cat_bits.long()[at] & 0xFFFFFFFF
        cat = ((b >> 5) < words) & (((word >> (b & 31)) & 1) == 1)
        left = torch.where(is_cat, cat, numeric)
        nxt = torch.where(left, f["left_child"][nd], f["right_child"][nd])
        node = torch.where(node >= 0, nxt, node)
    return ~node


def tree_value_walk_binned_plain(tree: BinnedTree, binned: torch.Tensor,
                                 score: torch.Tensor) -> None:
    score += tree.leaf_value[tree_leaf_binned_plain(tree, binned)]


def tree_leaf_walk_binned_plain(tree: BinnedTree,
                                binned: torch.Tensor) -> torch.Tensor:
    return tree_leaf_binned_plain(tree, binned).to(torch.int32)


def tree_value_walk_binned(tree: BinnedTree, binned: torch.Tensor,
                           score: torch.Tensor) -> None:
    """W: score[r] += leaf_value[leaf of row r] for the binned rows
    [N, G], in place."""
    if binned.dim() != 2 or score.shape != (binned.shape[0],) \
            or score.dtype != torch.float32:
        raise LightGBMError("tree_value_walk_binned takes binned [N, G] and "
                            "an f32 score [N]")
    _walk_binned(tree, binned, score, None)


def tree_leaf_walk_binned(tree: BinnedTree,
                          binned: torch.Tensor) -> torch.Tensor:
    """W's leaf mode: the [N] int32 leaf of each binned row [N, G]."""
    if binned.dim() != 2:
        raise LightGBMError("tree_leaf_walk_binned takes binned [N, G]")
    leaf = torch.empty(binned.shape[0], dtype=torch.int32,
                       device=binned.device)
    _walk_binned(tree, binned, None, leaf)
    return leaf


def _walk_binned(tree: BinnedTree, binned: torch.Tensor,
                 score: Optional[torch.Tensor],
                 leaf: Optional[torch.Tensor]) -> None:
    """Launch W adding values to `score`, or writing leaves to `leaf`."""
    out = score if leaf is None else leaf
    if any(t.device != binned.device for t in (
            out, tree.nodes, tree.leaf_value)):
        raise LightGBMError("tree_value_walk_binned: inputs on different "
                            "devices")
    if binned.device.type == "cpu":
        if leaf is not None:
            leaf.copy_(tree_leaf_walk_binned_plain(tree, binned))
            return None
        return tree_value_walk_binned_plain(tree, binned, score)
    if binned.device.type != "cuda":
        raise LightGBMError("tree_value_walk_binned runs on cpu or cuda, "
                            "not %s" % binned.device)
    if binned.dtype != torch.uint8 or not (binned.is_contiguous()
                                           and out.is_contiguous()):
        raise LightGBMError("tree_value_walk_binned takes contiguous uint8 "
                            "bins and score")
    lib = _build.load_library("walk")
    p = ctypes.c_void_p
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.lgbt_tree_value_walk_binned(
            p(binned.data_ptr()), binned.shape[1], binned.shape[0],
            p(tree.nodes.data_ptr()), tree.num_leaves,
            p(tree.cat_bounds.data_ptr()), p(tree.cat_bits.data_ptr()),
            tree.cat_bits.shape[0], p(tree.leaf_value.data_ptr()),
            p(None if score is None else score.data_ptr()),
            p(None if leaf is None else leaf.data_ptr()), p(stream))
    if rc != 0:
        raise LightGBMError("tree_value_walk_binned launch failed: CUDA "
                            "error %d (%s)"
                            % (rc, lib.lgbt_error_string(rc).decode()))
    counter = tree_value_walk_binned if leaf is None \
        else tree_leaf_walk_binned
    with _launch_lock:
        counter.launches += 1


tree_value_walk_binned.launches = 0
tree_leaf_walk_binned.launches = 0
