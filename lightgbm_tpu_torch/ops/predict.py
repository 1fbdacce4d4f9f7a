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

K1, K2 and ES walk the Forest's 16-byte node records (`node_records`,
built once a stack) in one of two modes that `walk_plan` picks by the
row count: a block a row with its trees in parallel, or a row a thread
over records and rows staged in shared memory (`csrc/forest_records.cuh`,
shared with QW, says why). K2 writes each row's leaves through a shared
tile in rows mode; ES adds a row's K class values an iteration at a
time and stops a row at its freeze; in rows mode it compacts the live
rows after every chunk and runs in rounds, a launch each over the rows
still live, then a trees-mode tail once few are. A forest whose feature
index or node count does not fit the record is refused by name.

W, `tree_value_walk_binned`, is the counterpart of `predict_value_binned`
(:182) with `predict_leaf_binned` (:87) and `_decide_binned` (:75): one
tree walked in the stored-group bin space of a binned matrix (EFB
decode, bin thresholds), its leaf value added to each row's score
(`csrc/binned_walk.cu`); its leaf mode, `tree_leaf_walk_binned`, returns
the rows' leaves instead (a linear tree's valid-set scoring). Both take
a uint8 matrix or a uint16 one (groups of more than 256 bins) and count
the latter's launches also in `launches_u16`, and those of a tree with a
categorical node (whose bin-space bitsets W walks) in `launches_cat`.

Linear forests (`linear_tree`): the stack carries each leaf's
coefficients and real feature columns, and K1 adds the leaf's linear
term at the leaf it reaches (`predict_value_raw` :193 with
`linear_leaf_addend` :163; `csrc/linear_term.cuh`, `ops/linear.py`).

The serving extras:

- ES, `forest_early_stop_walk`: margin-based per-row early stop over a
  [K, T] stack (`predict_forest_raw_early_stop` :957;
  `csrc/forest_walk.cu` over the records' kernels);
- K1's f16-leaf mode, `forest_value_walk_f16` (`tpu_predict_quantize=
  f16`; `predict_forest_f16` :934): the walk over f16 leaves, summed in
  batches of QUANT_TREE_BATCH trees as the JAX function sums them;
- the fixed-point layout of `tpu_predict_quantize=int8`
  (`stack_trees_quant` :760): QC, `quant_codes` (:820), codes each row's
  values against per-feature grids of the split thresholds, and QW,
  `forest_quant_walk` (`predict_forest_quant` :882), walks the forest on
  the codes (`csrc/forest_quant.cu`) over its own node records
  (`quant_records`: K1's, with the code bounds in a numeric node's first
  word) in K1's two modes. QW and K1's f16 mode make the same decisions
  over the same f16 leaves and agree bitwise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch

from ..binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..log import LightGBMError
from . import _build
from .histogram import widen_bins

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
    num_classes: int = 1          # K of an early-stop [K, T] stack
    # [T, M, 4] i32, K1's 16-byte node records (`node_records`); None
    # when the forest does not fit them (K1 refuses it by name)
    nodes: Optional[torch.Tensor] = None

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


# K1's 16-byte node record (csrc/forest_records.cuh): the threshold's f32
# bits, the feature in the low RECORD_FEATURE_BITS bits with the decision
# byte above them, the left child, the right child
RECORD_FEATURE_BITS = 24
RECORD_MAX_FEATURE = (1 << RECORD_FEATURE_BITS) - 1
# the kernel indexes a node as t * M + node in 32 bits
RECORD_MAX_NODES = 2 ** 31 - 1


def record_misfit(max_feature: int, num_trees: int,
                  max_nodes: int) -> Optional[str]:
    """Why a forest does not fit K1's node records, or None when it does:
    a feature index past RECORD_MAX_FEATURE, or more than
    RECORD_MAX_NODES padded nodes."""
    if max_feature > RECORD_MAX_FEATURE:
        return ("feature index %d does not fit the 16-byte node record "
                "(at most %d)" % (max_feature, RECORD_MAX_FEATURE))
    if num_trees * max_nodes > RECORD_MAX_NODES:
        return ("node count %d x %d does not fit the 16-byte node record "
                "(at most %d nodes)" % (num_trees, max_nodes,
                                        RECORD_MAX_NODES))
    return None


def node_records(split_feature: np.ndarray, threshold: np.ndarray,
                 decision: np.ndarray, left_child: np.ndarray,
                 right_child: np.ndarray) -> np.ndarray:
    """[T, M, 4] int32 node records from the stacked [T, M] arrays: the
    threshold's bits, feature | decision << 24, left, right. The caller
    has checked `record_misfit`."""
    packed = (split_feature.astype(np.int64)
              | (decision.astype(np.int64) << RECORD_FEATURE_BITS))
    return np.stack([threshold.astype(np.float32).view(np.int32),
                     packed.astype(np.uint32).view(np.int32),
                     left_child.astype(np.int32),
                     right_child.astype(np.int32)], axis=-1)


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
    nodes = None
    if record_misfit(int(arrays["split_feature"].max()), len(trees),
                     max_m) is None:
        nodes = torch.from_numpy(node_records(
            *[arrays[k] for k in ("split_feature", "threshold", "decision",
                                  "left_child", "right_child")])).to(device)
    return Forest(
        **{k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
        max_depth=max(_tree_depth(t) for t in trees),
        num_features=max(used, default=0), nodes=nodes)


def stack_trees_early_stop(models, k: int, t_iters: int,
                           device: torch.device) -> Forest:
    """The [K, T] stack of ES (`early_stop_stacks`, lightgbm_tpu/serving/
    forest.py:278-289): the first t_iters iterations of a model whose
    trees are stored iteration-major, class-minor, laid out class-major,
    tree (c, t) at c * t_iters + t."""
    trees = [models[t * k + c] for c in range(k) for t in range(t_iters)]
    return dataclasses.replace(stack_trees(trees, device), num_classes=k)


def _refuse_linear(linear: bool, layout: str) -> None:
    """The JAX package's refusal of quantized linear layouts
    (lightgbm_tpu/serving/forest.py:440-450, ops/predict.py:771-774)."""
    if linear:
        raise QuantRefused(
            "linear_tree leaf coefficients have no %s layout; predict "
            "linear forests with tpu_predict_quantize=none (f32)" % layout)


def to_f16(forest: Forest) -> Forest:
    """The f16 layout of `_stacks_to_f16` (lightgbm_tpu/serving/
    forest.py:429): the same stack with its f32 leaf values rounded to
    f16 (so f64 -> f32 -> f16, as the JAX package rounds them); the node
    arrays and records are the f32 stack's own tensors."""
    _refuse_linear(forest.linear_k > 0, "f16")
    return dataclasses.replace(
        forest, leaf_value=forest.leaf_value.to(torch.float16))


# max distinct thresholds per feature in the fixed-point layout: codes
# 1..K+1 plus the -1 missing sentinel (lightgbm_tpu/ops/predict.py:724)
QUANT_MAX_CODES = 255
# trees a batch of the quantized layouts' sums (predict_forest_quant and
# predict_forest_f16 `tree_batch`)
QUANT_TREE_BATCH = 10
_MISS_NAN_BIT, _MISS_ZERO_BIT = 1, 2


class QuantRefused(ValueError):
    """A forest that has no quantized layout: more distinct thresholds
    per feature than the code space holds (models binned past max_bin
    256), or linear leaves."""


@dataclass
class QuantForest:
    """The fixed-point layout of one class's trees (`QuantForest`,
    lightgbm_tpu/ops/predict.py:700): the walk stack with f16 leaves
    (categorical nodes keep their bitsets), per node the threshold's
    code and the lower code bound, and per feature the sorted grid of
    the forest's distinct f32 thresholds and its missing type."""
    walk: Forest                  # node arrays, f16 leaf values
    thr_code: torch.Tensor        # [T, M] i16: 1 + the threshold's grid index
    lo: torch.Tensor              # [T, M] i16: -2 default-left, else 0
    grid: torch.Tensor            # [F, K] f32 sorted bounds, +inf padded
    miss: Optional[torch.Tensor]  # [F] u8 bit0 NaN, bit1 zero; None: no
    #                               missing-typed numeric split
    # [T, M, 4] i32, QW's 16-byte node records (`quant_records`); None
    # when the forest does not fit them (QW refuses it by name)
    nodes: Optional[torch.Tensor] = None

    def nbytes(self) -> int:
        extra = [self.thr_code, self.lo, self.grid] + [
            t for t in (self.miss, self.nodes) if t is not None]
        return self.walk.nbytes() + sum(
            t.numel() * t.element_size() for t in extra)


def stack_trees_quant(trees, device: torch.device) -> QuantForest:
    """`stack_trees_quant` (lightgbm_tpu/ops/predict.py:760): per-feature
    sorted grids of the numeric nodes' f32 thresholds (each clipped to
    +-f32 max), thr_code = 1 + the threshold's index in its grid, lo = -2
    for a default-left node (so the -1 missing sentinel goes left) else
    0; categorical nodes are parked at thr_code 0 and decided by the
    bitset. The missing flags are kept only when a numeric split's
    feature carries a missing type. Raises QuantRefused past
    QUANT_MAX_CODES thresholds a feature and for linear leaves. The TPU
    layout's [T, M, L] path tensor and its memory budget are matmul
    matters; the port walks the trees."""
    _refuse_linear(any(t.is_linear for t in trees), "int8")
    fmax = np.finfo(np.float32).max
    grids: dict = {}
    miss: dict = {}
    n_feat = 1
    for t in trees:
        for i in range(max(t.num_leaves - 1, 0)):
            f = int(t.split_feature[i])
            n_feat = max(n_feat, f + 1)
            miss.setdefault(f, t.missing_type_node(i))
            if t.is_categorical_node(i):
                continue
            thr = np.float32(np.clip(t.threshold[i], -fmax, fmax))
            grids.setdefault(f, set()).add(float(thr))
    k_grid = max([len(v) for v in grids.values()] or [1])
    if k_grid > QUANT_MAX_CODES:
        raise QuantRefused(
            "int8 layout needs <= %d distinct split thresholds per "
            "feature; this forest uses %d (trained with max_bin > 256?)"
            % (QUANT_MAX_CODES, k_grid))
    grid = np.full((n_feat, k_grid), np.inf, np.float32)
    sorted_grids = {}
    for f, vals in grids.items():
        sv = np.sort(np.asarray(list(vals), np.float32))
        sorted_grids[f] = sv
        grid[f, :len(sv)] = sv
    walk = to_f16(stack_trees(trees, device))
    thr_code = np.zeros(tuple(walk.split_feature.shape), np.int16)
    lo = np.zeros_like(thr_code)
    for ti, t in enumerate(trees):
        for i in range(max(t.num_leaves - 1, 0)):
            if t.is_categorical_node(i):
                continue
            sv = sorted_grids[int(t.split_feature[i])]
            thr = np.float32(np.clip(t.threshold[i], -fmax, fmax))
            thr_code[ti, i] = 1 + int(np.searchsorted(sv, thr))
            lo[ti, i] = -2 if t.default_left_node(i) else 0
    has_special = any(mt != MISSING_NONE for f, mt in miss.items()
                      if f in grids)
    flags = np.zeros(n_feat, np.uint8)
    for f, mt in miss.items():
        flags[f] = (_MISS_NAN_BIT if mt == MISSING_NAN else 0) \
            | (_MISS_ZERO_BIT if mt == MISSING_ZERO else 0)
    nodes = None
    if walk.nodes is not None:
        nodes = torch.from_numpy(quant_records(
            walk.nodes.cpu().numpy(), thr_code, lo)).to(device)
    return QuantForest(
        walk=walk, thr_code=torch.from_numpy(thr_code).to(device),
        lo=torch.from_numpy(lo).to(device),
        grid=torch.from_numpy(grid).to(device),
        miss=torch.from_numpy(flags).to(device) if has_special else None,
        nodes=nodes)


def quant_records(nodes: np.ndarray, thr_code: np.ndarray,
                  lo: np.ndarray) -> np.ndarray:
    """QW's [T, M, 4] int32 node records: K1's records (`node_records`)
    with a numeric node's first word thr_code | lo << 16 (thr_code in the
    low 16 bits, lo sign-extended above them); a categorical node keeps
    its cat_idx's f32 bits, which the bitset test reads."""
    is_cat = ((nodes[..., 1].view(np.uint32) >> RECORD_FEATURE_BITS)
              & _CAT_BIT) != 0
    code = ((thr_code.astype(np.int32) & 0xFFFF)
            | (lo.astype(np.int32) << 16))
    out = nodes.copy()
    out[..., 0] = np.where(is_cat, nodes[..., 0], code)
    return out


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
def _go_left_plain(forest: Forest, node, fval, numeric=None):
    """`_decide_raw` over [T, N] node/value pairs; `numeric` [T, N], when
    given, decides the numeric nodes instead (QW's code compare)."""
    dec = forest.decision.gather(1, node)
    thr = forest.threshold.gather(1, node)
    fval = torch.where(fval.abs() < _F32_TINY, fval * 0.0, fval)
    is_nan = torch.isnan(fval)
    fsafe = torch.where(is_nan, 0.0, fval)
    if numeric is None:
        miss = (dec >> 2) & 3
        is_missing = (((miss == MISSING_NAN) & is_nan)
                      | ((miss == MISSING_ZERO)
                         & (is_nan | (fval.abs() <= K_ZERO_THRESHOLD))))
        numeric = torch.where(is_missing, (dec & _DEFAULT_LEFT_BIT) != 0,
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
    return torch.where(is_cat, cat_left, numeric)


def _leaves_plain(forest: Forest, x: torch.Tensor,
                  quant: Optional[Tuple[torch.Tensor, ...]] = None
                  ) -> torch.Tensor:
    """[T, N] int64 leaf index per (tree, row): every row descends every
    tree one level per step, for the forest's max depth. With `quant` =
    (thr_code, lo, codes), a numeric node goes left iff lo <= code <=
    thr_code."""
    n = x.shape[0]
    xt = x.t()
    node = torch.where(forest.num_leaves > 1, 0, -1).long()
    node = node[:, None].expand(-1, n).contiguous()
    split = forest.split_feature.long()
    left = forest.left_child.long()
    right = forest.right_child.long()
    codes_t = None if quant is None else quant[2].t()
    for _ in range(forest.max_depth):
        nd = node.clamp(min=0)
        feat = split.gather(1, nd)
        fval = xt.gather(0, feat)
        numeric = None
        if quant is not None:
            code = codes_t.gather(0, feat)
            numeric = ((quant[1].gather(1, nd) <= code)
                       & (code <= quant[0].gather(1, nd)))
        nxt = torch.where(_go_left_plain(forest, nd, fval, numeric),
                          left.gather(1, nd), right.gather(1, nd))
        node = torch.where(node >= 0, nxt, node)
    return ~node


def _tree_values_plain(forest: Forest, x: torch.Tensor,
                       leaf: torch.Tensor) -> torch.Tensor:
    """[T, N] f32: each tree's value for each row at its leaf (f16
    leaves widened), plus the leaf's linear term in a linear forest."""
    from .linear import gather_values, linear_dot_plain
    vals = forest.leaf_value.gather(1, leaf).float()
    if forest.linear_k:
        rows = torch.arange(x.shape[0], device=x.device)
        for t in range(forest.num_trees):
            xv, ok = gather_values(x, rows, forest.leaf_feat[t][leaf[t]])
            lin = linear_dot_plain(forest.leaf_coeff[t][leaf[t]], xv)
            vals[t] = vals[t] + torch.where(ok, lin, torch.zeros_like(lin))
    return vals


def _sum_trees_plain(vals: torch.Tensor, batch: int = 0) -> torch.Tensor:
    """[N] f32 sum over the tree axis of vals [T, N]: in tree order, or
    with `batch`, each batch of trees summed from 0 and then added."""
    out = torch.zeros(vals.shape[1], dtype=torch.float32,
                      device=vals.device)
    if not batch:
        for v in vals:
            out += v
        return out
    for b in range(0, vals.shape[0], batch):
        part = torch.zeros_like(out)
        for v in vals[b:b + batch]:
            part += v
        out += part
    return out


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
    in, so the two agree bitwise). An f16 forest sums in batches of
    QUANT_TREE_BATCH trees, as K1's f16 mode does."""
    vals = _tree_values_plain(forest, x, _leaves_plain(forest, x))
    out = _sum_trees_plain(vals, QUANT_TREE_BATCH
                           if forest.leaf_value.dtype == torch.float16
                           else 0)
    return out if transform is None else apply_output_plain(out, transform)


def forest_leaf_walk_plain(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """[N, T] i32 leaf index per (row, tree)."""
    return _leaves_plain(forest, x).t().to(torch.int32).contiguous()


def forest_early_stop_walk_plain(forest: Forest, x: torch.Tensor,
                                 margin: float, freq: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [K, N] f32, iters [N] i32) of ES: the JAX function's loop
    over iterations, adding where(active, value, 0) to the class sums
    and, after every freq-th iteration, keeping active the rows whose
    margin (2|sum| for K = 1, top-1 minus top-2 for K >= 2) is <= margin;
    iters counts the iterations a row walked."""
    k = forest.num_classes
    t_iters = forest.num_trees // k
    n = x.shape[0]
    vals = _tree_values_plain(forest, x, _leaves_plain(forest, x)).view(
        k, t_iters, n)
    acc = torch.zeros((k, n), dtype=torch.float32, device=x.device)
    active = torch.ones(n, dtype=torch.bool, device=x.device)
    iters = torch.zeros(n, dtype=torch.int32, device=x.device)
    limit = torch.tensor(margin, dtype=torch.float32, device=x.device)
    for t in range(t_iters):
        acc = acc + torch.where(active[None, :], vals[:, t], 0.0)
        iters += active.to(torch.int32)
        if (t + 1) % freq == 0:
            if k == 1:
                m = 2.0 * acc[0].abs()
            else:
                top = torch.topk(acc.t(), 2, dim=1).values
                m = top[:, 0] - top[:, 1]
            active = active & (m <= limit)
    return acc, iters


def quant_codes_plain(qf: QuantForest, x: torch.Tensor) -> torch.Tensor:
    """QC in torch ops: [N, F] int16, 1 + #{grid bounds < x} (both
    flushed to zero where subnormal, NaN taken as 0), -1 for a missing
    row of a missing-typed feature, 1 past the grid's features."""
    n, nf = x.shape
    fg = qf.grid.shape[0]
    codes = torch.ones((n, nf), dtype=torch.int16, device=x.device)
    nan = torch.isnan(x[:, :fg])
    clean = torch.where(nan, 0.0, x[:, :fg])
    clean = torch.where(clean.abs() < _F32_TINY, clean * 0.0, clean)
    grid = torch.where(qf.grid.abs() < _F32_TINY, qf.grid * 0.0, qf.grid)
    step = max(1, (1 << 24) // max(fg * grid.shape[1], 1))
    for i in range(0, n, step):
        above = clean[i:i + step, :, None] > grid[None]
        codes[i:i + step, :fg] = 1 + above.sum(-1).to(torch.int16)
    if qf.miss is not None:
        miss = qf.miss.long()
        special = (((miss & _MISS_NAN_BIT) != 0)[None, :] & nan) | (
            ((miss & _MISS_ZERO_BIT) != 0)[None, :]
            & (nan | (clean.abs() <= K_ZERO_THRESHOLD)))
        codes[:, :fg] = torch.where(special, -1, codes[:, :fg]).to(
            torch.int16)
    return codes


def forest_quant_walk_plain(qf: QuantForest, codes: torch.Tensor,
                            x: torch.Tensor,
                            transform: Optional[OutputTransform] = None
                            ) -> torch.Tensor:
    """QW in torch ops: the walk on the codes (categorical nodes on the
    raw rows), f16 leaves widened and summed in batches of
    QUANT_TREE_BATCH trees."""
    leaf = _leaves_plain(qf.walk, x, (qf.thr_code, qf.lo, codes))
    out = _sum_trees_plain(qf.walk.leaf_value.gather(1, leaf).float(),
                           QUANT_TREE_BATCH)
    return out if transform is None else apply_output_plain(out, transform)


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


def _check_leaf_type(forest: Forest, dtype: torch.dtype, name: str) -> None:
    if forest.leaf_value.dtype != dtype:
        raise LightGBMError("%s takes a forest of %s leaves (got %s)"
                            % (name, dtype, forest.leaf_value.dtype))


def _epilogue_args(transform: Optional[OutputTransform]) -> tuple:
    return (0, 1.0, 0.0, 1.0) if transform is None else (
        _EPILOGUE[transform.kind], float(transform.denom),
        float(transform.bias), float(transform.sigmoid))


def _launch(wrapper, entry: str, forest: Forest, x: torch.Tensor,
            extra: tuple, outs: tuple, library: str = "forest") -> None:
    """Launch one walk kernel on the current stream of x's device and
    count it; raises on any CUDA error the launch reports."""
    lib = _build.load_library(library)
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (
        forest.num_leaves, forest.split_feature, forest.threshold,
        forest.decision, forest.left_child, forest.right_child,
        forest.cat_boundaries, forest.cat_bitset, forest.leaf_value,
        forest.leaf_coeff, forest.leaf_feat)]
    args = (ctypes.c_void_p(x.data_ptr()), x.shape[0], x.shape[1], *ptr,
            forest.num_trees, forest.split_feature.shape[1],
            forest.leaf_value.shape[1], forest.cat_boundaries.shape[1],
            forest.cat_bitset.shape[1], forest.linear_k, *extra,
            *[ctypes.c_void_p(None if t is None else t.data_ptr())
              for t in outs])
    # no device switch when x's card is already the current one (a
    # served row's launch is mostly this host path)
    if torch.cuda.current_device() == x.device.index:
        rc = getattr(lib, entry)(
            *args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    else:
        with torch.cuda.device(x.device):
            rc = getattr(lib, entry)(*args, ctypes.c_void_p(
                torch.cuda.current_stream().cuda_stream))
    _count(wrapper, lib, entry, rc)


def _count(wrapper, lib, entry: str, rc: int) -> None:
    if rc != 0:
        raise LightGBMError("%s launch failed: CUDA error %d (%s)" % (
            entry, rc, lib.lgbt_error_string(rc).decode()))
    with _launch_lock:
        wrapper.launches += 1


# The launch plan of the record walks K1, K2, ES and QW
# (csrc/forest_records.cuh). Up to TREE_PARALLEL_MAX_ROWS rows a launch
# walks (row, tree) pairs, a block a row ("trees" mode); past it a block
# of ROWS_THREADS threads walks a row a thread through the forest's
# records, staged in shared memory a chunk of trees at a time ("rows"
# mode). The crossover, the threads and the chunk are measured on the
# card (PERF.md; QW's crossover too).
TREE_PARALLEL_MAX_ROWS = 32_768
ROWS_THREADS = 512
# one of the two record buffers of "rows" mode: 4 trees of 255 leaves
CHUNK_BYTES = 16_384
# trees a pass of "trees" mode (their values in shared memory, 4 B each)
# and its threads: more for a few rows, where one block's walk is the
# latency, fewer past PAIRS_WIDE_ROWS rows, where blocks share the SMs
PAIRS_CHUNK = 2048
PAIRS_WIDE_ROWS = 512
PAIRS_THREADS_FEW, PAIRS_THREADS_MANY = 512, 128
# K2's rows-mode tile: leaves a row it holds before the block writes
# them out (8 int32, a 32-byte sector), and at most this many trees a
# record chunk in leaf mode, so the tile stays a multiple of the chunk
LEAF_TILE_TREES = 8
# ES's rows mode: iterations a launch (a round; the rows still live at
# its end go on, compacted, to the next), the live rows at a round's
# start that its trees-mode tail takes on instead (a block a row, its
# trees in parallel, as trees mode does for as few rows), and its warp
# totals (csrc kMaxWarps)
ES_ROUND_ITERS = 80
ES_TAIL_ROWS = TREE_PARALLEL_MAX_ROWS
ES_MAX_WARPS = 16
# shared memory one block may use on an H100 (227 KB)
SHARED_BYTES = 232_448
RECORD_BYTES = 16
_MODES = {"trees": 0, "rows": 1}
_OUTPUTS = ("value", "leaf", "early_stop")


@dataclass(frozen=True)
class WalkPlan:
    """One launch of a record walk: its mode, threads a block, trees a
    chunk (rows mode: a shared record buffer's trees, 0 when one tree
    does not fit a buffer and the records are read from device memory;
    trees mode: the trees of one pass; ES counts iterations, K trees
    each, instead of trees), the row columns staged in shared memory
    (-1: rows read from device memory), the dynamic shared memory a
    block takes; for K2 in rows mode, the leaves a row its shared tile
    holds (0 otherwise)."""
    mode: str
    threads: int
    chunk_trees: int
    staged_features: int
    shared_bytes: int
    tile_trees: int = 0

    def args(self) -> tuple:
        return (_MODES[self.mode], self.threads, self.chunk_trees,
                self.staged_features, self.shared_bytes)


@dataclass(frozen=True)
class EarlyStopPlan(WalkPlan):
    """ES's launch: a WalkPlan whose chunk_trees counts iterations and,
    in rows mode, its rounds of round_iters iterations (a launch each)
    and the trees-mode tail that takes a round's rows on once at most
    tail_rows are live: tail_threads a block, tail_chunk iterations a
    pass (all 0 in trees mode)."""
    round_iters: int = 0
    tail_rows: int = 0
    tail_threads: int = 0
    tail_chunk: int = 0

    def rounds_args(self) -> tuple:
        return (self.round_iters, self.tail_rows, self.tail_threads,
                self.tail_chunk)


def staged_stride(threads: int, value_bytes: int) -> int:
    """Rows mode's staged row stride (csrc/forest_records.cuh): the
    threads + 1 for 4-byte values, + 2 for 2-byte ones."""
    return threads + (1 if value_bytes == 4 else 2)


def _pairs_threads(n: int) -> int:
    """Trees mode's threads a block for n rows, at most."""
    return PAIRS_THREADS_FEW if n <= PAIRS_WIDE_ROWS else PAIRS_THREADS_MANY


def _trees_threads(n: int, work: int) -> int:
    """Trees mode's threads a block for n rows and `work` trees a pass."""
    return min(_pairs_threads(n), -(-work // 32) * 32)


def walk_plan(num_trees: int, max_nodes: int, num_features: int, n: int,
              linear: bool = False, value_bytes: int = 4,
              output: str = "value", classes: int = 1) -> WalkPlan:
    """The plan of K1 (f32 values), QW (`value_bytes` 2: int16 codes), K2
    (`output` "leaf") or ES (`output` "early_stop" over a [classes, T /
    classes] stack) for n rows of a forest of num_trees trees padded to
    max_nodes nodes that reads num_features row columns; deterministic
    in its arguments, within SHARED_BYTES. A linear forest's rows mode
    stages nothing: its leaves read the row from device memory at every
    tree anyway, so the row's line is in L1 for the walk, and staging
    would only cost the block's occupancy (PERF.md). K2 reads no leaf
    value, so `linear` does not change its plan."""
    if output not in _OUTPUTS:
        raise LightGBMError("walk_plan: output %r is not one of %s"
                            % (output, _OUTPUTS))
    if output == "early_stop":
        return _early_stop_plan(num_trees, max_nodes, num_features, n,
                                linear, classes)
    leaf = output == "leaf"
    if n <= TREE_PARALLEL_MAX_ROWS:
        chunk = min(num_trees, PAIRS_CHUNK)
        return WalkPlan("trees", _trees_threads(n, chunk), chunk, -1,
                        0 if leaf else chunk * 4)
    if linear and not leaf:
        return WalkPlan("rows", ROWS_THREADS, 0, -1, 0)
    tree_bytes = max_nodes * RECORD_BYTES
    chunk = min(num_trees, CHUNK_BYTES // tree_bytes)
    tile, tile_smem = 0, 0
    if leaf:
        chunk = min(chunk, LEAF_TILE_TREES)
        tile = (chunk * (LEAF_TILE_TREES // chunk) if chunk
                else min(num_trees, LEAF_TILE_TREES))
        tile_smem = ROWS_THREADS * (tile + 1) * 4
    tree_smem = 2 * chunk * tree_bytes + tile_smem
    row_smem = num_features * staged_stride(ROWS_THREADS,
                                            value_bytes) * value_bytes
    if tree_smem + row_smem <= SHARED_BYTES:
        return WalkPlan("rows", ROWS_THREADS, chunk, num_features,
                        tree_smem + row_smem, tile)
    return WalkPlan("rows", ROWS_THREADS, chunk, -1, tree_smem, tile)


def _early_stop_plan(num_trees: int, max_nodes: int, num_features: int,
                     n: int, linear: bool, k: int) -> EarlyStopPlan:
    """ES's plan. Trees mode: a pass of as many iterations as the block
    has threads for their K trees, their values and the K sums in shared
    memory. Rows mode: rounds of ES_ROUND_ITERS iterations, one launch
    each, over the rows still live; chunks of as many iterations as one
    16 KB record buffer holds K trees of (0: the records read from device
    memory, a chunk of freq iterations); each row's K sums, id and two
    local list slots; the staged rows where they fit (nothing staged for
    a linear forest, K1's rule); and a tail that walks a round's rows in
    trees mode, with trees mode's plan for ES_TAIL_ROWS rows, once at
    most ES_TAIL_ROWS are live."""
    if not 1 <= k <= MAX_EARLY_STOP_CLASSES or num_trees % k:
        raise LightGBMError("walk_plan: %d trees are no [K, T] stack of "
                            "%d classes" % (num_trees, k))
    t_iters = num_trees // k
    if n <= TREE_PARALLEL_MAX_ROWS:
        chunk = max(1, min(t_iters, _pairs_threads(n) // k))
        return EarlyStopPlan("trees", _trees_threads(n, k * chunk), chunk,
                             -1, (k * chunk + k) * 4)
    tail = _early_stop_plan(num_trees, max_nodes, num_features,
                            min(ES_TAIL_ROWS, TREE_PARALLEL_MAX_ROWS),
                            linear, k)
    per_iter = k * max_nodes * RECORD_BYTES
    chunk = 0 if linear else min(t_iters, CHUNK_BYTES // per_iter)
    state = ROWS_THREADS * (k + 3) * 4 + ES_MAX_WARPS * 4
    tree_smem = 2 * chunk * per_iter + state
    row_smem = num_features * staged_stride(ROWS_THREADS, 4) * 4
    staged = not linear and tree_smem + row_smem <= SHARED_BYTES
    return EarlyStopPlan(
        "rows", ROWS_THREADS, chunk, num_features if staged else -1,
        tree_smem + (row_smem if staged else 0),
        round_iters=min(t_iters, ES_ROUND_ITERS), tail_rows=ES_TAIL_ROWS,
        tail_threads=tail.threads, tail_chunk=tail.chunk_trees)


def _check_records(forest: Forest, name: str) -> None:
    if forest.nodes is None:
        raise LightGBMError("%s: %s" % (name, record_misfit(
            int(forest.split_feature.max()), forest.num_trees,
            int(forest.split_feature.shape[1]))
            or "the forest has no node records (stack it with stack_trees)"))


def _value_walk(wrapper, forest: Forest, x: torch.Tensor,
                transform: Optional[OutputTransform], f16: bool
                ) -> torch.Tensor:
    """Launch K1 (f16 leaves when `f16`) on the CUDA rows x under its
    `walk_plan`; counts the launch, and a rows-mode one also in
    `wrapper.launches_rows`."""
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0]:
        plan = walk_plan(forest.num_trees, forest.split_feature.shape[1],
                         forest.num_features, x.shape[0],
                         forest.linear_k > 0)
        _launch(wrapper, "lgbt_forest_value_walk", forest, x,
                (ctypes.c_void_p(forest.nodes.data_ptr()),) + plan.args()
                + (int(f16), QUANT_TREE_BATCH) + _epilogue_args(transform),
                (out,))
        if plan.mode == "rows":
            with _launch_lock:
                wrapper.launches_rows += 1
    return out


def forest_value_walk(forest: Forest, x: torch.Tensor,
                      transform: Optional[OutputTransform] = None
                      ) -> torch.Tensor:
    """K1: [N] f32 raw score (or, with `transform`, the converted
    output) of the forest on rows x [N, F]."""
    _check_records(forest, "forest_value_walk")
    _check_inputs(forest, x)
    _check_leaf_type(forest, torch.float32, "forest_value_walk")
    if x.device.type == "cpu":
        return forest_value_walk_plain(forest, x, transform)
    return _value_walk(forest_value_walk, forest, x, transform, False)


def forest_value_walk_f16(forest: Forest, x: torch.Tensor,
                          transform: Optional[OutputTransform] = None
                          ) -> torch.Tensor:
    """K1's f16-leaf mode: [N] f32 raw score (or converted output) of an
    f16 forest (`to_f16`), summed in batches of QUANT_TREE_BATCH trees."""
    _check_records(forest, "forest_value_walk_f16")
    _check_inputs(forest, x)
    _check_leaf_type(forest, torch.float16, "forest_value_walk_f16")
    _refuse_linear(forest.linear_k > 0, "f16")
    if x.device.type == "cpu":
        return forest_value_walk_plain(forest, x, transform)
    return _value_walk(forest_value_walk_f16, forest, x, transform, True)


def forest_leaf_walk(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """K2: [N, T] i32 leaf index per (row, tree), walked over the
    forest's node records in K1's two modes (`walk_plan(...,
    output="leaf")`); a rows-mode launch also counts in
    `forest_leaf_walk.launches_rows`."""
    _check_records(forest, "forest_leaf_walk")
    _check_inputs(forest, x)
    if x.device.type == "cpu":
        return forest_leaf_walk_plain(forest, x)
    out = torch.empty((x.shape[0], forest.num_trees), dtype=torch.int32,
                      device=x.device)
    if x.shape[0]:
        plan = walk_plan(forest.num_trees, forest.split_feature.shape[1],
                         forest.num_features, x.shape[0], output="leaf")
        _launch(forest_leaf_walk, "lgbt_forest_leaf_walk", forest, x,
                (ctypes.c_void_p(forest.nodes.data_ptr()),) + plan.args()
                + (plan.tile_trees,), (out,))
        if plan.mode == "rows":
            with _launch_lock:
                forest_leaf_walk.launches_rows += 1
    return out


#: the widest [K, T] stack ES takes (its per-row class sums;
#: csrc/forest_records.cuh kMaxClasses)
MAX_EARLY_STOP_CLASSES = 32


def forest_early_stop_walk(forest_kt: Forest, x: torch.Tensor,
                           margin: float, freq: int,
                           return_iters: bool = False):
    """ES: [K, N] f32 raw scores of a [K, T] stack
    (`stack_trees_early_stop`) with per-row early stop after every
    `freq`-th iteration at `margin`; with `return_iters`, also the [N]
    i32 iterations each row walked. Walked over the stack's node records
    (`walk_plan(..., output="early_stop")`); a rows-mode launch also
    counts in `forest_early_stop_walk.launches_rows`."""
    _check_records(forest_kt, "forest_early_stop_walk")
    _check_inputs(forest_kt, x)
    _check_leaf_type(forest_kt, torch.float32, "forest_early_stop_walk")
    k = forest_kt.num_classes
    if not 1 <= k <= MAX_EARLY_STOP_CLASSES \
            or forest_kt.num_trees % k:
        raise LightGBMError(
            "forest_early_stop_walk takes a [K, T] stack of 1 to %d "
            "classes (got %d classes over %d trees)"
            % (MAX_EARLY_STOP_CLASSES, k, forest_kt.num_trees))
    if int(freq) < 1:
        raise LightGBMError("pred_early_stop_freq must be >= 1 (got %r)"
                            % freq)
    if x.device.type == "cpu":
        out, iters = forest_early_stop_walk_plain(forest_kt, x, margin,
                                                  int(freq))
    else:
        out = torch.empty((k, x.shape[0]), dtype=torch.float32,
                          device=x.device)
        iters = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
        if x.shape[0]:
            plan = walk_plan(forest_kt.num_trees,
                             forest_kt.split_feature.shape[1],
                             forest_kt.num_features, x.shape[0],
                             forest_kt.linear_k > 0, output="early_stop",
                             classes=k)
            scratch = None
            if plan.mode == "rows":
                # two lists of row ids and a count a round
                scratch = torch.empty(2 * x.shape[0] + -(-(
                    forest_kt.num_trees // k) // plan.round_iters),
                    dtype=torch.int32, device=x.device)
            _launch(forest_early_stop_walk, "lgbt_forest_early_stop_walk",
                    forest_kt, x,
                    (ctypes.c_void_p(forest_kt.nodes.data_ptr()),)
                    + plan.args() + plan.rounds_args()
                    + (k, float(margin), int(freq)),
                    (out, iters, scratch))
            if plan.mode == "rows":
                with _launch_lock:
                    forest_early_stop_walk.launches_rows += 1
    return (out, iters) if return_iters else out


# QC's library, looked up once (the wrapper's host path is most of a
# call's time at the main path's 262,144 rows), and its cells a call
# (csrc/forest_quant.cu kMaxCells: 32-bit cell indices)
_quant_lib = None
QUANT_MAX_CELLS = 2 ** 32 - 256


def quant_codes(qf: QuantForest, x: torch.Tensor) -> torch.Tensor:
    """QC: the [N, F] int16 codes of rows x [N, F] against the fixed-point
    layout's grids."""
    global _quant_lib
    _check_inputs(qf.walk, x)
    if x.device.type == "cpu":
        return quant_codes_plain(qf, x)
    if x.numel() >= QUANT_MAX_CELLS:
        raise LightGBMError("quant_codes takes fewer than %d cells a call "
                            "(got %d)" % (QUANT_MAX_CELLS, x.numel()))
    codes = torch.empty(tuple(x.shape), dtype=torch.int16, device=x.device)
    if x.numel():
        if _quant_lib is None:
            _quant_lib = _build.load_library("quant")
        fn = _quant_lib.lgbt_quant_codes
        miss = None if qf.miss is None else qf.miss.data_ptr()
        args = (x.data_ptr(), x.shape[0], x.shape[1], qf.grid.data_ptr(),
                qf.grid.shape[0], qf.grid.shape[1], miss, codes.data_ptr())
        # no device switch when x's card is already the current one
        if torch.cuda.current_device() == x.device.index:
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(x.device):
                rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        _count(quant_codes, _quant_lib, "lgbt_quant_codes", rc)
    return codes


def forest_quant_walk(qf: QuantForest, codes: torch.Tensor, x: torch.Tensor,
                      transform: Optional[OutputTransform] = None
                      ) -> torch.Tensor:
    """QW: [N] f32 raw score (or converted output) of the fixed-point
    layout on rows x [N, F] and their codes [N, F] (`quant_codes`),
    walked over its node records (`quant_records`) in K1's two modes
    (`walk_plan` with 2-byte values); a rows-mode launch also counts in
    `forest_quant_walk.launches_rows`."""
    _check_records(qf.walk, "forest_quant_walk")
    _check_inputs(qf.walk, x)
    if codes.shape != x.shape or codes.dtype != torch.int16 \
            or codes.device != x.device or not codes.is_contiguous():
        raise LightGBMError("forest_quant_walk takes the rows' contiguous "
                            "int16 codes of the same shape")
    if x.device.type == "cpu":
        return forest_quant_walk_plain(qf, codes, x, transform)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0]:
        walk = qf.walk
        plan = walk_plan(walk.num_trees, walk.split_feature.shape[1],
                         walk.num_features, x.shape[0], value_bytes=2)
        p = ctypes.c_void_p
        _launch(forest_quant_walk, "lgbt_forest_quant_walk", walk, x,
                (p(qf.nodes.data_ptr()), p(codes.data_ptr()))
                + plan.args() + (QUANT_TREE_BATCH,)
                + _epilogue_args(transform), (out,), library="quant")
        if plan.mode == "rows":
            with _launch_lock:
                forest_quant_walk.launches_rows += 1
    return out


quant_codes.launches = 0
for _walk in (forest_value_walk, forest_value_walk_f16, forest_leaf_walk,
              forest_early_stop_walk, forest_quant_walk):
    _walk.launches = 0
    # of those, the launches in "rows" mode (the rest walked trees mode)
    _walk.launches_rows = 0
del _walk


# ----------------------------------------------------------------------
# W: one tree in bin space
# the tree's own bin-space fields, int32 each, as the plain version reads
# them (_decide_binned's inputs)
_NODE_FIELDS = ("node_group", "node_offset", "node_num_bin", "node_bundled",
                "node_default_bin", "node_nan_bin", "node_missing",
                "threshold_in_bin", "flags", "left_child", "right_child")

# csrc/binned_walk.cu's 16-byte record (walk_records): x the group and
# four flags, y lo | span << 16, z the test, w the children as int16
WALK_GROUP_BITS = 28
WALK_CAT = 1 << 31
WALK_DEFAULT_LEFT = 1 << 30
WALK_OUT_LEFT = 1 << 29
WALK_NONE_LEFT = 1 << 28
# the same bit on a categorical node: its bitset word is z itself
WALK_INLINE = WALK_NONE_LEFT
# children are int16: nodes 0..32766, leaves ~0..~32767
WALK_MAX_NODES = 32767
# a tree's records and bitsets up to this many bytes are staged in each
# block's shared memory (255 leaves: 4 KB); larger trees are read from
# device memory
WALK_TREE_SMEM_BYTES = 64 * 1024
# rows wider than this are walked column-major on the card (walk_layout):
# Bosch's 676 bytes; HIGGS' 28 and the categorical protocol's 40 stay
# row-major
WALK_COLUMN_ROW_BYTES = 64


@dataclass
class BinnedTree:
    """One tree as the bin-space walk reads it: the kernel's 16-byte
    records [max(L-1, 0), 4] and their re-based bitsets (`walk_records`),
    and beside them the tree's own fields for the plain version: [max(L-1,
    1), 11] int32 (see _NODE_FIELDS; flags = default_left | categorical
    << 1) and its bin-space bitsets; f32 leaf values. All are views of one
    device buffer, uploaded in one copy (`binned_tree`)."""
    recs: torch.Tensor          # [max(L-1, 0), 4] i32
    bits: torch.Tensor          # [B] i32 holding u32 words
    nodes: torch.Tensor         # [max(L-1, 1), 11] i32
    cat_bounds: torch.Tensor    # [C+2] i32
    cat_bits: torch.Tensor      # [W] i32 holding u32 words
    leaf_value: torch.Tensor    # [L] f32
    num_leaves: int
    categorical: bool = False   # a node splits on a categorical feature


def _tree_fields(tree) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain version's inputs: the [max(L-1, 1), 11] fields, the
    bitset bounds padded by two copies of the last, and the bitset words
    (one zero word where there are none)."""
    m = max(tree.num_leaves - 1, 0)
    rec = np.zeros((max(m, 1), len(_NODE_FIELDS)), np.int32)
    dt = np.asarray(tree.decision_type[:m], np.int64)
    for j, name in enumerate(_NODE_FIELDS):
        if name == "flags":
            col = ((dt & _DEFAULT_LEFT_BIT) != 0) | (((dt & _CAT_BIT) != 0)
                                                     << 1)
        elif name == "node_missing":
            col = (dt >> 2) & 3
        else:
            col = np.asarray(getattr(tree, name))[:m]
        rec[:m, j] = np.asarray(col, np.int64)
    bounds = np.asarray(tree.cat_boundaries_inner, np.int32)
    bounds = np.concatenate([bounds, np.full(2, bounds[-1], np.int32)])
    bits = np.asarray(tree.cat_threshold_inner, np.uint32)
    if bits.size == 0:
        bits = np.zeros(1, np.uint32)
    return rec, bounds, bits


def walk_records(tree) -> Tuple[np.ndarray, np.ndarray]:
    """W's records of a tree with bin metadata: ([max(L-1, 0), 4] int32,
    [B] uint32 bitset words), each node's EFB decode and decision folded
    into group-bin space (csrc/binned_walk.cu says how a record decides;
    `walk_decide` replays it). A tree of more than WALK_MAX_NODES nodes
    or a group index past 2^28 is refused by name."""
    m = max(tree.num_leaves - 1, 0)
    if m > WALK_MAX_NODES:
        raise LightGBMError(
            "the binned walk takes trees of at most %d leaves (got %d)"
            % (WALK_MAX_NODES + 1, tree.num_leaves))
    i64 = lambda a: np.asarray(a, np.int64)[:m]  # noqa: E731
    group, off, nb = (i64(tree.node_group), i64(tree.node_offset),
                      i64(tree.node_num_bin))
    dflt, nanb, thr = (i64(tree.node_default_bin), i64(tree.node_nan_bin),
                       i64(tree.threshold_in_bin))
    bundled = np.asarray(tree.node_bundled, bool)[:m]
    dt = i64(tree.decision_type)
    cat = (dt & _CAT_BIT) != 0
    dl = (dt & _DEFAULT_LEFT_BIT) != 0
    miss = (dt >> 2) & 3
    if m and (group.min() < 0 or group.max() >= 1 << WALK_GROUP_BITS):
        raise LightGBMError("the binned walk takes group indices below 2^%d"
                            % WALK_GROUP_BITS)
    lo = np.where(bundled, off, 0)
    # the decision at the feature's default bin: out of a bundled node's
    # range the decode gives that bin
    _, bounds, cbits = _tree_fields(tree)
    idx = np.clip(np.maximum(thr, 0), 0, bounds.shape[0] - 2)
    wlo = bounds[idx].astype(np.int64)
    nwords = bounds[idx + 1].astype(np.int64) - wlo
    dw = dflt >> 5
    dword = cbits[np.clip(wlo + dw, 0, cbits.shape[0] - 1)].astype(np.int64)
    cat_at_default = ((dflt >= 0) & (dw < nwords)
                      & (((dword >> (dflt & 31)) & 1) == 1))
    missing_at_default = (((miss == MISSING_NAN) & (dflt == nanb))
                          | (miss == MISSING_ZERO))
    num_at_default = np.where(missing_at_default, dl, dflt <= thr)
    out_left = bundled & np.where(cat, cat_at_default, num_at_default)
    # in range: a bundled feature's slice; all of an unbundled numeric
    # one; an unbundled categorical one's words (no bin past them is in
    # its set)
    span = np.where(bundled, np.maximum(nb - 1, 0),
                    np.where(cat, np.minimum(32 * np.maximum(nwords, 1),
                                             1 << 16) - 1, 0xFFFF))
    # numeric: the missing bin s, and left when r <= t
    s = np.where(miss == MISSING_NAN, nanb, dflt)
    has_s = (((miss == MISSING_NAN) | (miss == MISSING_ZERO))
             & (s >= 0) & (s <= span))
    none_left = ~cat & (thr < 0)
    t = np.clip(thr, 0, 0xFFFF)
    dl_eff = np.where(has_s, dl, ~none_left)   # the normal decision at r 0
    z = np.where(has_s, s, 0) << 16 | t
    # categorical: the node's words re-based to its range, zero-padded;
    # a range of at most 32 bins keeps its one word in z (WALK_INLINE)
    def word(at, j):
        w = cbits[np.clip(wlo[at] + j, 0, cbits.shape[0] - 1)]
        return np.where(j < nwords[at], w.astype(np.int64), 0)

    inline = cat & (span < 32)
    at = np.flatnonzero(inline)
    z[at] = word(at, 0)
    at = np.flatnonzero(cat & ~inline)
    need = (span[at] >> 5) + 1
    start = np.cumsum(need) - need
    z[at] = start
    owner = np.repeat(at, need)
    bits = word(owner, np.arange(int(need.sum())) - np.repeat(start, need))
    bits = bits.astype(np.uint32) if bits.size else np.zeros(1, np.uint32)
    x = (group | cat.astype(np.int64) << 31
         | (~cat & dl_eff).astype(np.int64) << 30
         | out_left.astype(np.int64) << 29
         | (none_left | inline).astype(np.int64) << 28)
    y = lo | span << 16
    lc, rc = i64(tree.left_child), i64(tree.right_child)
    w = (lc & 0xFFFF) | (rc & 0xFFFF) << 16
    recs = np.stack([x, y, z, w], 1).astype(np.uint32).view(np.int32)
    return recs.reshape(m, 4), bits.astype(np.uint32)


def walk_decide(recs: np.ndarray, bits: np.ndarray, node: np.ndarray,
                b: np.ndarray) -> np.ndarray:
    """[K] bool: which way record `node` sends group bin `b`, replayed in
    numpy as csrc/binned_walk.cu's goes_left decides."""
    rec = recs.view(np.uint32).astype(np.int64)[node]
    x, y, z = rec[..., 0], rec[..., 1], rec[..., 2]
    r = (np.asarray(b, np.int64) - (y & 0xFFFF)) & 0xFFFFFFFF
    at = np.clip(z + (r >> 5), 0, bits.shape[0] - 1)
    word = np.where((x & WALK_INLINE) != 0, z, bits.astype(np.int64)[at])
    cat = ((word >> (r & 31)) & 1) == 1
    num = np.where(r == z >> 16, (x & WALK_DEFAULT_LEFT) != 0,
                   (r <= (z & 0xFFFF)) & ((x & WALK_NONE_LEFT) == 0))
    inside = np.where((x & WALK_CAT) != 0, cat, num)
    return np.where(r > y >> 16, (x & WALK_OUT_LEFT) != 0, inside)


def walk_leaves_replay(recs: np.ndarray, bits: np.ndarray,
                       binned: np.ndarray) -> np.ndarray:
    """[N] int32 leaf of each row of binned [N, G], replaying W's walk
    over its records in numpy, a level of all rows a step."""
    n = binned.shape[0]
    node = np.full(n, 0 if recs.shape[0] else -1, np.int64)
    rows = np.arange(n)
    kids = recs.view(np.uint32)[:, 3].astype(np.uint32)
    left_of = kids.astype(np.uint16).view(np.int16).astype(np.int64)
    right_of = (kids >> 16).astype(np.uint16).view(np.int16).astype(
        np.int64)
    groups = recs.view(np.uint32)[:, 0].astype(np.int64) & (
        (1 << WALK_GROUP_BITS) - 1)
    while (node >= 0).any():
        live = np.flatnonzero(node >= 0)
        nd = node[live]
        b = binned[rows[live], groups[nd]].astype(np.int64)
        left = walk_decide(recs, bits, nd, b)
        node[live] = np.where(left, left_of[nd], right_of[nd])
    return (~node).astype(np.int32)


def binned_tree(tree, device: torch.device,
                leaf_value: Optional[np.ndarray] = None) -> BinnedTree:
    """A host Tree (with bin metadata) laid out for W; `leaf_value`
    overrides the tree's own (rollback adds the negated values). A
    linear tree's values are its intercepts: W's leaf mode serves it.
    The records, the plain version's fields and the values go up in one
    copy."""
    if not tree.has_bin_metadata:
        raise LightGBMError("the binned walk needs a tree with bin "
                            "metadata (Tree.attach_bin_metadata)")
    values = np.ascontiguousarray(tree.leaf_value if leaf_value is None
                                  else leaf_value, np.float32)
    m = max(tree.num_leaves - 1, 0)
    recs, bits = walk_records(tree)
    fields_, bounds, cbits = _tree_fields(tree)
    parts = [recs.ravel(), bits.view(np.int32), fields_.ravel(), bounds,
             cbits.view(np.int32), values.view(np.int32)]
    buf = torch.from_numpy(np.concatenate(parts)).to(device)
    views, at = [], 0
    for p in parts:
        views.append(buf[at:at + p.size])
        at += p.size
    out = BinnedTree(
        recs=views[0].view(m, 4), bits=views[1],
        nodes=views[2].view(fields_.shape), cat_bounds=views[3],
        cat_bits=views[4], leaf_value=views[5].view(torch.float32),
        num_leaves=int(tree.num_leaves),
        categorical=bool(((np.asarray(tree.decision_type[:m]) & _CAT_BIT)
                          != 0).any()))
    return out


def binned_walk_smem(num_rec: int, num_bits: int) -> int:
    """W's dynamic shared memory for a tree of `num_rec` records and
    `num_bits` bitset words: the tree staged in each block, or 0 (read
    from device memory) past WALK_TREE_SMEM_BYTES."""
    tree_bytes = -(-(num_rec * 16 + num_bits * 4) // 16) * 16
    return tree_bytes if tree_bytes <= WALK_TREE_SMEM_BYTES else 0


def walk_by_columns(binned: torch.Tensor) -> bool:
    """Whether W walks `binned` [N, G] best column-major: on the card,
    rows wider than WALK_COLUMN_ROW_BYTES. There the lanes of a warp at
    one node read one group's bins of consecutive rows, where a row-major
    row costs a sector a level; a narrower row is one or two sectors that
    stay in L1 for the whole walk (csrc/binned_walk.cu)."""
    return (binned.device.type == "cuda" and binned.shape[1]
            * binned.element_size() > WALK_COLUMN_ROW_BYTES)


def walk_layout(binned: torch.Tensor) -> torch.Tensor:
    """A matrix of bins [N, G] as W walks it best: a column-major copy
    (the [N, G] view of a contiguous [G, N] tensor) where
    `walk_by_columns`, else the matrix as it is."""
    return binned.t().contiguous().t() if walk_by_columns(binned) \
        else binned


def tree_leaf_binned_plain(tree: BinnedTree,
                           binned: torch.Tensor) -> torch.Tensor:
    """[N] int64 leaf of each row: every row descends one level a step
    while any row is at a node (`predict_leaf_binned`)."""
    n = binned.shape[0]
    node = torch.full((n,), 0 if tree.num_leaves > 1 else -1,
                      dtype=torch.long, device=binned.device)
    rec = tree.nodes.long()
    f = {name: rec[:, j] for j, name in enumerate(_NODE_FIELDS)}
    rows = torch.arange(n, device=binned.device)
    # the card indexes no uint16 tensor
    wide = widen_bins(binned) if binned.is_cuda else binned
    while bool((node >= 0).any()):
        nd = node.clamp(min=0)
        b = wide[rows, f["node_group"][nd]].long()
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
    [N, G] (any strides: row-major, or column-major as `walk_layout`
    lays it out), in place."""
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
            out, tree.recs, tree.leaf_value)):
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
    u16 = binned.dtype == torch.uint16
    if binned.dtype not in (torch.uint8, torch.uint16) or min(
            binned.stride()) < 0 or not out.is_contiguous():
        raise LightGBMError("tree_value_walk_binned takes uint8 or uint16 "
                            "bins and a contiguous score")
    lib = _build.load_library("walk")
    p = ctypes.c_void_p
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        rc = lib.lgbt_tree_value_walk_binned(
            p(binned.data_ptr()), binned.stride(0), binned.stride(1),
            int(u16), binned.shape[0], p(tree.recs.data_ptr()),
            tree.recs.shape[0], p(tree.bits.data_ptr()), tree.bits.shape[0],
            binned_walk_smem(tree.recs.shape[0], tree.bits.shape[0]),
            p(tree.leaf_value.data_ptr()),
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
        if u16:
            counter.launches_u16 += 1
        if tree.categorical:
            counter.launches_cat += 1


tree_value_walk_binned.launches = 0
tree_value_walk_binned.launches_u16 = 0
tree_value_walk_binned.launches_cat = 0
tree_leaf_walk_binned.launches = 0
tree_leaf_walk_binned.launches_u16 = 0
tree_leaf_walk_binned.launches_cat = 0
