"""Kernel LS's launch plan and the order of its block mode
(lightgbm_tpu_torch/ops/linear.py `solve_plan`, `linear_solve_plain`),
on the CPU at fixture scale.

LS solves each leaf's d x d system (d = k + 1) in one of two modes by d
alone: a lane a row with the system in registers up to
`LS_REGS_MAX_D`, a block a leaf past it. The block mode pivots through a
permutation of row slots and picks the pivot as the largest key (|a|'s
bits, every NaN one value above +inf; ~row below them); `block_replay`
walks that design in numpy f32 and is held bitwise to the plain version
on ties, NaN, inf, singular, under-populated and padded leaves. The plain
version is held to the JAX package's `fit_leaves` on rows built for each
of those cases: fitted flags exactly, leaves and coefficients within
TOL_LEAF = 1e-4 * max(1, |ref|) (tests/test_torch_linear_train.py's
tolerance; LAPACK's sgetrf orders its updates otherwise). Inputs are made
with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.linear.solver import fit_leaves as jax_fit
from lightgbm_tpu_torch.ops import linear

torch.set_num_threads(1)

#: the most dynamic shared memory a block takes on an H100
SMEM_LIMIT = 227 * 1024
TOL_LEAF = 1e-4
#: widths: the register mode's last, the block mode's first, and one past
#: 48 KB of shared memory
WIDTHS = [linear.LS_REGS_MAX_D - 1, linear.LS_REGS_MAX_D, 120]
CASES = ["tie", "constant_feature", "under_populated", "padded",
         "non_finite"]


@pytest.mark.parametrize("k", range(1, 201))
def test_the_plan_picks_the_mode_by_width_and_fits_shared_memory(k):
    p = linear.solve_plan(k)
    d = k + 1
    assert p["threads"] % 32 == 0
    assert p["smem"] <= SMEM_LIMIT and p["sys_words"] == 0
    if d <= linear.LS_REGS_MAX_D:
        assert p["mode"] == "regs" and p["smem"] == 0
        assert p["threads"] == linear.LS_REGS_THREADS
        # a lane a row: a power-of-two segment of a warp's lanes a leaf
        lanes = p["lanes"]
        assert d <= lanes <= 32 and lanes & (lanes - 1) == 0
        assert lanes == 2 or lanes < 2 * d
    else:
        assert p["mode"] == "block"
        assert 128 <= p["threads"] <= 512 and p["stride"] % 2 == 1
        assert p["stride"] >= d + 1
        # [A | rhs], two buffers of multipliers and two of row slots
        assert p["smem"] == d * p["stride"] * 4 + 4 * d * 4


@pytest.mark.parametrize("k", [237, 238, 300, 4094])
def test_past_shared_memory_the_system_goes_to_a_global_scratch(k):
    p = linear.solve_plan(k)
    d = k + 1
    in_smem = d * p["stride"] * 4 + 16 * d <= SMEM_LIMIT
    assert p["mode"] == "block" and p["smem"] <= SMEM_LIMIT
    assert p["sys_words"] == (0 if in_smem else d * p["stride"])
    assert in_smem == (k == 237)


def pivot_key(v):
    a = np.abs(np.float32(v))
    return 0x7FC00000 if np.isnan(a) else int(a.view(np.uint32))


def block_replay(a_sum, b_sum, cnt, feats, const, lam):
    """The block mode in numpy f32: logical row i in row slot[i]; step c
    updates column c + 1 (column c's multipliers), picks its pivot as
    the largest (key, ~row) and swaps two slots; then the multipliers,
    one division a row; back-substitution a row at a time, one division
    a column."""
    num_leaves, d = b_sum.shape
    k = d - 1
    f32 = np.float32
    value = np.zeros(num_leaves, f32)
    coeff = np.zeros((num_leaves, k), f32)
    fitted = np.zeros(num_leaves, bool)
    with np.errstate(all="ignore"):
        for leaf in range(num_leaves):
            enough = cnt[leaf] >= f32(2 * d)
            m = np.zeros((d, d + 1), f32)
            a = a_sum[leaf].copy()
            for i in range(k):
                a[i, i] = a[i, i] + (f32(1) if feats[leaf, i] < 0
                                     else f32(lam))
            m[:, :d] = a if enough else np.eye(d, dtype=f32)
            m[:, d] = -b_sum[leaf]
            slot = np.arange(d)
            mult = np.zeros(d, f32)
            for c in range(-1, d - 1):
                col = c + 1
                if c >= 0:
                    rows = slot[col:]
                    m[rows, col:] = m[rows, col:] - mult[col:, None] \
                        * m[slot[c], col:]
                keys = [(pivot_key(m[slot[i], col]) << 32)
                        | (0xFFFFFFFF - i) for i in range(col, d)]
                p = 0xFFFFFFFF - (max(keys) & 0xFFFFFFFF)
                slot[[col, p]] = slot[[p, col]]
                mult = np.zeros(d, f32)
                mult[col + 1:] = m[slot[col + 1:], col] / m[slot[col], col]
            for j in reversed(range(d)):
                x = m[slot[j], d] / m[slot[j], j]
                m[slot[j], d] = x
                m[slot[:j], d] = m[slot[:j], d] - x * m[slot[:j], j]
            beta = m[slot, d]
            fin = bool(enough and np.isfinite(beta).all())
            fitted[leaf] = fin
            value[leaf] = beta[k] if fin else const[leaf]
            coeff[leaf] = np.where(fin & (feats[leaf] >= 0), beta[:k], 0)
    return value, coeff, fitted


def systems(k, num_leaves, seed):
    """Seeded [L, d, d] normal equations of 3d rows each, b, cnt, feats
    and constants, with the edge cases of the card's check built in."""
    rs = np.random.RandomState(seed)
    d = k + 1
    n = 3 * d
    z = rs.randn(num_leaves, n, d).astype(np.float32)
    z[:, :, k] = 1.0
    h = (rs.rand(num_leaves, n) + 0.5).astype(np.float32)
    a = np.einsum("lni,lnj->lij", z * h[:, :, None], z).astype(np.float32)
    b = np.einsum("lni,ln->li", z, rs.randn(num_leaves, n)).astype(
        np.float32)
    cnt = np.full(num_leaves, float(n), np.float32)
    feats = rs.randint(0, 70, (num_leaves, k)).astype(np.int32)
    const = rs.randn(num_leaves).astype(np.float32)
    top = float(np.abs(a).max()) * 4
    a[0, 1, 0] = a[0, 2, 0] = top         # a tie, the first row wins
    a[1, 1, 0], a[1, 2, 0] = -top, top    # a tie of opposite signs
    a[2, 1, 1] = np.nan                   # NaN and inf entries
    a[3, 0, 0] = np.inf
    a[4, 2, :] = 0.0                      # a zero slope row and column
    a[4, :, 2] = 0.0
    a[5, 0, 0] = a[5, 2, 0] = np.nan      # two NaN in a pivot column
    b[6, 1] = np.nan
    cnt[7] = float(2 * d - 1)             # under-populated
    feats[8, k // 2:] = -1                # padded slots
    return a, b, cnt, feats, const


@pytest.mark.parametrize("lam", [0.0, 0.01])
@pytest.mark.parametrize("k", [3, 5, linear.LS_REGS_MAX_D, 16, 64])
def test_the_block_modes_order_is_bitwise_the_plain_version(k, lam):
    args = systems(k, 12, seed=k)
    got = block_replay(*args, lam)
    ref = [t.numpy() for t in linear.linear_solve_plain(
        *(torch.from_numpy(t) for t in args), lam)]
    assert np.array_equal(got[2], ref[2])
    for u, v in zip(got[:2], ref[:2]):
        assert np.array_equal(u.view(np.int32), v.view(np.int32))
    # NaN reaches every leaf but 3's (an inf pivot gives a zero
    # multiplier); the zero slope row is singular at lambda 0
    assert not got[2][[2, 5, 6, 7]].any() and got[2][[0, 1, 8]].all()
    assert got[2][4] == (lam > 0)


def fit_rows(k, case, seed=0):
    """Rows of 3 leaves of 2d + 2 rows each over k + 10 features, leaf 0
    built for `case`; the leaves' k features are distinct columns."""
    rs = np.random.RandomState(seed)
    d = k + 1
    num_f, leaves, m = k + 10, 3, 2 * d + 2
    n = leaves * m
    x = rs.randint(-5, 6, (n, num_f)).astype(np.float32)
    grad = rs.randint(-3, 4, n).astype(np.float32)
    hess = np.ones(n, np.float32)
    weight = np.ones(n, np.float32)
    lid = np.repeat(np.arange(leaves, dtype=np.int32), m)
    feats = np.stack([rs.permutation(num_f)[:k] for _ in range(leaves)]) \
        .astype(np.int32)
    rows = np.arange(m)
    lam = 0.01
    if case == "tie":
        # column 0's largest entries tie in rows 1 and 2, exactly (integer
        # sums): f1 = 5 f0 + e, f2 = f1 + f0 s with s balanced over +-1
        f0, f1, f2 = feats[0, :3]
        z0 = rs.choice([-1.0, 1.0], m).astype(np.float32)
        s = np.where(rs.permutation(m) < m // 2, 1.0, -1.0)
        x[rows, f0] = z0
        x[rows, f1] = 5 * z0 + rs.randint(-1, 2, m)
        x[rows, f2] = x[rows, f1] + z0 * s
    elif case == "constant_feature":
        x[rows, feats[0, 0]] = 2.0      # twice the intercept: singular
        lam = 0.0
    elif case == "under_populated":
        weight[rows[2 * d - 1:]] = 0.0    # 2d - 1 rows left
    elif case == "padded":
        feats[0, k // 2:] = -1
        feats[2, 0] = -1
    elif case == "non_finite":
        hess[3] = np.inf                  # leaf 0's A
        grad[m + 5] = np.nan              # leaf 1's b
    const = rs.randn(leaves).astype(np.float32)
    return x, grad, hess, weight, lid, feats, const, lam


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", WIDTHS)
def test_the_plain_solve_matches_jax_fit_leaves(k, case):
    x, g, h, w, lid, feats, const, lam = fit_rows(k, case, seed=k)
    leaves = feats.shape[0]
    jv, jc, jf = (np.asarray(t) for t in jax_fit(
        *(jnp.asarray(t) for t in (x, g, h, w, lid, feats, const)),
        jnp.float32(lam), leaves))
    t = torch.from_numpy
    perm, begin, rows = linear.segments_of(t(lid), leaves)
    a, b, cnt = linear.linear_normal_eq_plain(t(x), t(g), t(h), t(w), perm,
                                              begin, rows, t(feats))
    if case == "tie":
        assert a[0, 1, 0] == a[0, 2, 0] == a[0, :, 0].abs().max()
    tv, tc, tf = (u.numpy() for u in linear.linear_solve_plain(
        a, b, cnt, t(feats), t(const), lam))
    assert tf[0] == (case in ("tie", "padded")) and tf[2:].all()
    assert tf[1] == (case != "non_finite")
    same = tf == jf
    if case == "constant_feature":
        # leaf 0's column 0 is exactly twice its intercept's: the port's
        # elimination meets an exact zero pivot and keeps the constant.
        # At k 120 the JAX package's LU (LAPACK's blocked sgetrf on the
        # CPU) leaves a pivot of rounding size and fits the leaf: a known
        # parity gap (ROADMAP.md queue C), pinned here as it stands
        assert torch.equal(a[0, 0], 2 * a[0, k])
        assert tv[0] == const[0] and not tc[0].any()
        assert same[1:].all() and same[0] == (k != 120)
    else:
        assert same.all()
    assert np.all(np.abs(tv - jv)[same]
                  <= TOL_LEAF * np.maximum(1, np.abs(jv))[same])
    assert np.all(np.abs(tc - jc)[same]
                  <= TOL_LEAF * np.maximum(1, np.abs(jc))[same])
    if case == "padded":
        assert not tc[0, k // 2:].any() and tc[2, 0] == 0
