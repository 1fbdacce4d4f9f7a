"""Smoke run of lightgbm_tpu_torch on one CUDA card (an H100 for this repo).

    python3 chip_smoke.py

Phases, any failure raises and the script exits non-zero:

0. device: requires CUDA; prints the card and its power limit;
1. build: compiles every kernel library of lightgbm_tpu_torch/csrc with
   nvcc, one process per source, all started together, and prints the
   ptxas register and spill lines;
2. kernels vs plain (serving): K1 forest_value_walk and K2
   forest_leaf_walk against their plain PyTorch versions on the card, on
   a full-width synthetic HIGGS forest (500 trees x 255 leaves x 28
   features, seed 0) and a 50 x 63 forest with categorical nodes, over
   16,384 rows half of which are edge cases: K2 must equal its plain
   version, K1 must equal it bitwise and its epilogue within 2e-7, a
   second run must repeat the bits, and 64 rows must match the f64 host
   oracle Tree.predict_row within 1e-4 relative;
3. serving main path: Booster(model_str=...) on the default device,
   predict on 262,144 rows (value, raw_score, pred_leaf), the serving
   Predictor (warmup, 32 predict_one, 256 submit from 8 threads, stats),
   the model text round trip, and every serving kernel's launch count
   over that run; the whole bulk raw_score and pred_leaf output
   (launched in the engine's row chunks) must equal the plain versions
   on the same rows, and the value output must be within 2e-7 of the
   plain epilogue;
4. serving times: K1 and K2 on all 262,144 rows, in one launch and in
   the engine's row chunks, must equal their plain versions (K1
   bitwise); then CUDA events around each kernel and its plain version
   at 262,144 rows (median of 12 after warm-up), Booster.predict end to
   end, a torch.profiler breakdown of one Booster.predict (device busy
   time against host wall time), Predictor latency percentiles;
5. ranking main path: the repo's ranking protocol
   (scripts/measure_accuracy.py _ranking_task) at full width,
   rank_data(600,000, seed 17) as 500,000 training rows (5,000 queries
   of 100 docs) and 100,000 valid rows, lambdarank, metric ndcg@10,
   max_bin 63, 255 leaves, learning rate 0.1, min_data_in_leaf 1,
   min_sum_hessian_in_leaf 100, 10 rounds through lightgbm_tpu_torch
   .train on the default device: L launched once a round, H, S, R and W
   launched; a second run's model text byte-identical; valid ndcg@10
   rising from round 1 to 10; the saved model reloaded into a Booster
   and served through K1, its raw scores within 1e-5 * max(1, |ref|) of
   the valid scores W kept; LGBMRanker fitting 2 rounds on the card to
   the model text train gives with the same params;
6. L (lambdarank_grads) against its plain version on the card: on the
   ranking protocol's 5,000 x 100-doc layout (its objective's labels,
   gains and inverse max DCGs) at all-zero scores (the first round),
   seeded scores and the scores after 10 rounds, on an MSLR-WEB30K-
   shaped layout (31,531 queries, 3,758,505 docs, up to 1,251 a query,
   empty and one-doc queries) and on queries longer than L stages in
   shared memory: grad and hess within 1e-5 * max(1, A) of the plain
   version and of a float64 oracle on the card, A a doc's sum of
   absolute pair terms; a float64 oracle on the host for a sample of
   queries (the 1,251-doc one among them); a second launch must repeat
   the bits;
7. the card against the CPU: the protocol at 50,000 rows (500
   queries), 63 leaves, 3 rounds: the same tree structure, leaf values
   within 1e-5 relative, valid ndcg@10 within 1e-5;
8. ranking times: L and its plain version (CUDA events, median of 12
   after 0.3 s of back-to-back calls) and its bound at the protocol's
   and the MSLR-shaped layout, seconds per ranking round (median of
   rounds 2-10) and million row-iterations/s, and one profiled round's
   device busy and idle share with L's part of it;
9. training main path: the HIGGS protocol of bench.py at full width,
   synth_higgs(2,000,000, 28, seed 0) with a 262,144-row valid set
   (seed 1) built with reference=, binary, max_bin 63, 255 leaves,
   learning rate 0.1, min_data_in_leaf 1, min_sum_hessian_in_leaf 100,
   metric auc and binary_logloss, 10 rounds through lightgbm_tpu_torch
   .train on the default device; the training kernels' launch counts
   are set to 0 before the run and read after it, and every H launch
   must be in hi+lo mode (the default tpu_hist_bf16); the run is made
   twice and the two model texts must be byte-identical; the valid AUC
   must be finite and well above chance; then the path of H's f32 mode:
   3 rounds of the protocol with tpu_hist_bf16=false, counts set to 0
   before and read after, every kernel launched and no H launch in
   hi+lo mode, valid AUC above 0.7;
10. training kernels vs plain at the main path's shapes, on the first
    tree's inputs: H (leaf_histogram) on the root in all-rows mode and
    on the root split's smaller child in row-list mode, S (split_scan)
    on the root and on the two children, each of them again on the
    gradients after the 10 rounds (whose sums are not exact in f32) at
    the same row sets, R (route_partition and its score update) on the
    root split, W (tree_value_walk_binned) with the trained first tree
    on the valid set. Counts, leaf ids, the partition, the split choices and W's
    scores must equal the plain versions exactly (S bitwise), the g/h
    sums must be within 1e-5 * max(1, |plain|) of the plain version and
    of an f64 oracle, and each kernel launched twice on the same inputs
    must repeat its bits;
11. the card against the CPU: the same protocol at 131,072 rows, 63
    leaves and 5 rounds on the card and with device="cpu" (the plain
    versions), under tpu_hist_bf16=true and false: the same tree
    structure, leaf values within 1e-5 relative, valid AUC within 2e-3;
12. training times: seconds per boosting round (median of rounds 2-10)
    and million row-iterations per second as bench.py reports them; per
    kernel its device time per call (torch.profiler, which leaves out the
    Python wrapper's host time; CUDA events around the call when the
    profiler lists other than the calls' kernels), launches per tree, the plain version's
    CUDA-event ms and the bound, and for H the torch.bincount library
    time, every timing after 0.3 s of back-to-back calls that take the
    card off its idle clocks (printed from nvidia-smi); the device's idle
    share over one profiled round with the top operations;
13. quantized and bagged main paths, on the phase-9 Datasets: 10 rounds
    with tpu_hist_quantize=int8, twice (byte-identical model texts), then
    int16 (qmax 817 at 2,000,000 rows) and int8 with bagging_fraction 0.8,
    bagging_freq 1 (bench.py:970-975), each with every count set to 0
    before it: Q launched once a round and once for the quantize gate, HQ
    once a split, H only for the gate's f32 tree, M once a round when
    bagging; the gate's delta within tpu_hist_quantize_tol; valid AUC
    rising from round 1 to 10 and within 0.02 of phase 9's f32 run
    (QUANTGRAD_r01.json's accuracy_delta_ceiling);
14. M, Q and HQ against their plain versions on the card at the main
    path's shapes: M bitwise on 2,000,000 rows at three refresh indices;
    Q's codes, in-bag weights and scales bitwise on the round-1 and
    round-10 binary gradients, a constant-hessian L2 vector and a bag
    mask; HQ exactly at the root (all rows, and bagged) and on the root
    split's smaller child as a row list; parent == left + right in int32;
    S in XLA's cumsum order (the order quantized growth scans in) with
    the int8 grower's params on the dequantized root and on its two
    children, bitwise against its plain version; each kernel launched
    twice repeating its bits;
15. the card against the CPU at 131,072 rows, 63 leaves and 5 rounds for
    int8, int16, int8 + bagging and f32 + bagging: the same tree
    structure, leaf values within 1e-5 relative, valid AUC within 2e-3;
    Q on the card and on the CPU from the same gradients gives the same
    codes (and how many differ from each side's own gradients);
16. times: M, Q and HQ (root and row list) with their plain versions
    (CUDA events, median of 12 after 0.3 s of back-to-back calls) and
    bounds, torch.bincount x3 with the codes as weights as HQ's library
    yardstick, seconds per quantized and bagged round, and HQ's and Q's
    share of one profiled int8 round;
17. linear main path: the phase-9 HIGGS protocol with linear_tree=true,
    linear_lambda 0.01 (bench.py:1595) and tpu_linear_max_features 5, on
    Datasets that keep the raw values, 10 rounds with every count set to
    0 before it: LF and LS once a tree, LA once a tree for the train
    scores and once for the valid set, W's leaf mode once a tree, no
    constant-leaf score update; a second run's model text byte-identical;
    valid AUC rising; the saved model reloaded and served through K1 on
    the 262,144 valid rows within 1e-5 * max(1, |ref|) of the valid
    scores W + LA kept, 32 Predictor.predict_one equal to predict; the
    diagnostics leaf_feature_moments (LM) on the last tree's leaves;
    then int8 and int8 + bagging for 10 rounds each;
18. LF, LS, LA, LM, K1 on a linear forest and W's leaf mode against their
    plain versions at the main path's shapes: LF on the first tree's
    leaves (2,000,000 rows, k 5) with counts exact and A, b within 1e-5 *
    max(1, sum of |terms|) of the plain version and of an f64 oracle; LS
    on those systems (fitted exact, beta within 1e-5 * max(1, |plain|))
    and on a batch with a singular, an under-populated and a padded-slot
    leaf at linear_lambda 0; LA bitwise on 2,000,000 rows with NaN and
    inf rows; K1 on the trained linear forest bitwise on 262,144 rows; W's
    leaf mode equal; LM as the main path calls it (leaf_feature_moments
    over the last tree's 255 leaf ids and the trained model's gradients)
    and on the first tree's leaves, all four channels per bin within
    1e-5 * max(1, sum of |terms|) of the plain version and an f64
    oracle, the bin-summed sum w g x of the first tree's largest leaf
    equal to LF's b; LF and LS at k = 64 (65,536 rows x 70 columns, 16
    leaves, LF's sums split over three blocks a leaf) against their
    plain versions and LF's f64 oracle; each launched twice repeating
    its bits;
19. the card against the CPU at 131,072 rows, 63 leaves and 5 rounds,
    linear f32 and linear int8: the same tree structure and leaf
    features, leaf values and coefficients within 1e-5 relative, valid
    AUC within 2e-3;
20. times: each new kernel's device time (torch.profiler; CUDA events
    for LS and K1; LM on the main path's call), its plain version, bound and library yardstick
    (index_add_ for LF, torch.linalg.solve for LS, torch.bincount x4 for
    LM); seconds per linear round against phase 12's constant round; one
    profiled linear round; the BENCH_SHAPE=linear gate (bench.py:1562-
    1620: 20,000 x 10 rows, regression, 31 leaves, 60 rounds) on the
    card, its ratio at most 0.7;
21. serving-extras kernels vs plain: the phase-2 forests with binned
    thresholds (`synthetic_forest_text(..., max_bin=255)`: at most 254
    bounds and one missing type a feature, as a model trained at
    max_bin 255 has; the unbinned phase-2 forest must be refused an
    int8 layout by name), on phase 2's check rows plus 4,096 rows of
    grid-bound edge values (`grid_edge_rows`: every bound and its
    nextafter neighbours, +-0, subnormals, +-inf, NaN): QC's codes
    exact; QW and K1's f16 mode bitwise against their plain versions,
    their repeats and each other; ES bitwise (iterations too) at freq 1
    and 10, margins 0, 1e30 and the median 2|raw| at half the
    iterations, with the freeze histogram (some rows freeze at the
    first check, some never); ES on a K = 3 stack of three synthetic
    class forests and on phase 17's linear forest;
22. serving-extras main path: Booster(model_str=...) of the binned
    500 x 255 x 28 forest on the default device, 262,144 rows through
    predict with pred_early_stop (freq 10, phase 21's margin) and with
    tpu_predict_quantize=f16 and int8; the gate's delta within
    tpu_predict_quantize_tol; through Predictor the gate waits out
    warmup and measures the first real request; every count of ES, QC,
    QW and K1-f16 set to 0 before and read after; the bulk raw scores
    equal to the plain versions on the same rows; pred_early_stop
    ignored by a regression model; pred_contrib on 2,048 rows of phase
    9's model (row sums within 1e-5 * max(1, |raw|)); dump_model as
    JSON; predict from a 4,096-row TSV of the valid set equal to the
    array call;
23. continued training: phase 9's saved model continues through
    train(..., init_model=path) on phase 9's Datasets: the 0-round
    replay (W once a tree) within 1e-5 * max(1, |ref|) of phase 9's
    final train score; 10 more rounds twice, byte-identical, H, S, R
    and W launched, valid AUC not below phase 9's; card against CPU on
    the phase-11 protocol, 3 + 3 rounds: the same structure, leaves
    within 1e-5 relative;
24. times: ES, QC, QW and K1-f16 at 262,144 rows (CUDA events, median
    of 12 after 0.3 s of calls), their plain versions (median of 5),
    bounds (ES over the node visits of the trees each row walked), QC's
    yardstick torch.searchsorted over the [F, K] grid; Booster.predict
    end to end for f32, f16, int8 and early stop;
25. GOSS, DART and RF main paths on the phase-9 Datasets, every count
    set to 0 before each run and read after it: boosting=goss (top_rate
    0.2, other_rate 0.1, 20 rounds: it samples from round 11), GT and GW
    launched once a sampled round; boosting=dart (drop_rate 0.1,
    skip_drop 0.5, max_drop 50, drop_seed 4, 10 rounds), W launched once
    a round for the valid set and three times a dropped tree;
    boosting=rf (bagging_fraction 0.7, bagging_freq 1, feature_fraction
    0.7, 10 rounds), R's average mode once a round for the train score
    and once for the valid set, W and M once a round; every H launch in
    hi+lo mode (the default tpu_hist_bf16); each run twice with
    byte-identical model texts; valid AUC finite and above 0.7; the saved
    model reloaded and served through K1 within 1e-5 * max(1, |ref|) of
    the valid scores kept in training (RF through average_output);
26. GT and GW against their plain versions on the card: on the GOSS
    run's gradients at rounds 11 and 20, on all-equal and all-zero
    magnitudes, at top_k 1 and n - 1, and on 1,000,003 rows: weights and
    threshold bitwise, the threshold equal to np.partition on the host, a
    second launch repeating the bits;
27. H's hi+lo mode against its plain version on the root and a child
    (row list) at max_bin 63 (round 20's GOSS channels) and at max_bin
    255 (65,536 weighted rows): counts exact, g/h within 1e-5 * max(1,
    |ref|) of the plain version and of the f64 sum of the exact halves,
    repeats equal, and other sums than the f32 mode; then, bitwise (a
    NaN need only be a NaN), on a sweep of 9,216 f32 values (every
    exponent, the subnormals, rounding ties, +-0, +-inf and NaN) with one
    row a (group, bin), all rows and a row list; R's average mode
    bitwise against its plain version on the train score (leaf ids) and
    a valid score (per-row values);
28. the card against the CPU for goss, dart and rf at 131,072 rows, 63
    leaves, learning rate 0.5 (GOSS samples from round 3), 5 rounds: the
    same trees, leaves within 1e-5 relative, valid AUC within 2e-3;
29. times (CUDA events or torch.profiler, median of 12 after 0.3 s of
    calls): GT + GW at 2,000,000 rows against their plain versions and
    torch.kthvalue (the library yardstick, checked equal), H hi+lo
    against H f32 at the root, R's average mode, seconds per round of
    goss (its sampled rounds), dart and rf, and one profiled GOSS
    round's idle share.

Phases 5-24 train with the default tpu_hist_bf16, so H runs in its
hi+lo mode on their paths; phase 9's tpu_hist_bf16=false run is the
path of its f32 mode, and phase 10 holds that mode to its plain version.

The line before the last is the kernels' JSON summary, the last line
`{"ok": true, "device": {...}}`.
"""
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch

TREES, LEAVES, FEATURES = 500, 255, 28
BULK_ROWS = 262_144
CHECK_ROWS = 16_384
# rows of the k = 64 linear design (phase 18): its f64 oracle holds
# [rows, 65 x 65] products
WIDE_ROWS = 65_536
REPS = 12
# published H100 SXM peaks (NVIDIA H100 datasheet, 700 W): HBM rate,
# and the f32 rate outside the tensor cores, 67 TFLOP/s = 132 SMs x 128
# lanes x 2 (FMA) x 1.98 GHz, i.e. 33.5e12 instructions a second
HBM_BYTES_PER_S = 3.35e12
INSTR_PER_S = 67e12 / 2
# instructions a node visit needs at the least: load the feature id, the
# decision byte, the threshold and the feature value, compare, select
# the child, load it, test the loop
INSTR_PER_VISIT = 8
# the training protocol (bench.py run_amortized, at its 2,000,000 rows)
TRAIN_ROWS, VALID_ROWS, TRAIN_ROUNDS = 2_000_000, 262_144, 10
CPU_ROWS, CPU_VALID_ROWS, CPU_LEAVES, CPU_ROUNDS = 131_072, 32_768, 63, 5
# rounds of the protocol with tpu_hist_bf16=false, the path of H's f32
# mode (every other training run takes the hi+lo default)
F32_ROUNDS = 3
TRAIN_PARAMS = {"objective": "binary", "metric": "auc,binary_logloss",
                "max_bin": 63, "num_leaves": 255, "learning_rate": 0.1,
                "min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 100.0,
                "verbose": -1}
# the ranking protocol (scripts/measure_accuracy.py _ranking_task at its
# 500,000 rows; ndcg_eval_at=[10] reports the metric that record gives)
RANK_ROWS, RANK_VALID_ROWS, RANK_QLEN, RANK_SEED = 500_000, 100_000, 100, 17
RANK_CPU_ROWS, RANK_CPU_VALID_ROWS, RANK_CPU_ROUNDS = 50_000, 10_000, 3
RANK_PARAMS = dict(TRAIN_PARAMS, objective="lambdarank", metric="ndcg",
                   ndcg_eval_at=[10])
# L's least work: a rank compare is a shared-memory load, two compares
# and an add; a (high, low) pair three loads, the subtractions, the
# division, exp, the products and two adds
INSTR_PER_COMPARE = 4
INSTR_PER_PAIR = 24
# one threefry2x32 draw: 20 rounds of add, rotate and xor, five key
# injections of three adds, and the float conversion and compare
INSTR_PER_DRAW = 80


def check(ok, what):
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def spin_up(fn, seconds=0.3):
    """Call fn() back to back for `seconds` (at least twice), so the card
    leaves its idle clocks before a timing: a card that sat idle (the
    CPU phases) runs a lone millisecond kernel several times slower."""
    t0 = time.perf_counter()
    for i in range(1_000_000):
        fn()
        if i >= 1 and time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize()


def clocks():
    """The SM clock now and its maximum, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=REPS):
    """Median of `reps` CUDA-event timings of fn() after a spin-up."""
    spin_up(fn)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_busy(prof):
    """(device events, busy us): the CUDA events of a torch.profiler run
    and the union of their intervals."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return events, busy


def leaf_depths(trees):
    """[T, L] depth of every leaf (node visits a row makes to reach it)."""
    depth = np.zeros((len(trees), max(t.num_leaves for t in trees)),
                     np.int64)
    for ti, t in enumerate(trees):
        stack = [(0, 1)] if t.num_leaves > 1 else []
        while stack:
            node, d = stack.pop()
            for child in (t.left_child[node], t.right_child[node]):
                if child < 0:
                    depth[ti, ~child] = d
                else:
                    stack.append((int(child), d + 1))
    return depth


def where_time_goes(booster, rows, name, card):
    """torch.profiler over one Booster.predict: device busy time (the
    union of the device events' intervals) by kind, against the host
    wall clock of the call; the rest is the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    booster.predict(rows)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        booster.predict(rows)
        wall_us = (time.perf_counter() - t0) * 1e6
    events, busy = device_busy(prof)
    by_kind = {}
    for e in events:
        kind = e.name.split(" (")[0]
        by_kind[kind] = by_kind.get(kind, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_kind.items(), key=lambda kv: -kv[1])[:6]
    print("where the time goes [%s | %s]: Booster.predict %d rows wall "
          "%.2f ms, device busy %.2f ms (idle share %.3f): %s" % (
              name, card, rows.shape[0], wall_us / 1e3, busy / 1e3,
              1.0 - busy / wall_us,
              "; ".join("%s %.3f ms" % (k[:48], v / 1e3) for k, v in top)))
    # the host layers above the engine, each timed alone (median of 5)
    from lightgbm_tpu_torch.basic import _data_to_2d
    rows64 = _data_to_2d(rows)
    rows32 = np.asarray(rows64, np.float32)
    parts = {"Booster._data_to_2d": lambda: _data_to_2d(rows),
             "Predictor f32 cast": lambda: np.asarray(rows64, np.float32),
             "GBDT.predict": lambda: booster._inner.predict(rows32)}
    for label, fn in parts.items():
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        print("where the time goes [%s | %s]: %s %.2f ms"
              % (name, card, label, float(np.median(walls))))


# ---------------------------------------------------------------------
# training (phases 9-12)
def device_ms(fn, names, reps=REPS):
    """Device time of one fn() call: torch.profiler (CUPTI) over `reps`
    calls after a warm-up. Each of `names` names one device event of a
    call (a kernel or a copy); the time is the sum over them of the mean
    length of that event's listings. Unlike CUDA events around the call,
    this leaves out the Python wrapper's host time, which exceeds a small
    kernel's own. The profiler leaves some events out of some runs; a
    mean over those it listed does not count the others as zero, and a
    line says how many it listed. When it lists an event none or more
    than `reps` times, the time is the median of CUDA events around the
    call instead, and a line says so."""
    from torch.profiler import ProfilerActivity, profile
    spin_up(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_busy(prof)[0]
    listed = {n: [e.time_range.elapsed_us() for e in events if n in e.name]
              for n in names}
    counts = "/".join("%s %d" % (n, len(v)) for n, v in listed.items())
    if not all(0 < len(v) <= reps for v in listed.values()):
        ms = median_ms(fn)
        print("device time: the profiler listed %s of %d calls; CUDA events "
              "around the call instead, %.4f ms" % (counts, reps, ms))
        return ms
    if any(len(v) < reps for v in listed.values()):
        print("device time: the profiler listed %s of %d calls; the mean of "
              "the listed" % (counts, reps))
    return sum(float(np.mean(v)) for v in listed.values()) / 1e3


def bound(bytes_moved, ops=0.0):
    """(bound ms, bound_by): the larger of bytes over the HBM rate and
    operations over the non-tensor-core instruction rate."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INSTR_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("operations" if ops_ms > bytes_ms
                                   else "bytes")


def sums_err(got, ref, oracle, label):
    """Counts exact; g/h within 1e-5 * max(1, |ref|) of the plain
    version and of the f64 oracle. Returns the max abs error."""
    check(torch.equal(got[..., 2], ref[..., 2]),
          label + ": counts differ from the plain version")
    check(torch.equal(got[..., 2].double(), oracle[..., 2]),
          label + ": counts differ from the f64 oracle")
    d = (got[..., :2] - ref[..., :2]).abs()
    check(bool((d <= 1e-5 * ref[..., :2].abs().clamp(min=1.0)).all()),
          label + ": g/h sums off the plain version by %g" % d.max())
    d64 = (got[..., :2].double() - oracle[..., :2]).abs()
    check(bool((d64 <= 1e-5 * oracle[..., :2].abs().clamp(min=1.0)).all()),
          label + ": g/h sums off the f64 oracle by %g" % d64.max())
    return float(d.max())


def hist_oracle(binned, w3, num_bins, rows=None):
    """The histogram in float64 torch ops on the card."""
    g_cnt = binned.shape[1]
    sel = torch.arange(binned.shape[0], device=binned.device) \
        if rows is None else rows.long()
    w = w3[sel].double()
    vals = torch.stack([w[:, 0], w[:, 1], (w[:, 2] > 0).double()], 1)
    flat = (torch.arange(g_cnt, device=binned.device) * num_bins)[None] \
        + binned[sel].long()
    out = torch.zeros(g_cnt * num_bins, 3, dtype=torch.float64,
                      device=binned.device)
    out.index_add_(0, flat.reshape(-1), vals[:, None, :].expand(
        -1, g_cnt, 3).reshape(-1, 3))
    return out.view(g_cnt, num_bins, 3)


def leaf_totals(hist):
    """(g, h, count) of a leaf: its histogram's group-0 bins added in
    f32 in bin order, as the grower adds the root's."""
    acc = np.zeros(3, np.float32)
    for row in hist[0].cpu().numpy():
        acc = acc + row
    return acc


def train_run(lgb, x, y, xv, yv, params, rounds, device=None, group=None,
              group_v=None, data=None):
    """One lightgbm_tpu_torch.train run with a valid set (query groups
    for ranking), on the constructed (train, valid) Datasets `data` when
    given; returns the booster, the recorded metrics, each round's
    boosting seconds (train_one_iter, synchronised; the metrics' host
    time excluded) and the two Datasets."""
    if data is None:
        # the binning params go to the Dataset, as bench.py passes them:
        # a Dataset constructed before train() sees max_bin keeps its own
        ds = lgb.Dataset(x, y, group=group, params=dict(params))
        valid = ds.create_valid(xv, yv, group=group_v)
        ds.construct()
        valid.construct()
    else:
        ds, valid = data
    update_s = []

    def time_updates(env):
        inner = env.model._inner
        if getattr(inner, "_timed", False):
            return
        step = inner.train_one_iter

        def timed():
            t0 = time.perf_counter()
            out = step()
            if inner.device.type == "cuda":
                torch.cuda.synchronize()
            update_s.append(time.perf_counter() - t0)
            return out
        inner.train_one_iter = timed
        inner._timed = True
    time_updates.before_iteration = True
    evals = {}
    booster = lgb.train(dict(params), ds, rounds, valid_sets=[valid],
                        valid_names=["valid"], evals_result=evals,
                        verbose_eval=False, callbacks=[time_updates],
                        device=device)
    return booster, evals, update_s, ds, valid


def same_trees(on_card, on_cpu, rounds):
    """Card and CPU boosters grew `rounds` trees of the same structure
    with leaf values within 1e-5 relative; returns the worst relative
    leaf difference."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(on_card._inner.models,
                                   on_cpu._inner.models)):
        m = a.num_leaves - 1
        same = (a.num_leaves == b.num_leaves
                and np.array_equal(a.split_feature[:m], b.split_feature[:m])
                and np.array_equal(a.threshold_in_bin[:m],
                                   b.threshold_in_bin[:m])
                and np.array_equal(a.decision_type[:m], b.decision_type[:m])
                and np.array_equal(a.left_child[:m], b.left_child[:m])
                and np.array_equal(a.right_child[:m], b.right_child[:m]))
        check(same, "card and CPU grew different structures in tree %d" % i)
        rel = np.abs(a.leaf_value - b.leaf_value) / np.maximum(
            1.0, np.abs(b.leaf_value))
        worst = max(worst, float(rel.max()))
    check(len(on_card._inner.models) == len(on_cpu._inner.models)
          == rounds, "card/CPU tree counts")
    check(worst <= 1e-5, "card/CPU leaf values differ by %g" % worst)
    return worst


def training(name, card, dev):
    """Phases 9-12; returns the four training kernels' JSON rows."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import histogram, predict, route, split
    from lightgbm_tpu_torch.testing.synth import synth_higgs

    kernels = {"leaf_histogram": histogram.leaf_histogram,
               "split_scan": split.split_scan,
               "route_partition": route.route_partition,
               "tree_value_walk_binned": predict.tree_value_walk_binned}
    counted = dict(kernels, score_update=route.score_update)

    # ---------------------------------------------------------------- 9
    t0 = time.perf_counter()
    x, y = synth_higgs(TRAIN_ROWS, FEATURES, seed=0)
    xv, yv = synth_higgs(VALID_ROWS, FEATURES, seed=1)
    print("training data: synth_higgs %d + %d rows x %d features in %.1f s"
          % (TRAIN_ROWS, VALID_ROWS, FEATURES, time.perf_counter() - t0))
    for fn in counted.values():
        fn.launches = 0
    histogram.leaf_histogram.launches_hilo = 0
    t0 = time.perf_counter()
    booster, evals, update_s, ds, valid = train_run(
        lgb, x, y, xv, yv, TRAIN_PARAMS, TRAIN_ROUNDS)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    hilo_launches = histogram.leaf_histogram.launches_hilo
    print("training main path launches:", launches, "(H in hi+lo mode %d)"
          % hilo_launches)
    check(all(v > 0 for v in launches.values()),
          "a training kernel of the main path was never launched")
    check(hilo_launches == launches["leaf_histogram"],
          "the default training ran H %d times, %d in hi+lo mode"
          % (launches["leaf_histogram"], hilo_launches))
    check(booster.device.type == "cuda", "training did not run on cuda")
    check(booster.num_trees() == TRAIN_ROUNDS, "trained %d trees, not %d"
          % (booster.num_trees(), TRAIN_ROUNDS))
    auc = evals["valid"]["auc"]
    loss = evals["valid"]["binary_logloss"]
    check(len(auc) == TRAIN_ROUNDS and all(np.isfinite(auc + loss)),
          "valid metrics missing or not finite")
    check(auc[-1] > 0.7 and loss[-1] < loss[0], "valid AUC %.4f / logloss "
          "%.4f -> %.4f: the model did not learn" % (auc[-1], loss[0],
                                                     loss[-1]))
    text = booster.model_to_string()
    grower = booster._inner._grower
    check(grower.feature_bins <= TRAIN_PARAMS["max_bin"],
          "features have %d bins, above max_bin %d"
          % (grower.feature_bins, TRAIN_PARAMS["max_bin"]))
    print("training main path: %d rounds, %d trees of %s leaves, %d "
          "groups of at most %d bins, valid auc %.5f binary_logloss %.5f, "
          "%.1f s with dataset construction"
          % (TRAIN_ROUNDS, booster.num_trees(),
             sorted({t.num_leaves for t in booster._inner.models}),
             grower.binned.shape[1], grower.num_bins, auc[-1], loss[-1],
             wall))
    again = train_run(lgb, x, y, xv, yv, TRAIN_PARAMS, TRAIN_ROUNDS)[0]
    check(again.model_to_string() == text,
          "two training runs gave different model texts")
    print("training main path: a second run gave a byte-identical model "
          "text (%d bytes)" % len(text))
    # H's f32 mode: the protocol with tpu_hist_bf16=false
    for fn in counted.values():
        fn.launches = 0
    histogram.leaf_histogram.launches_hilo = 0
    f32_evals = train_run(lgb, x, y, xv, yv,
                          dict(TRAIN_PARAMS, tpu_hist_bf16=False),
                          F32_ROUNDS, data=(ds, valid))[1]
    f32_launches = {k: fn.launches for k, fn in counted.items()}
    print("training f32 path launches:", f32_launches, "(H in hi+lo mode "
          "%d)" % histogram.leaf_histogram.launches_hilo)
    check(all(v > 0 for v in f32_launches.values())
          and histogram.leaf_histogram.launches_hilo == 0,
          "tpu_hist_bf16=false: a kernel never launched, or H in hi+lo "
          "mode")
    f32_auc = f32_evals["valid"]["auc"]
    check(len(f32_auc) == F32_ROUNDS and np.isfinite(f32_auc).all()
          and f32_auc[-1] > 0.7, "tpu_hist_bf16=false: valid AUC %s"
          % f32_auc)
    print("training f32 path: %d rounds with tpu_hist_bf16=false, valid "
          "auc %.5f" % (F32_ROUNDS, f32_auc[-1]))
    pred = booster.predict(xv[:4096])
    check(np.isfinite(pred).all() and ((pred > 0) & (pred < 1)).all(),
          "predictions of the trained model")
    # phase 23 continues this model from its saved text
    train_score = booster._inner._train_score_unpadded()

    # --------------------------------------------------------------- 10
    errs = {}
    fresh = lgb.Booster(dict(TRAIN_PARAMS), train_set=ds)
    gb = fresh._inner
    grower = gb._grower
    grad, hess = gb.objective.get_gradients(gb._score[0])
    w3 = torch.stack([grad, hess, torch.ones_like(grad)], 1).contiguous()
    binned = gb._binned
    nb, fb = grower.num_bins, grower.feature_bins
    fmeta, prm = grower.fmeta_dev, grower.params
    mask = torch.ones(ds._inner.num_features, dtype=torch.uint8, device=dev)
    h_root = histogram.leaf_histogram(binned, w3, nb)
    check(torch.equal(h_root, histogram.leaf_histogram(binned, w3, nb)),
          "H root: a second launch gave other bits")
    errs["leaf_histogram"] = sums_err(
        h_root, histogram.leaf_histogram_plain(binned, w3, nb),
        hist_oracle(binned, w3, nb), "H all rows (root)")
    acc = leaf_totals(h_root)
    sums = torch.from_numpy(acc[None]).to(dev)
    depth0 = torch.zeros(1, dtype=torch.int32, device=dev)
    root1 = h_root[None]
    s_root = split.split_scan(root1, sums, depth0, fmeta, mask, prm, fb)
    for got in (split.split_scan(root1, sums, depth0, fmeta, mask, prm, fb),
                split.split_scan_plain(root1, sums, depth0, fmeta, mask,
                                       prm, fb)):
        check(all(torch.equal(a, b) for a, b in zip(s_root, got)),
              "S root: not bitwise equal to its repeat and plain version")
    out_f = s_root[0][0].cpu().numpy()
    out_i = s_root[1][0].cpu().numpy()
    feat = int(out_i[0])
    fm = grower.fmeta
    rule = route.SplitRule(
        int(fm["group"][feat]), int(fm["offset"][feat]),
        int(fm["num_bin"][feat]), int(fm["default_bin"][feat]),
        int(fm["missing_type"][feat]), bool(fm["is_bundled"][feat]),
        int(out_i[1]), bool(out_i[2]), bool(out_i[3]), 0, 1)
    perm0 = torch.arange(TRAIN_ROWS, dtype=torch.int32, device=dev)
    lid0 = torch.zeros(TRAIN_ROWS, dtype=torch.int32, device=dev)
    res = []
    for fn in (route.route_partition, route.route_partition,
               route.route_partition_plain):
        perm, lid = perm0.clone(), lid0.clone()
        n_left = int(fn(binned, perm, 0, TRAIN_ROWS, rule, lid))
        res.append((perm, lid, n_left))
    check(all(torch.equal(res[0][0], r[0]) and torch.equal(res[0][1], r[1])
              and res[0][2] == r[2] for r in res[1:]),
          "R: partition or leaf ids differ between launches or from plain")
    perm, lid, n_left = res[0]
    check(n_left == int(round(float(out_f[3]))),
          "R sent %d rows left, the scan counted %s" % (n_left, out_f[3]))
    errs["route_partition"] = 0
    small_left = np.float32(out_f[3]) * np.float32(2.0) <= acc[2]
    small, large = (0, 1) if small_left else (1, 0)
    seg = {0: (0, n_left), 1: (n_left, TRAIN_ROWS - n_left)}
    b0, cnt = seg[small]
    depth1 = torch.ones(2, dtype=torch.int32, device=dev)

    def children(w, parent, child_sums, label):
        """H's row list on the smaller child of the root split (against
        plain and the f64 oracle, and its own repeat), the larger child
        as parent - smaller, and S on both (bitwise against its repeat
        and plain). Returns H's max abs error and (pair, sums)."""
        h_list = histogram.leaf_histogram(binned, w, nb, rows=perm[b0:],
                                          n_rows=cnt)
        check(torch.equal(h_list, histogram.leaf_histogram(
            binned, w, nb, rows=perm[b0:], n_rows=cnt)),
            "H row list (%s): a second launch gave other bits" % label)
        err = sums_err(
            h_list, histogram.leaf_histogram_plain(
                binned, w, nb, rows=perm[b0:], n_rows=cnt),
            hist_oracle(binned, w, nb, rows=perm[b0:b0 + cnt]),
            "H row list (%s, smaller child, %d rows)" % (label, cnt))
        pair = torch.empty((2,) + tuple(parent.shape), device=dev)
        pair[small] = h_list
        pair[large] = histogram.subtract(parent, h_list)
        if child_sums is None:
            child_sums = np.stack([leaf_totals(pair[0]),
                                   leaf_totals(pair[1])])
        csums = torch.from_numpy(child_sums).to(dev)
        s_kids = split.split_scan(pair, csums, depth1, fmeta, mask, prm, fb)
        for got in (split.split_scan(pair, csums, depth1, fmeta, mask, prm,
                                     fb),
                    split.split_scan_plain(pair, csums, depth1, fmeta, mask,
                                           prm, fb)):
            check(all(torch.equal(a, b) for a, b in zip(s_kids, got)),
                  "S children (%s): not bitwise equal to repeat and plain "
                  "version" % label)
        return err, pair, csums

    # the children's totals as the grower takes them: the left from the
    # root scan, the right as root - left
    lg, lh, lc = out_f[1:4]
    left = np.array([lg, lh, lc], np.float32)
    err, pair, csums = children(w3, h_root, np.stack([left, acc - left]),
                                "first tree")
    errs["leaf_histogram"] = max(errs["leaf_histogram"], err)
    # the first tree's gradients are multiples of 1/4, whose sums are
    # exact in any order; hold H and S also to the trained model's
    # gradients, at the same row sets (the children's totals then from
    # their histograms)
    g10, h10 = booster._inner.objective.get_gradients(
        booster._inner._score[0])
    w10 = torch.stack([g10, h10, torch.ones_like(g10)], 1).contiguous()
    h_late = histogram.leaf_histogram(binned, w10, nb)
    check(torch.equal(h_late, histogram.leaf_histogram(binned, w10, nb)),
          "H after %d rounds: a second launch gave other bits"
          % TRAIN_ROUNDS)
    errs["leaf_histogram"] = max(errs["leaf_histogram"], sums_err(
        h_late, histogram.leaf_histogram_plain(binned, w10, nb),
        hist_oracle(binned, w10, nb),
        "H all rows (gradients after %d rounds)" % TRAIN_ROUNDS))
    late = "gradients after %d rounds" % TRAIN_ROUNDS
    errs["leaf_histogram"] = max(errs["leaf_histogram"],
                                 children(w10, h_late, None, late)[0])
    del w10, g10, h10, h_late
    errs["split_scan"] = 0.0
    values = torch.tensor([0.05, -0.07], dtype=torch.float32, device=dev)
    scores = []
    for fn in (route.score_update, route.score_update,
               route.score_update_plain):
        sc = gb._score[0].clone()
        fn(sc, lid, values, 0.1)
        scores.append(sc)
    check(all(torch.equal(scores[0], sc) for sc in scores[1:]),
          "R score update differs between launches or from plain")
    tree0 = booster._inner.models[0]
    bt = predict.binned_tree(tree0, dev)
    vb = booster._inner._valid_binned[0]
    walked = []
    for fn in (predict.tree_value_walk_binned, predict.tree_value_walk_binned,
               predict.tree_value_walk_binned_plain):
        sc = torch.zeros(VALID_ROWS, dtype=torch.float32, device=dev)
        fn(bt, vb, sc)
        walked.append(sc)
    check(all(torch.equal(walked[0], sc) for sc in walked[1:]),
          "W differs between launches or from plain")
    errs["tree_value_walk_binned"] = 0.0
    print("training kernels vs plain [first tree, %d rows]: H all rows "
          "and row list (%d rows), on the first tree's gradients and on "
          "those after %d rounds, within 1e-5 of plain and f64 (max abs "
          "err %.3g), counts exact; S root and children (both gradients) "
          "bitwise; R partition, leaf ids and score update exact; W exact "
          "on %d valid rows; every kernel repeated its bits"
          % (TRAIN_ROWS, cnt, TRAIN_ROUNDS, errs["leaf_histogram"],
             VALID_ROWS))

    # --------------------------------------------------------------- 11
    xs, ys = x[:CPU_ROWS], y[:CPU_ROWS]
    xvs, yvs = xv[:CPU_VALID_ROWS], yv[:CPU_VALID_ROWS]
    for bf16 in (True, False):
        cpu_params = dict(TRAIN_PARAMS, num_leaves=CPU_LEAVES,
                          tpu_hist_bf16=bf16)
        t0 = time.perf_counter()
        on_card, ev_card = train_run(lgb, xs, ys, xvs, yvs, cpu_params,
                                     CPU_ROUNDS)[:2]
        on_cpu, ev_cpu = train_run(lgb, xs, ys, xvs, yvs, cpu_params,
                                   CPU_ROUNDS, device="cpu")[:2]
        worst = same_trees(on_card, on_cpu, CPU_ROUNDS)
        d_auc = abs(ev_card["valid"]["auc"][-1]
                    - ev_cpu["valid"]["auc"][-1])
        check(d_auc <= 2e-3, "card/CPU valid AUC differ by %g" % d_auc)
        print("card vs CPU [%d rows, %d leaves, %d rounds, tpu_hist_bf16="
              "%s]: same structure, leaf values within %.3g relative, valid "
              "auc %.5f vs %.5f (%.2f s)"
              % (CPU_ROWS, CPU_LEAVES, CPU_ROUNDS, str(bf16).lower(), worst,
                 ev_card["valid"]["auc"][-1], ev_cpu["valid"]["auc"][-1],
                 time.perf_counter() - t0))

    # --------------------------------------------------------------- 12
    print("clocks [%s]: SM clock, max SM clock: %s (idle after the CPU "
          "phase)" % (card, clocks()))
    med = float(np.median(update_s[1:TRAIN_ROUNDS]))
    print("time [%s | %s]: boosting round %.4f s (median of rounds 2-%d), "
          "%.3f million row-iterations/s, rounds %s"
          % (name, card, med, TRAIN_ROUNDS, TRAIN_ROWS / med / 1e6,
             " ".join("%.4f" % v for v in update_s)))
    n, g_cnt = binned.shape
    times = {}
    # H: the root pass, all rows
    flat = ((torch.arange(g_cnt, device=dev) * nb)[None]
            + binned.long()).reshape(-1)
    chans = [w3[:, c, None].expand(n, g_cnt).reshape(-1) for c in (0, 1)]
    ones = (w3[:, 2, None] > 0).float().expand(n, g_cnt).reshape(-1)

    def library():
        for c in (chans[0], chans[1], ones):
            torch.bincount(flat, weights=c, minlength=g_cnt * nb)
    h_names = ("hist_tile_kernel", "hist_reduce_kernel")
    times["leaf_histogram"] = (
        device_ms(lambda: histogram.leaf_histogram(binned, w3, nb), h_names),
        median_ms(lambda: histogram.leaf_histogram_plain(binned, w3, nb),
                 reps=5),
        bound(n * g_cnt + n * 12 + g_cnt * nb * 12, 3.0 * n * g_cnt),
        median_ms(library, reps=5))
    del flat, chans, ones
    # H's row-list mode, on the root split's smaller child: row ids,
    # then the taken rows' bins and channels
    b_ms, b_by = bound(cnt * (4 + g_cnt + 12) + g_cnt * nb * 12,
                       3.0 * cnt * g_cnt)
    print("time [%s | %s]: leaf_histogram row list (%d of %d rows) %.4f ms "
          "device time, plain %.3f ms, bound %.5f ms (%s)"
          % (name, card, cnt, n, device_ms(
              lambda: histogram.leaf_histogram(binned, w3, nb, rows=perm[b0:],
                                               n_rows=cnt), h_names),
             median_ms(lambda: histogram.leaf_histogram_plain(
                 binned, w3, nb, rows=perm[b0:], n_rows=cnt), reps=5),
             b_ms, b_by))
    print("time [%s | %s]: leaf_histogram root, CUDA events around the "
          "call %.4f ms" % (name, card, median_ms(
              lambda: histogram.leaf_histogram(binned, w3, nb))))
    # S: the two children of the root split
    s_ops = 2 * fmeta["num_bin"].shape[0] * fb * 50
    times["split_scan"] = (
        device_ms(lambda: split.split_scan(pair, csums, depth1, fmeta, mask,
                                           prm, fb), ("split_scan_kernel",)),
        median_ms(lambda: split.split_scan_plain(pair, csums, depth1, fmeta,
                                                mask, prm, fb), reps=5),
        bound(pair.numel() * 4 + 64, s_ops), None)
    # R: the root split of all rows; routing a routed segment again
    # repeats the same work and leaves it as it is
    rperm, rlid = perm0.clone(), lid0.clone()
    times["route_partition"] = (
        device_ms(lambda: route.route_partition(binned, rperm, 0, n, rule,
                                                rlid),
                  ("route_kernel", "scan_tiles_kernel", "scatter_kernel",
                   "Memcpy DtoD")),
        median_ms(lambda: route.route_partition_plain(binned, rperm, 0, n,
                                                     rule, rlid), reps=5),
        bound(13 * n), None)
    check(torch.equal(rperm, perm) and torch.equal(rlid, lid),
          "R: routing the routed rows again changed them")
    sc = gb._score[0].clone()
    print("time [%s | %s]: R score update (%d rows) %.4f ms device time"
          % (name, card, n, device_ms(lambda: route.score_update(
              sc, lid, values, 0.1), ("score_kernel",))))
    # W: the first tree on the valid set; a row reads one bin a node it
    # visits
    leaf = predict.tree_leaf_binned_plain(bt, vb)
    depth = torch.from_numpy(leaf_depths([tree0])[0]).to(dev)
    visits = int(depth[leaf].sum())
    sc = torch.zeros(VALID_ROWS, dtype=torch.float32, device=dev)
    times["tree_value_walk_binned"] = (
        device_ms(lambda: predict.tree_value_walk_binned(bt, vb, sc),
                  ("walk_kernel",)),
        median_ms(lambda: predict.tree_value_walk_binned_plain(bt, vb, sc),
                 reps=5),
        bound(visits + 8 * VALID_ROWS + bt.nodes.numel() * 4,
              visits * INSTR_PER_VISIT), None)
    # H's row is its f32 mode, launched by the tpu_hist_bf16=false run
    launches["leaf_histogram"] = f32_launches["leaf_histogram"]
    rounds_of = dict.fromkeys(times, TRAIN_ROUNDS)
    rounds_of["leaf_histogram"] = F32_ROUNDS
    for k, (ms, plain_ms, (b_ms, b_by), lib_ms) in times.items():
        print("time [%s | %s]: %s %.4f ms, plain %.3f ms, bound %.5f ms "
              "(%s), %.1f launches per tree%s"
              % (name, card, k, ms, plain_ms, b_ms, b_by,
                 launches[k] / rounds_of[k],
                 "" if lib_ms is None else
                 ", torch.bincount x3 %.4f ms" % lib_ms))
    print("clocks [%s]: SM clock, max SM clock: %s (after the timings)"
          % (card, clocks()))
    profile_round(booster, name, card)

    replaces = {
        "leaf_histogram": "lightgbm_tpu/ops/histogram.py:474",
        "split_scan": "lightgbm_tpu/ops/split.py:80",
        "route_partition": "lightgbm_tpu/learner/grow.py:1037",
        "tree_value_walk_binned": "lightgbm_tpu/ops/predict.py:182"}
    sources = {
        "leaf_histogram": "lightgbm_tpu_torch/csrc/histogram.cu",
        "split_scan": "lightgbm_tpu_torch/csrc/split_scan.cu",
        "route_partition": "lightgbm_tpu_torch/csrc/route_partition.cu",
        "tree_value_walk_binned": "lightgbm_tpu_torch/csrc/binned_walk.cu"}
    rows = []
    for k in kernels:
        ms, plain_ms, (b_ms, b_by), lib_ms = times[k]
        row = {"name": k, "route": "cuda", "source": sources[k],
               "replaces": replaces[k], "launches": launches[k],
               "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        if k == "route_partition":
            row["score_update_launches"] = launches["score_update"]
        rows.append(row)
    ctx = {"x": x, "y": y, "xv": xv, "yv": yv, "data": (ds, valid),
           "auc": auc, "perm": perm, "n_left": n_left, "rounds_s": med,
           "text": text, "train_score": train_score,
           "hilo_launches": hilo_launches}
    return rows, ctx


# ---------------------------------------------------------------------
# quantized and bagged training (phases 13-16)
def hist_launches(trees, num_leaves):
    """Histogram launches growing `trees`: the root's, and one a split
    but the split that fills the tree."""
    return sum(t.num_leaves - (t.num_leaves == num_leaves) for t in trees)


def q_equal(a, b):
    """Q's outputs (codes, w01, qscale) bit for bit."""
    return (torch.equal(a.codes, b.codes) and torch.equal(a.w01, b.w01)
            and torch.equal(a.qscale.view(torch.int32),
                            b.qscale.view(torch.int32)))


def quantized(name, card, dev, ctx):
    """Phases 13-16; returns the JSON rows of M, Q and HQ."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import histogram, predict, rng, route, split

    counted = {"bagging_mask": rng.bagging_mask,
               "quantize_gradients": histogram.quantize_gradients,
               "leaf_histogram_i32": histogram.leaf_histogram_i32,
               "leaf_histogram": histogram.leaf_histogram,
               "split_scan": split.split_scan,
               "route_partition": route.route_partition,
               "score_update": route.score_update,
               "tree_value_walk_binned": predict.tree_value_walk_binned}
    x, y, xv, yv = ctx["x"], ctx["y"], ctx["xv"], ctx["yv"]
    data = ctx["data"]
    leaves = TRAIN_PARAMS["num_leaves"]

    def path(label, params):
        """One 10-round run of the HIGGS protocol on the phase-9 Dataset
        with every count set to 0 before it; returns the booster, its
        valid AUCs, its round seconds and the counts."""
        for fn in counted.values():
            fn.launches = 0
        booster, evals, update_s = train_run(
            lgb, x, y, xv, yv, params, TRAIN_ROUNDS, data=data)[:3]
        launches = {k: fn.launches for k, fn in counted.items()}
        gb = booster._inner
        auc = evals["valid"]["auc"]
        trees = gb.models
        gq, gf = gb.quant_gate_leaves
        print("%s path launches: %s" % (label, launches))
        check(booster.device.type == "cuda" and len(trees) == TRAIN_ROUNDS,
              label + ": %d trees on %s" % (len(trees), booster.device))
        check(launches["quantize_gradients"] == TRAIN_ROUNDS + 1,
              label + ": Q launched %d times, not once a round and once for "
              "the gate" % launches["quantize_gradients"])
        want = hist_launches(trees, leaves) + gq - (gq == 31)
        check(launches["leaf_histogram_i32"] == want,
              label + ": HQ launched %d times, not once a split (%d)"
              % (launches["leaf_histogram_i32"], want))
        check(launches["leaf_histogram"] == gf - (gf == 31),
              label + ": H launched %d times beyond the gate's f32 tree"
              % launches["leaf_histogram"])
        check(all(launches[k] > 0 for k in ("split_scan", "route_partition",
                                             "score_update",
                                             "tree_value_walk_binned")),
              label + ": a kernel of the path was never launched")
        tol = float(params.get("tpu_hist_quantize_tol", 0.5))
        check(gb.quant_gate_delta <= tol, label + ": gate delta %g > %g"
              % (gb.quant_gate_delta, tol))
        check(len(auc) == TRAIN_ROUNDS and np.isfinite(auc).all()
              and auc[-1] > auc[0], label + ": valid AUC %s did not rise"
              % auc)
        check(abs(auc[-1] - ctx["auc"][-1]) <= 0.02,
              label + ": valid AUC %.5f vs %.5f in f32" % (auc[-1],
                                                          ctx["auc"][-1]))
        med = float(np.median(update_s[1:TRAIN_ROUNDS]))
        print("%s path: qmax %d, gate delta %.4g (trees of %d and %d "
              "leaves), valid auc %.5f (round 1) -> %.5f (f32 %.5f), trees "
              "of %s leaves" % (label, gb._quant_qmax, gb.quant_gate_delta,
                                gq, gf, auc[0], auc[-1], ctx["auc"][-1],
                                sorted({t.num_leaves for t in trees})))
        print("time [%s | %s]: %s boosting round %.4f s (median of rounds "
              "2-%d), %.3f million row-iterations/s, rounds %s"
              % (name, card, label, med, TRAIN_ROUNDS, TRAIN_ROWS / med / 1e6,
                 " ".join("%.4f" % v for v in update_s)))
        return booster, auc, med, launches

    # --------------------------------------------------------------- 13
    int8 = dict(TRAIN_PARAMS, tpu_hist_quantize="int8")
    bagged = dict(int8, bagging_fraction=0.8, bagging_freq=1)
    b8, auc8, med8, launches = path("int8", int8)
    check(launches["bagging_mask"] == 0, "int8: M launched without bagging")
    text = b8.model_to_string()
    again = train_run(lgb, x, y, xv, yv, int8, TRAIN_ROUNDS, data=data)[0]
    check(again.model_to_string() == text,
          "two int8 runs gave different model texts")
    del again
    print("int8 path: a second run gave a byte-identical model text (%d "
          "bytes)" % len(text))
    b16 = path("int16", dict(TRAIN_PARAMS, tpu_hist_quantize="int16"))[0]
    check(b16._inner._quant_qmax == 817, "int16 qmax %d at %d rows, not 817"
          % (b16._inner._quant_qmax, TRAIN_ROWS))
    del b16
    bb, _, med_bag, bag_launches = path("int8 + bagging", bagged)
    check(bag_launches["bagging_mask"] == TRAIN_ROUNDS,
          "bagging: M launched %d times in %d rounds"
          % (bag_launches["bagging_mask"], TRAIN_ROUNDS))
    del bb

    # --------------------------------------------------------------- 14
    n = TRAIN_ROWS
    gb8 = b8._inner
    qmax = gb8._quant_qmax
    binned, nb = gb8._binned, gb8._grower.num_bins
    seed = int(gb8.config.boosting.bagging_seed)
    masks = {}
    for ridx in (0, 1, TRAIN_ROUNDS - 1):
        key = rng.fold_in(rng.prng_key(seed), ridx)
        got = rng.bagging_mask(key, 0.8, torch.empty(n, device=dev))
        again = rng.bagging_mask(key, 0.8, torch.empty(n, device=dev))
        plain = rng.bagging_mask_plain(key, 0.8, torch.empty(n, device=dev))
        check(torch.equal(got, again) and torch.equal(got, plain),
              "M refresh %d: not bitwise equal to its repeat and plain"
              % ridx)
        masks[ridx] = got
    fresh = lgb.Booster(dict(int8), train_set=data[0])._inner
    g1, h1 = fresh.objective.get_gradients(fresh._score[0])
    g10, h10 = gb8.objective.get_gradients(gb8._score[0])
    l2_g = gb8._score[0] - torch.from_numpy(y.astype(np.float32)).to(dev)
    ones = torch.ones(n, device=dev)
    keys = [rng.fold_in(rng.fold_in(rng.fold_in(rng.prng_key(
        gb8._quant_seed), it), 0), c) for it in (0, TRAIN_ROUNDS - 1)
        for c in (0, 1)]
    cases = {"round 1": (g1, h1, ones, keys[0], keys[1], False),
             "round %d" % TRAIN_ROUNDS: (g10, h10, ones, keys[2], keys[3],
                                         False),
             "constant-hessian L2": (l2_g, ones, ones, keys[0], keys[1],
                                     True),
             "bag mask": (g1, h1, masks[0], keys[0], keys[1], False)}
    qs = {}
    for label, (g, h, w, kg, kh, hc) in cases.items():
        got = histogram.quantize_gradients(g, h, w, qmax=qmax, key_g=kg,
                                           key_h=kh, hess_const=hc)
        again = histogram.quantize_gradients(g, h, w, qmax=qmax, key_g=kg,
                                             key_h=kh, hess_const=hc)
        plain = histogram.quantize_gradients_plain(g, h, w, qmax, kg, kh, hc)
        check(q_equal(got, again) and q_equal(got, plain),
              "Q (%s): codes, w01 or scale not bitwise equal to its repeat "
              "and plain" % label)
        qs[label] = got
    q10 = qs["round %d" % TRAIN_ROUNDS]
    perm, n_left = ctx["perm"], ctx["n_left"]
    small = (0, n_left) if n_left <= n - n_left else (n_left, n - n_left)
    hq = {}
    for label, q, rows in (
            ("root", q10, None),
            ("root, bag mask", qs["bag mask"], None),
            ("row list", q10, small),
            ("left", q10, (0, n_left)), ("right", q10, (n_left, n - n_left))):
        kw = {} if rows is None else {"rows": perm[rows[0]:],
                                      "n_rows": rows[1]}
        got = histogram.leaf_histogram_i32(binned, q.codes, q.w01, nb, **kw)
        again = histogram.leaf_histogram_i32(binned, q.codes, q.w01, nb,
                                             **kw)
        plain = histogram.leaf_histogram_i32_plain(binned, q.codes, q.w01,
                                                   nb, **kw)
        check(torch.equal(got, again) and torch.equal(got, plain),
              "HQ (%s): not equal to its repeat and plain" % label)
        hq[label] = got
    check(torch.equal(hq["left"] + hq["right"], hq["root"])
          and torch.equal(histogram.subtract(hq["root"], hq["left"]),
                          hq["right"]),
          "HQ: parent != left + right in int32")
    # S in XLA's cumsum order (quantized growth scans dequantized bins) on
    # the dequantized root and its children, with the int8 grower's
    # params, against its repeat and plain version
    grower8 = gb8._grower
    prm8 = grower8.params
    mask8 = torch.ones(grower8.fmeta_dev["num_bin"].shape[0],
                       dtype=torch.uint8, device=dev)
    for label, parts, depth in (("root", ("root",), 0),
                                ("children", ("left", "right"), 1)):
        hists = torch.stack([hq[p] for p in parts])
        tot = split.dequantize_hist(hists[:, 0].sum(1, dtype=torch.int32),
                                    q10.qscale).contiguous()
        deq = split.dequantize_hist(hists, q10.qscale).contiguous()
        dep = torch.full((len(parts),), depth, dtype=torch.int32,
                         device=dev)
        args = (deq, tot, dep, grower8.fmeta_dev, mask8, prm8,
                grower8.feature_bins)
        got = split.split_scan(*args)
        for again in (split.split_scan(*args), split.split_scan_plain(*args)):
            check(all(torch.equal(u, v) for u, v in zip(got, again)),
                  "S in XLA's order (%s, int8): not bitwise equal to its "
                  "repeat and plain version" % label)
    print("M, Q, HQ vs plain [%d rows]: M bitwise at refresh 0, 1 and %d; Q "
          "codes, w01 and scales bitwise on the round-1 and round-%d "
          "gradients, a constant-hessian L2 vector and a bag mask; HQ equal "
          "at the root (all rows and bagged) and on a %d-row list segment; "
          "parent == left + right in int32; S in XLA's order bitwise on the "
          "dequantized root and children; every kernel repeated its bits"
          % (n, TRAIN_ROUNDS - 1, TRAIN_ROUNDS, small[1]))

    # --------------------------------------------------------------- 15
    cpu_data = {}
    xs, ys = x[:CPU_ROWS], y[:CPU_ROWS]
    xvs, yvs = xv[:CPU_VALID_ROWS], yv[:CPU_VALID_ROWS]
    base = dict(TRAIN_PARAMS, num_leaves=CPU_LEAVES)
    for label, extra in (
            ("int8", {"tpu_hist_quantize": "int8"}),
            ("int16", {"tpu_hist_quantize": "int16"}),
            ("int8 + bagging", {"tpu_hist_quantize": "int8",
                                "bagging_fraction": 0.8, "bagging_freq": 1}),
            ("f32 + bagging", {"bagging_fraction": 0.8, "bagging_freq": 1})):
        t0 = time.perf_counter()
        params = dict(base, **extra)
        on_card, ev_card, _, ds, vs = train_run(
            lgb, xs, ys, xvs, yvs, params, CPU_ROUNDS,
            data=cpu_data.get("data"))
        cpu_data["data"] = (ds, vs)
        on_cpu, ev_cpu = train_run(lgb, xs, ys, xvs, yvs, params, CPU_ROUNDS,
                                   device="cpu", data=(ds, vs))[:2]
        worst = same_trees(on_card, on_cpu, CPU_ROUNDS)
        d_auc = abs(ev_card["valid"]["auc"][-1] - ev_cpu["valid"]["auc"][-1])
        check(d_auc <= 2e-3, "%s card/CPU valid AUC differ by %g"
              % (label, d_auc))
        codes = ""
        if "tpu_hist_quantize" in extra:
            gc, gcpu = on_card._inner, on_cpu._inner
            kg, kh = (rng.fold_in(rng.fold_in(rng.fold_in(rng.prng_key(
                gc._quant_seed), CPU_ROUNDS), 0), c) for c in (0, 1))
            g_c, h_c = gc.objective.get_gradients(gc._score[0])
            g_h, h_h = gcpu.objective.get_gradients(gcpu._score[0])
            w = torch.ones(CPU_ROWS, device=dev)
            q_card = histogram.quantize_gradients(
                g_c, h_c, w, qmax=gc._quant_qmax, key_g=kg, key_h=kh)
            q_same = histogram.quantize_gradients(
                g_c.cpu(), h_c.cpu(), w.cpu(), qmax=gc._quant_qmax, key_g=kg,
                key_h=kh)
            q_own = histogram.quantize_gradients(
                g_h, h_h, w.cpu(), qmax=gc._quant_qmax, key_g=kg, key_h=kh)
            same = int((q_card.codes.cpu() != q_same.codes).sum())
            own = int((q_card.codes.cpu() != q_own.codes).sum())
            check(same == 0, "%s: Q on the card and on the CPU give %d "
                  "different codes from the same gradients" % (label, same))
            codes = ("; round-%d codes: card vs CPU from the same gradients "
                     "%d differ, from each side's own gradients %d differ "
                     "(%d gradient and %d hessian words differ)"
                     % (CPU_ROUNDS + 1, same, own,
                        int((g_c.cpu().view(torch.int32)
                             != g_h.view(torch.int32)).sum()),
                        int((h_c.cpu().view(torch.int32)
                             != h_h.view(torch.int32)).sum())))
        print("card vs CPU [%s, %d rows, %d leaves, %d rounds]: same "
              "structure, leaf values within %.3g relative, valid auc %.5f "
              "vs %.5f (%.2f s)%s"
              % (label, CPU_ROWS, CPU_LEAVES, CPU_ROUNDS, worst,
                 ev_card["valid"]["auc"][-1], ev_cpu["valid"]["auc"][-1],
                 time.perf_counter() - t0, codes))

    # --------------------------------------------------------------- 16
    g_cnt = binned.shape[1]
    mask = masks[0]
    key = rng.fold_in(rng.prng_key(seed), 0)
    m_bound = bound(4 * n, INSTR_PER_DRAW * n)
    kg, kh = keys[2], keys[3]
    q_bound = bound(20 * n, 2 * INSTR_PER_DRAW * n)
    # HQ: the bins of every row (G bytes), its codes and w01 (8 bytes)
    # and the int32 output; three shared-memory adds a (row, group)
    out_b = g_cnt * nb * 12
    hq_root_bound = bound(n * (g_cnt + 8) + out_b, 3.0 * n * g_cnt)
    cnt = small[1]
    hq_list_bound = bound(cnt * (4 + g_cnt + 8) + out_b, 3.0 * cnt * g_cnt)
    flat = ((torch.arange(g_cnt, device=dev) * nb)[None]
            + binned.long()).reshape(-1)
    chans = [q10.codes[:, c, None].expand(n, g_cnt).reshape(-1).float()
             for c in (0, 1)]
    w01 = q10.w01[:, None].expand(n, g_cnt).reshape(-1)

    def library():
        for c in (chans[0], chans[1], w01):
            torch.bincount(flat, weights=c, minlength=g_cnt * nb)
    rows_arg = {"rows": perm[small[0]:], "n_rows": cnt}
    times = {
        "bagging_mask": (
            median_ms(lambda: rng.bagging_mask(key, 0.8, mask)),
            median_ms(lambda: rng.bagging_mask_plain(key, 0.8, mask),
                      reps=5), m_bound, None),
        "quantize_gradients": (
            median_ms(lambda: histogram.quantize_gradients(
                g10, h10, ones, qmax=qmax, key_g=kg, key_h=kh)),
            median_ms(lambda: histogram.quantize_gradients_plain(
                g10, h10, ones, qmax, kg, kh), reps=5), q_bound, None),
        "leaf_histogram_i32": (
            median_ms(lambda: histogram.leaf_histogram_i32(
                binned, q10.codes, q10.w01, nb)),
            median_ms(lambda: histogram.leaf_histogram_i32_plain(
                binned, q10.codes, q10.w01, nb), reps=5), hq_root_bound,
            median_ms(library, reps=5))}
    del flat, chans, w01
    # the same calls' device time (device_ms, as phase 12 times H),
    # printed only
    device = {
        "bagging_mask": device_ms(lambda: rng.bagging_mask(key, 0.8, mask),
                                  ("bag_kernel",)),
        "quantize_gradients": device_ms(
            lambda: histogram.quantize_gradients(g10, h10, ones, qmax=qmax,
                                                 key_g=kg, key_h=kh),
            ("absmax_kernel", "quantize_kernel", "Memset")),
        "leaf_histogram_i32": device_ms(
            lambda: histogram.leaf_histogram_i32(binned, q10.codes, q10.w01,
                                                 nb),
            ("hist_i32_kernel", "Memset"))}
    for k, (ms, plain_ms, (b_ms, b_by), lib_ms) in times.items():
        print("time [%s | %s]: %s %.4f ms (CUDA events around the call; "
              "device time %.4f ms), plain %.3f ms, bound %.5f ms (%s)%s"
              % (name, card, k, ms, device[k], plain_ms, b_ms, b_by,
                 "" if lib_ms is None else
                 ", torch.bincount x3 %.4f ms" % lib_ms))
    list_dev = device_ms(lambda: histogram.leaf_histogram_i32(
        binned, q10.codes, q10.w01, nb, **rows_arg),
        ("hist_i32_kernel", "Memset"))
    print("time [%s | %s]: leaf_histogram_i32 row list (%d of %d rows) "
          "%.4f ms (device time %.4f ms), plain %.3f ms, bound %.5f ms (%s)"
          % (name, card, cnt, n, median_ms(
              lambda: histogram.leaf_histogram_i32(
                  binned, q10.codes, q10.w01, nb, **rows_arg)),
             list_dev,
             median_ms(lambda: histogram.leaf_histogram_i32_plain(
                 binned, q10.codes, q10.w01, nb, **rows_arg), reps=5),
             *hq_list_bound))
    print("time [%s | %s]: rounds int8 %.4f s, int8 + bagging %.4f s, f32 "
          "(phase 12) %.4f s (medians of rounds 2-%d)"
          % (name, card, med8, med_bag, ctx["rounds_s"], TRAIN_ROUNDS))
    wall_us, busy, by_kind = profile_round(b8, name, card)
    hq_us = sum(v for k, v in by_kind.items() if "hist_i32_kernel" in k)
    q_us = sum(v for k, v in by_kind.items()
               if "absmax_kernel" in k or "quantize_kernel" in k)
    print("where the time goes [%s | %s]: int8 round: HQ %.3f ms (share "
          "%.3f of device busy), Q %.3f ms%s, idle share %.3f"
          % (name, card, hq_us / 1e3, hq_us / busy, q_us / 1e3,
             "" if q_us else " (the profiler did not list Q)",
             1.0 - busy / wall_us))

    replaces = {
        "bagging_mask": "lightgbm_tpu/boosting/gbdt.py:311",
        "quantize_gradients": "lightgbm_tpu/ops/histogram.py:127",
        "leaf_histogram_i32": "lightgbm_tpu/ops/histogram.py:291"}
    sources = {"bagging_mask": "lightgbm_tpu_torch/csrc/quantize.cu",
               "quantize_gradients": "lightgbm_tpu_torch/csrc/quantize.cu",
               "leaf_histogram_i32": "lightgbm_tpu_torch/csrc/histogram.cu"}
    main_launches = dict(launches, bagging_mask=bag_launches["bagging_mask"])
    rows = []
    for k, (ms, plain_ms, (b_ms, b_by), lib_ms) in times.items():
        rows.append({"name": k, "route": "cuda", "source": sources[k],
                     "replaces": replaces[k], "launches": main_launches[k],
                     "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    return rows


# ---------------------------------------------------------------------
# linear trees (phases 17-20)
LINEAR_PARAMS = dict(TRAIN_PARAMS, linear_tree=True, linear_lambda=0.01,
                     tpu_linear_max_features=5)
# the BENCH_SHAPE=linear gate (bench.py:1562-1620): iterations a linear
# run needs to reach the constant run's final holdout l2, over 60
LINEAR_GATE_ROWS, LINEAR_GATE_ITERS, LINEAR_GATE_CEILING = 20_000, 60, 0.7


def linear_oracle(x, grad, hess, weight, perm, begin, rows, feats):
    """LF's sums in f64 on the card, with the sums of the terms'
    absolute values (the tolerance's scale)."""
    from lightgbm_tpu_torch.ops.linear import gather_values
    num_leaves, k = feats.shape
    d = k + 1
    pos = torch.full((perm.shape[0],), -1, dtype=torch.long,
                     device=x.device)
    for leaf in range(num_leaves):
        if rows[leaf]:
            pos[int(begin[leaf]):int(begin[leaf] + rows[leaf])] = leaf
    sel = pos >= 0
    r, lid = perm[sel].long(), pos[sel]
    xv, ok = gather_values(x, r, feats[lid])
    z = torch.cat([xv, torch.ones_like(xv[:, :1])], 1).double()
    w = torch.where(ok, weight[r], torch.zeros_like(weight[r])).double()
    wh, wg = w * hess[r].double(), w * grad[r].double()
    out = []
    for vals in (wh[:, None] * (z[:, :, None] * z[:, None, :]).reshape(
            -1, d * d), wg[:, None] * z):
        for v in (vals, vals.abs()):
            acc = torch.zeros((num_leaves, v.shape[1]), dtype=torch.float64,
                              device=x.device)
            out.append(acc.index_add_(0, lid, v))
    cnt = torch.zeros(num_leaves, dtype=torch.float64, device=x.device)
    cnt.index_add_(0, lid, (w > 0).double())
    a, a_abs, b, b_abs = out
    return (a.view(num_leaves, d, d), a_abs.view(num_leaves, d, d), b,
            b_abs, cnt)


def moment_oracle(binned, x, w3, num_bins, leaf_id, ids):
    """LM's per-bin moments of the rows of each leaf id and the sums of
    their terms' absolute values, in f64 on the card."""
    match = leaf_id.long()[:, None] == ids.long()[None, :]
    hit = match.any(dim=1)
    sel = torch.nonzero(hit)[:, 0]
    slot = match[hit].int().argmax(dim=1)
    del match, hit
    f_cnt, c_cnt = binned.shape[1], ids.shape[0]
    xv = x[sel].double()
    xv = torch.where(torch.isfinite(xv), xv, torch.zeros_like(xv))
    w = w3[sel].double()
    terms = torch.stack([xv * w[:, 2:3], xv * xv * w[:, 2:3],
                         xv * w[:, 0:1], xv * w[:, 1:2]], -1)
    flat = ((slot[:, None] * f_cnt
             + torch.arange(f_cnt, device=binned.device)[None]) * num_bins
            + binned[sel].long()).reshape(-1)
    out = []
    for t in (terms, terms.abs()):
        acc = torch.zeros((c_cnt * f_cnt * num_bins, 4), dtype=torch.float64,
                          device=binned.device)
        out.append(acc.index_add_(0, flat, t.reshape(-1, 4)).view(
            c_cnt, f_cnt, num_bins, 4))
    return out


def within(got, ref, scale, label):
    """|got - ref| <= 1e-5 * max(1, scale) everywhere; returns the max
    abs error."""
    d = (got.double() - ref.double()).abs()
    ok = bool((d <= 1e-5 * scale.double().clamp(min=1.0)).all())
    check(ok, "%s: off by %g" % (label, float(d.max())))
    return float(d.max())


def same_linear_trees(on_card, on_cpu, rounds):
    """same_trees, plus the same leaf features and coefficients within
    1e-5 relative; returns the worst relative coefficient difference."""
    same_trees(on_card, on_cpu, rounds)
    worst = 0.0
    for i, (a, b) in enumerate(zip(on_card._inner.models,
                                   on_cpu._inner.models)):
        check(np.array_equal(a.leaf_features, b.leaf_features),
              "card and CPU fitted on different features in tree %d" % i)
        rel = np.abs(a.leaf_coeff - b.leaf_coeff) / np.maximum(
            1.0, np.abs(b.leaf_coeff))
        worst = max(worst, float(rel.max()))
    check(worst <= 1e-5, "card/CPU coefficients differ by %g" % worst)
    return worst


def linear_gate(lgb, name, card):
    """bench.py run_linear on the card: the iteration at which a
    linear_tree booster first reaches the constant booster's final
    holdout l2, over the 60 iterations."""
    rng = np.random.RandomState(11)
    x = rng.uniform(-1.0, 1.0, (LINEAR_GATE_ROWS, 10))
    region = (x[:, 0] > 0).astype(int) * 2 + (x[:, 1] > 0).astype(int)
    planes = rng.randn(4, 10)
    bias = 2.0 * rng.randn(4)
    y = (planes[region] * x).sum(axis=1) + bias[region] \
        + 0.05 * rng.randn(LINEAR_GATE_ROWS)
    n_tr = int(LINEAR_GATE_ROWS * 0.8)
    boosters = {}
    for linear in (False, True):
        params = {"objective": "regression", "num_leaves": 31,
                  "learning_rate": 0.1, "min_data_in_leaf": 20,
                  "verbose": -1, "max_bin": 63, "linear_tree": linear,
                  "linear_lambda": 0.01}
        t0 = time.perf_counter()
        boosters[linear] = lgb.train(
            params, lgb.Dataset(x[:n_tr], y[:n_tr], params=dict(params)),
            LINEAR_GATE_ITERS, verbose_eval=False)
        boosters[linear, "s"] = time.perf_counter() - t0

    def l2(bst, i):
        pred = bst.predict(x[n_tr:], num_iteration=i)
        return float(np.mean((pred - y[n_tr:]) ** 2))
    target = l2(boosters[False], LINEAR_GATE_ITERS)
    final = l2(boosters[True], LINEAR_GATE_ITERS)
    hit = next((i for i in range(1, LINEAR_GATE_ITERS + 1)
                if l2(boosters[True], i) <= target), None)
    ratio = hit / LINEAR_GATE_ITERS if hit else float("inf")
    print("linear gate [%s | %s]: BENCH_SHAPE=linear protocol, %d rows x "
          "10, 60 rounds: constant final holdout l2 %.6f, linear %.6f, "
          "linear reaches it at iteration %s, ratio %.4f (ceiling %.1f); "
          "train seconds constant %.2f, linear %.2f"
          % (name, card, LINEAR_GATE_ROWS, target, final, hit, ratio,
             LINEAR_GATE_CEILING, boosters[False, "s"], boosters[True, "s"]))
    check(ratio <= LINEAR_GATE_CEILING, "linear gate ratio %.4f > %.1f"
          % (ratio, LINEAR_GATE_CEILING))


def linear(name, card, dev, ctx):
    """Phases 17-20; returns the JSON rows of LF, LS, LA, LM, K1 on a
    linear forest and W's leaf mode."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.learner.grow import leaf_path_features
    from lightgbm_tpu_torch.linear import leaf_feature_moments
    from lightgbm_tpu_torch.ops import (histogram, linear as lin, predict,
                                        rng, route, split)

    counted = {"linear_normal_eq": lin.linear_normal_eq,
               "linear_solve": lin.linear_solve,
               "linear_addend": lin.linear_addend,
               "tree_leaf_walk_binned": predict.tree_leaf_walk_binned,
               "leaf_histogram": histogram.leaf_histogram,
               "split_scan": split.split_scan,
               "route_partition": route.route_partition,
               "score_update": route.score_update,
               "tree_value_walk_binned": predict.tree_value_walk_binned,
               "forest_value_walk": predict.forest_value_walk,
               "quantize_gradients": histogram.quantize_gradients,
               "leaf_histogram_i32": histogram.leaf_histogram_i32,
               "bagging_mask": rng.bagging_mask}
    x, y, xv, yv = ctx["x"], ctx["y"], ctx["xv"], ctx["yv"]
    k = LINEAR_PARAMS["tpu_linear_max_features"]

    # --------------------------------------------------------------- 17
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, y, params=dict(LINEAR_PARAMS))
    valid = ds.create_valid(xv, yv)
    ds.construct()
    valid.construct()
    check(ds._inner.raw is not None and valid._inner.raw is not None
          and not ds._inner.has_bundles,
          "the linear Datasets keep no raw values, or bundle features")
    print("linear datasets: %d + %d rows with raw values, %.1f s"
          % (TRAIN_ROWS, VALID_ROWS, time.perf_counter() - t0))
    data = (ds, valid)

    def path(label, params):
        for fn in counted.values():
            fn.launches = 0
        booster, evals, update_s = train_run(
            lgb, x, y, xv, yv, params, TRAIN_ROUNDS, data=data)[:3]
        launches = {kk: fn.launches for kk, fn in counted.items()}
        gb = booster._inner
        trees = gb.models
        auc = evals["valid"]["auc"]
        print("%s path launches: %s" % (label, launches))
        check(booster.device.type == "cuda" and len(trees) == TRAIN_ROUNDS
              and all(t.is_linear for t in trees),
              label + ": %d linear trees on %s"
              % (sum(t.is_linear for t in trees), booster.device))
        check(launches["linear_normal_eq"] == launches["linear_solve"]
              == TRAIN_ROUNDS, label + ": LF/LS launched %d/%d times, not "
              "once a tree" % (launches["linear_normal_eq"],
                               launches["linear_solve"]))
        check(launches["linear_addend"] == 2 * TRAIN_ROUNDS
              and launches["tree_leaf_walk_binned"] == TRAIN_ROUNDS,
              label + ": LA %d / W leaf mode %d launches, not once a tree "
              "for the train scores and once for the valid set"
              % (launches["linear_addend"],
                 launches["tree_leaf_walk_binned"]))
        check(launches["score_update"] == 0
              and launches["tree_value_walk_binned"] == 0,
              label + ": a constant-leaf score update ran on linear trees")
        check(all(launches[kk] > 0 for kk in ("split_scan",
                                               "route_partition")),
              label + ": S or R was never launched")
        check(len(auc) == TRAIN_ROUNDS and np.isfinite(auc).all()
              and auc[-1] > auc[0], label + ": valid AUC %s did not rise"
              % auc)
        med = float(np.median(update_s[1:TRAIN_ROUNDS]))
        print("%s path: valid auc %.5f (round 1) -> %.5f (constant f32 "
              "%.5f), trees of %s leaves, fitted leaves %d of %d"
              % (label, auc[0], auc[-1], ctx["auc"][-1],
                 sorted({t.num_leaves for t in trees}),
                 sum(int(np.any(t.leaf_coeff != 0, axis=1).sum())
                     for t in trees), sum(t.num_leaves for t in trees)))
        print("time [%s | %s]: %s boosting round %.4f s (median of rounds "
              "2-%d), %.3f million row-iterations/s, rounds %s"
              % (name, card, label, med, TRAIN_ROUNDS, TRAIN_ROWS / med / 1e6,
                 " ".join("%.4f" % v for v in update_s)))
        return booster, launches, med

    booster, launches, med = path("linear", LINEAR_PARAMS)
    text = booster.model_to_string()
    again = train_run(lgb, x, y, xv, yv, LINEAR_PARAMS, TRAIN_ROUNDS,
                      data=data)[0]
    check(again.model_to_string() == text,
          "two linear runs gave different model texts")
    del again
    print("linear path: a second run gave a byte-identical model text (%d "
          "bytes)" % len(text))
    ctx["linear_text"] = text   # phase 21 early-stops this forest
    predict.forest_value_walk.launches = 0
    served = lgb.Booster(model_str=text)
    check(served.device.type == "cuda", "the served model is not on cuda")
    raw = served.predict(xv, raw_score=True)
    kept = booster._inner.valid_score(0)
    rel = float(np.max(np.abs(raw - kept) / np.maximum(1.0, np.abs(kept))))
    check(rel <= 1e-5, "served raw scores off the kept valid scores by %g"
          % rel)
    predictor = served.serving_predictor()
    predictor.warmup()
    ones = np.array([predictor.predict_one(r) for r in xv[:32]])
    predictor.close()
    check(np.array_equal(ones, served.predict(xv[:32])),
          "predict_one != predict on the linear model")
    k1_launches = predict.forest_value_walk.launches
    check(k1_launches > 0, "K1 never launched serving the linear model")
    print("linear serving: the reloaded model through K1 on %d valid rows "
          "within %.3g of the kept valid scores; 32 predict_one equal to "
          "predict (%d K1 launches)" % (VALID_ROWS, rel, k1_launches))
    # the diagnostics on the trained model: every leaf's marginal moments
    # of the last tree (LM over all rows, one leaf id a grid layer)
    gbt = booster._inner
    last = gbt.models[-1]
    leaf_of = predict.tree_leaf_walk_binned(
        predict.binned_tree(last, dev), gbt._binned).to(torch.int32)
    g_l, h_l = gbt.objective.get_gradients(gbt._score[0])
    w_l = torch.stack([g_l, h_l, torch.ones_like(g_l)], 1).contiguous()
    del g_l, h_l
    lm_ids = list(range(last.num_leaves))
    histogram.leaf_moments.launches = 0
    moments = leaf_feature_moments(gbt._binned, gbt._raw, w_l, leaf_of,
                                   lm_ids, gbt._grower.num_bins)
    lm_launches = histogram.leaf_moments.launches
    check(lm_launches > 0, "LM never launched on the trained model")
    check(tuple(moments.shape) == (last.num_leaves, FEATURES, 4)
          and bool(torch.isfinite(moments).all()),
          "leaf_feature_moments: shape %s or non-finite values"
          % (tuple(moments.shape),))
    total = moments[:, :, 0].sum(0).double()
    check(bool(((total - gbt._raw.double().sum(0)).abs()
                <= 1e-4 * gbt._raw.double().abs().sum(0)).all()),
          "leaf_feature_moments: the leaves' sum w x is not the column sum")
    print("linear diagnostics: leaf_feature_moments of the last tree's %d "
          "leaves x %d features over %d rows (%d LM launches)"
          % (last.num_leaves, FEATURES, TRAIN_ROWS, lm_launches))
    int8 = dict(LINEAR_PARAMS, tpu_hist_quantize="int8")
    b8, q_launches, med8 = path("linear int8", int8)
    check(q_launches["quantize_gradients"] == TRAIN_ROUNDS + 1
          and q_launches["leaf_histogram_i32"] > 0,
          "linear int8: Q or HQ not launched")
    del b8
    bb, bag_launches, med_bag = path(
        "linear int8 + bagging", dict(int8, bagging_fraction=0.8,
                                      bagging_freq=1))
    check(bag_launches["bagging_mask"] == TRAIN_ROUNDS,
          "linear bagging: M launched %d times"
          % bag_launches["bagging_mask"])
    del bb

    # --------------------------------------------------------------- 18
    errs = {}
    fresh = lgb.Booster(dict(LINEAR_PARAMS), train_set=ds)
    gb = fresh._inner
    raw_x = gb._raw
    grad, hess = gb.objective.get_gradients(gb._score[0])
    ones = torch.ones_like(grad)
    w3 = torch.stack([grad, hess, ones], 1).contiguous()
    st = gb._grower.grow(w3, np.ones(ds._inner.num_features, bool))
    feats = torch.from_numpy(leaf_path_features(
        st.leaf_parent, st.node_feature, st.node_left, st.node_right,
        st.num_leaves_used, k)).to(dev)
    seg = (st.perm, st.leaf_begin, st.leaf_rows)
    lf_args = (raw_x, grad, hess, ones) + seg + (feats,)
    a_k, b_k, c_k = lin.linear_normal_eq(*lf_args)
    a_r, b_r, c_r = lin.linear_normal_eq(*lf_args)
    a_p, b_p, c_p = lin.linear_normal_eq_plain(*lf_args)
    a64, a_abs, b64, b_abs, c64 = linear_oracle(*lf_args)
    check(torch.equal(a_k, a_r) and torch.equal(b_k, b_r)
          and torch.equal(c_k, c_r), "LF: a second launch gave other bits")
    check(torch.equal(c_k, c_p) and torch.equal(c_k.double(), c64),
          "LF: counts differ from the plain version or the oracle")
    errs["linear_normal_eq"] = max(
        within(a_k, a_p, a_abs, "LF A vs plain"),
        within(b_k, b_p, b_abs, "LF b vs plain"))
    within(a_k, a64, a_abs, "LF A vs f64 oracle")
    within(b_k, b64, b_abs, "LF b vs f64 oracle")
    const = torch.from_numpy(st.leaf_value).to(dev)
    lam = LINEAR_PARAMS["linear_lambda"]
    ls = [fn(a_k, b_k, c_k, feats, const, lam) for fn in (
        lin.linear_solve, lin.linear_solve, lin.linear_solve_plain)]
    check(all(torch.equal(x1, x2) for x1, x2 in zip(ls[0], ls[1])),
          "LS: a second launch gave other bits")
    check(torch.equal(ls[0][2], ls[2][2]), "LS: fitted differs from plain")
    ls_err = max(within(ls[0][i], ls[2][i], ls[2][i].abs(), "LS vs plain")
                 for i in (0, 1))
    # singular (a slope column equal to the intercept's), under-populated
    # and padded-slot leaves, at linear_lambda 0
    a_s, c_s, f_s = a_k.clone(), c_k.clone(), feats.clone()
    a_s[0, 0, :] = a_s[0, k, :]
    a_s[0, :, 0] = a_s[0, :, k]
    c_s[1] = 5.0
    f_s[2, 3:] = -1
    odd = [fn(a_s, b_k, c_s, f_s, const, 0.0) for fn in (
        lin.linear_solve, lin.linear_solve_plain)]
    check(torch.equal(odd[0][2], odd[1][2]) and not bool(odd[0][2][0])
          and not bool(odd[0][2][1]) and bool(odd[0][2][2]),
          "LS: singular / under-populated / padded leaves: fitted %s, "
          "plain %s" % (odd[0][2][:3].tolist(), odd[1][2][:3].tolist()))
    check(bool((odd[0][1][2, 3:] == 0).all()), "LS: a padded slot got a "
          "coefficient")
    errs["linear_solve"] = max(ls_err, max(
        within(odd[0][i], odd[1][i], odd[1][i].abs(), "LS odd vs plain")
        for i in (0, 1)))
    # a wide design, k = 64 of 70 columns (LF's sums split over 3 blocks
    # a leaf; LS's 65 x 65 system in shared memory), 65,536 rows in 16
    # leaves with NaN rows left out and padded slots
    gen = torch.Generator(device=dev).manual_seed(64)
    x64 = torch.randn((WIDE_ROWS, 70), device=dev, generator=gen)
    x64[::53, 3] = float("nan")
    lid64 = torch.randint(0, 16, (WIDE_ROWS,), device=dev, generator=gen,
                          dtype=torch.int32)
    feats64 = torch.stack([torch.randperm(70, device=dev, generator=gen)[:64]
                       for _ in range(16)]).to(torch.int32)
    feats64[5, 60:] = -1
    g64 = x64[:, 0].nan_to_num() - x64[:, 1] + 0.1 * torch.randn(
        WIDE_ROWS, device=dev, generator=gen)
    h64 = torch.rand(WIDE_ROWS, device=dev, generator=gen) + 0.5
    w64 = torch.ones(WIDE_ROWS, device=dev)
    lf64 = (x64, g64, h64, w64) + lin.segments_of(lid64, 16) + (feats64,)
    wide = [lin.linear_normal_eq(*lf64), lin.linear_normal_eq(*lf64),
            lin.linear_normal_eq_plain(*lf64)]
    wa64, wa_abs, wb64, wb_abs, wc64 = linear_oracle(*lf64)
    check(all(torch.equal(p1, p2) for p1, p2 in zip(wide[0], wide[1])),
          "LF k=64: a second launch gave other bits")
    check(torch.equal(wide[0][2], wide[2][2]), "LF k=64: counts differ")
    errs["linear_normal_eq"] = max(
        errs["linear_normal_eq"],
        within(wide[0][0], wide[2][0], wa_abs, "LF k=64 A vs plain"),
        within(wide[0][1], wide[2][1], wb_abs, "LF k=64 b vs plain"))
    within(wide[0][0], wa64, wa_abs, "LF k=64 A vs feats64 oracle")
    within(wide[0][1], wb64, wb_abs, "LF k=64 b vs feats64 oracle")
    c64k = torch.zeros(16, device=dev)
    ls64 = [fn(*wide[0], feats64, c64k, lam) for fn in (
        lin.linear_solve, lin.linear_solve, lin.linear_solve_plain)]
    check(all(torch.equal(p1, p2) for p1, p2 in zip(ls64[0], ls64[1]))
          and torch.equal(ls64[0][2], ls64[2][2]) and bool(ls64[0][2].all()),
          "LS k=64: repeat or fitted flags differ")
    errs["linear_solve"] = max(errs["linear_solve"], max(
        within(ls64[0][i], ls64[2][i], ls64[2][i].abs(), "LS k=64 vs plain")
        for i in (0, 1)))
    print("LF/LS at k=64 (%d rows x 70 columns, 16 leaves): equal to the "
          "plain versions as stated, repeat equal" % WIDE_ROWS)
    d64 = 65
    e64 = d64 * (d64 + 1) // 2 + d64 + 1
    for kname, kernel, plain_fn, (b_ms, b_by) in (
            ("linear_normal_eq", lambda: lin.linear_normal_eq(*lf64),
             lambda: lin.linear_normal_eq_plain(*lf64),
             bound(WIDE_ROWS * (16 + 4 * 64) + 16 * (d64 * d64 + d64 + 1)
                   * 4, WIDE_ROWS * e64 * 3.0)),
            ("linear_solve", lambda: lin.linear_solve(*wide[0], feats64,
                                                      c64k, lam),
             lambda: lin.linear_solve_plain(*wide[0], feats64, c64k, lam),
             bound(wide[0][0].numel() * 4 + wide[0][1].numel() * 8,
                   16 * d64 ** 3 / 3.0 * 2))):
        print("time [%s | %s]: %s at k=64 (%d rows, 16 leaves) %.4f ms "
              "(CUDA events around the call), plain %.3f ms, bound %.5f ms "
              "(%s)" % (name, card, kname, WIDE_ROWS, median_ms(kernel),
                        median_ms(plain_fn, reps=5), b_ms, b_by))
    del x64, wide, ls64
    value, coeff = ls[0][0], ls[0][1]
    x_nan = raw_x.clone()
    x_nan[::97, int(feats[0, 0])] = float("nan")
    x_nan[5::131, :] = float("inf")
    scores = []
    for fn in (lin.linear_addend, lin.linear_addend,
               lin.linear_addend_plain):
        sc = gb._score[0].clone()
        fn(x_nan, st.leaf_id, value, coeff, feats, sc, 0.1)
        scores.append(sc)
    check(all(torch.equal(scores[0].view(torch.int32), s.view(torch.int32))
              for s in scores[1:]),
          "LA: not bitwise equal to its repeat and plain (%d rows with NaN "
          "or inf)" % TRAIN_ROWS)
    errs["linear_addend"] = 0.0
    forest = predict.stack_trees(booster._inner.models, dev)
    xvd = torch.from_numpy(xv).to(dev)
    walks = [fn(forest, xvd) for fn in (predict.forest_value_walk,
                                        predict.forest_value_walk,
                                        predict.forest_value_walk_plain)]
    check(all(torch.equal(walks[0].view(torch.int32), w.view(torch.int32))
              for w in walks[1:]),
          "K1 (linear forest, %d rows): not bitwise equal to its repeat and "
          "plain" % VALID_ROWS)
    errs["forest_value_walk_linear"] = 0.0
    bt = predict.binned_tree(booster._inner.models[0], dev)
    vb = booster._inner._valid_binned[0]
    leaves = [fn(bt, vb) for fn in (predict.tree_leaf_walk_binned,
                                    predict.tree_leaf_walk_binned,
                                    predict.tree_leaf_walk_binned_plain)]
    check(all(torch.equal(leaves[0], lv) for lv in leaves[1:]),
          "W leaf mode: not equal to its repeat and plain")
    errs["tree_leaf_walk_binned"] = 0
    binned, nb = gb._binned, gb._grower.num_bins
    # LM as the main path called it (the last tree's leaf ids, the trained
    # model's gradients), then on the first tree's leaves, whose largest
    # one's bin-summed sum w g x is LF's b
    lm_args = {
        "main path: last tree, trained gradients": (
            w_l, leaf_of, torch.tensor(lm_ids, dtype=torch.int32,
                                       device=dev)),
        "first tree": (w3, st.leaf_id, torch.arange(
            st.num_leaves_used, dtype=torch.int32, device=dev))}
    lm_err = 0.0
    for label, (w, lid, ids) in lm_args.items():
        got = histogram.leaf_moments(binned, raw_x, w, nb, lid, ids)
        check(torch.equal(got, histogram.leaf_moments(binned, raw_x, w, nb,
                                                      lid, ids)),
              "LM (%s): a second launch gave other bits" % label)
        ref, scale = moment_oracle(binned, raw_x, w, nb, lid, ids)
        lm_err = max(lm_err, within(got, histogram.leaf_moments_plain(
            binned, raw_x, w, nb, lid, ids), scale, "LM (%s) vs plain"
            % label))
        within(got, ref, scale, "LM (%s) vs f64 oracle" % label)
        if label.startswith("main path"):
            check(torch.equal(moments, got.sum(dim=2)),
                  "leaf_feature_moments is not LM summed over bins")
            within(moments, ref.sum(dim=2), scale.sum(dim=2),
                   "leaf_feature_moments vs f64 oracle")
        del ref, scale
    errs["leaf_moments"] = lm_err
    big = int(np.argmax(st.leaf_rows))
    sums = got.sum(dim=2)[big]
    b_scale = b_abs[big]
    for j in range(k):
        f = int(feats[big, j])
        if f >= 0:
            within(sums[f, 2], b_k[big, j], b_scale[j],
                   "LM sum w g x vs LF b (leaf %d, feature %d)" % (big, f))
    print("linear kernels vs plain [%d rows, %d leaves, k %d]: LF A/b within "
          "%.3g (counts exact), LS fitted exact (singular, under-populated "
          "and padded leaves fall back or pin as plain), LA bitwise with "
          "NaN/inf rows, K1 linear bitwise on %d rows, W leaf mode equal, "
          "LM's four channels within %.3g on the main path's call (%d leaf "
          "ids) and on the first tree's leaves, leaf_feature_moments its sum "
          "over bins, equal to LF's b; every kernel repeated its bits"
          % (TRAIN_ROWS, st.num_leaves_used, k, errs["linear_normal_eq"],
             VALID_ROWS, lm_err, len(lm_ids)))

    # --------------------------------------------------------------- 19
    xs, ys = x[:CPU_ROWS], y[:CPU_ROWS]
    xvs, yvs = xv[:CPU_VALID_ROWS], yv[:CPU_VALID_ROWS]
    cpu_data = None
    for label, extra in (("linear f32", {}),
                         ("linear int8", {"tpu_hist_quantize": "int8"})):
        t0 = time.perf_counter()
        params = dict(LINEAR_PARAMS, num_leaves=CPU_LEAVES, **extra)
        on_card, ev_card, _, dsc, vsc = train_run(
            lgb, xs, ys, xvs, yvs, params, CPU_ROUNDS, data=cpu_data)
        cpu_data = (dsc, vsc)
        on_cpu, ev_cpu = train_run(lgb, xs, ys, xvs, yvs, params,
                                   CPU_ROUNDS, device="cpu",
                                   data=cpu_data)[:2]
        worst = same_linear_trees(on_card, on_cpu, CPU_ROUNDS)
        d_auc = abs(ev_card["valid"]["auc"][-1] - ev_cpu["valid"]["auc"][-1])
        check(d_auc <= 2e-3, "%s card/CPU valid AUC differ by %g"
              % (label, d_auc))
        print("card vs CPU [%s, %d rows, %d leaves, %d rounds]: same "
              "structure and leaf features, coefficients within %.3g "
              "relative, valid auc %.5f vs %.5f (%.2f s)"
              % (label, CPU_ROWS, CPU_LEAVES, CPU_ROUNDS, worst,
                 ev_card["valid"]["auc"][-1], ev_cpu["valid"]["auc"][-1],
                 time.perf_counter() - t0))

    # --------------------------------------------------------------- 20
    n, nf = raw_x.shape
    d = k + 1
    leaves = int(st.num_leaves_used)
    entries = d * (d + 1) // 2 + d + 1
    times = {}
    # LF: a row's perm entry, g, h, w and k gathered values; the tile
    # sums out and the [L] systems. Its yardstick adds the rows' weighted
    # outer products into their leaves with one index_add_
    xg, _ = lin.gather_values(raw_x, torch.arange(n, device=dev),
                              feats[st.leaf_id.long()])
    z = torch.cat([xg, torch.ones_like(xg[:, :1])], 1)
    zz = (hess[:, None] * (z[:, :, None] * z[:, None, :]).reshape(n, d * d))
    del xg, z

    def lf_library():
        acc = torch.zeros((gb.config.tree.num_leaves, d * d),
                          dtype=torch.float32, device=dev)
        acc.index_add_(0, st.leaf_id.long(), zz)
    lf_names = ("normal_eq_tile_kernel", "normal_eq_reduce_kernel")
    times["linear_normal_eq"] = (
        device_ms(lambda: lin.linear_normal_eq(*lf_args), lf_names),
        median_ms(lambda: lin.linear_normal_eq(*lf_args)),
        median_ms(lambda: lin.linear_normal_eq_plain(*lf_args), reps=5),
        bound(n * (16 + 4 * k) + leaves * (d * d + d + 1) * 4,
              n * entries * 3.0), median_ms(lf_library, reps=5))
    del zz
    ls_args = (a_k, b_k, c_k, feats, const, lam)
    eye = torch.eye(d, device=dev)
    a_lib = torch.where((c_k >= 2.0 * d)[:, None, None], a_k + eye * lam,
                        eye)
    times["linear_solve"] = (
        None, median_ms(lambda: lin.linear_solve(*ls_args)),
        median_ms(lambda: lin.linear_solve_plain(*ls_args), reps=5),
        bound(a_k.numel() * 4 + b_k.numel() * 8,
              leaves * d ** 3 / 3.0 * 2),
        median_ms(lambda: torch.linalg.solve_ex(a_lib, -b_k), reps=5))
    sc = gb._score[0].clone()
    la_args = (raw_x, st.leaf_id, value, coeff, feats, sc, 0.1)
    times["linear_addend"] = (
        device_ms(lambda: lin.linear_addend(*la_args), ("addend_kernel",)),
        median_ms(lambda: lin.linear_addend(*la_args)),
        median_ms(lambda: lin.linear_addend_plain(*la_args), reps=5),
        bound(n * (12 + 4 * k), n * (3.0 * k + 4)), None)
    # LM as the main path calls it: leaf_feature_moments over the last
    # tree's leaf ids; a row's F bins and F values, 12 bytes of channels
    # and its leaf id, and the [C, F, B, 4] output. Its yardstick adds the
    # four channels into (leaf, feature, bin) with torch.bincount
    c_lm = len(lm_ids)
    flat = (((leaf_of.long() * nf)[:, None]
             + torch.arange(nf, device=dev)[None]) * nb
            + binned.long()).reshape(-1)
    xw = torch.where(torch.isfinite(raw_x), raw_x, torch.zeros_like(raw_x))
    chans = [(xw * w_l[:, c, None]).reshape(-1) for c in (2, 0, 1)]
    chans.insert(1, (xw * xw).reshape(-1))

    def lm_library():
        for c in chans:
            torch.bincount(flat, weights=c, minlength=c_lm * nf * nb)

    def lm_call():
        return leaf_feature_moments(binned, raw_x, w_l, leaf_of, lm_ids, nb)
    ids_dev = torch.tensor(lm_ids, dtype=torch.int32, device=dev)
    times["leaf_moments"] = (
        device_ms(lm_call, ("moment_count_kernel", "moment_scan_kernel",
                            "moment_scatter_kernel", "moment_tile_kernel",
                            "moment_reduce_kernel")),
        median_ms(lm_call),
        median_ms(lambda: histogram.leaf_moments_plain(
            binned, raw_x, w_l, nb, leaf_of, ids_dev), reps=5),
        bound(n * (5 * nf + 16) + c_lm * nf * nb * 16, 8.0 * n * nf),
        median_ms(lm_library, reps=5))
    del flat, xw, chans
    # K1 on the linear forest: node visits, and k loads and multiply-adds
    # a (row, tree)
    leaf = predict.forest_leaf_walk_plain(forest, xvd)
    depth = torch.from_numpy(leaf_depths(booster._inner.models)).to(dev)
    visits = int(depth.gather(1, leaf.t().long()).sum())
    walk_ops = visits * INSTR_PER_VISIT + VALID_ROWS * TRAIN_ROUNDS * k * 4
    times["forest_value_walk_linear"] = (
        None, median_ms(lambda: predict.forest_value_walk(forest, xvd)),
        median_ms(lambda: predict.forest_value_walk_plain(forest, xvd),
                  reps=5),
        bound(xvd.numel() * 4 + VALID_ROWS * 4 + forest.nbytes(), walk_ops),
        None)
    vleaf = predict.tree_leaf_binned_plain(bt, vb)
    dep0 = torch.from_numpy(leaf_depths(booster._inner.models[:1])[0]).to(dev)
    v0 = int(dep0[vleaf].sum())
    times["tree_leaf_walk_binned"] = (
        device_ms(lambda: predict.tree_leaf_walk_binned(bt, vb),
                  ("walk_kernel",)),
        median_ms(lambda: predict.tree_leaf_walk_binned(bt, vb)),
        median_ms(lambda: predict.tree_leaf_walk_binned_plain(bt, vb),
                  reps=5),
        bound(v0 + 4 * VALID_ROWS + bt.nodes.numel() * 4,
              v0 * INSTR_PER_VISIT), None)
    for kk, (dev_ms, ev_ms, plain_ms, (b_ms, b_by), lib_ms) in times.items():
        print("time [%s | %s]: %s %.4f ms (CUDA events around the call; "
              "device time %s), plain %.3f ms, bound %.5f ms (%s), library "
              "%s, %s launches on the main path"
              % (name, card, kk, ev_ms, "not measured" if dev_ms is None
                 else "%.4f ms" % dev_ms, plain_ms, b_ms, b_by,
                 "none" if lib_ms is None else "%.4f ms" % lib_ms,
                 {"forest_value_walk_linear": k1_launches,
                  "leaf_moments": lm_launches}.get(kk, launches.get(kk))))
    print("time [%s | %s]: rounds linear %.4f s, linear int8 %.4f s, linear "
          "int8 + bagging %.4f s, constant f32 (phase 12) %.4f s (medians of "
          "rounds 2-%d)" % (name, card, med, med8, med_bag, ctx["rounds_s"],
                            TRAIN_ROUNDS))
    wall_us, busy, by_kind = profile_round(booster, name, card)
    lin_us = {kk: sum(v for n_, v in by_kind.items() if kk in n_)
              for kk in ("normal_eq", "solve_kernel", "addend_kernel")}
    print("where the time goes [%s | %s]: linear round: LF %.3f ms, LS %.3f "
          "ms, LA %.3f ms of %.3f ms device busy, idle share %.3f"
          % (name, card, lin_us["normal_eq"] / 1e3,
             lin_us["solve_kernel"] / 1e3, lin_us["addend_kernel"] / 1e3,
             busy / 1e3, 1.0 - busy / wall_us))
    linear_gate(lgb, name, card)

    replaces = {
        "linear_normal_eq": "lightgbm_tpu/linear/solver.py:54",
        "linear_solve": "lightgbm_tpu/linear/solver.py:54",
        "linear_addend": "lightgbm_tpu/linear/solver.py:143",
        "leaf_moments": "lightgbm_tpu/ops/histogram.py:679",
        "forest_value_walk_linear": "lightgbm_tpu/ops/predict.py:163",
        "tree_leaf_walk_binned": "lightgbm_tpu/ops/predict.py:87"}
    sources = {
        "linear_normal_eq": "lightgbm_tpu_torch/csrc/linear.cu",
        "linear_solve": "lightgbm_tpu_torch/csrc/linear.cu",
        "linear_addend": "lightgbm_tpu_torch/csrc/linear.cu",
        "leaf_moments": "lightgbm_tpu_torch/csrc/moments.cu",
        "forest_value_walk_linear": "lightgbm_tpu_torch/csrc/forest_walk.cu",
        "tree_leaf_walk_binned": "lightgbm_tpu_torch/csrc/binned_walk.cu"}
    main = dict(launches, forest_value_walk_linear=k1_launches,
                leaf_moments=lm_launches)
    rows = []
    for kk, (dev_ms, ev_ms, plain_ms, (b_ms, b_by), lib_ms) in times.items():
        rows.append({"name": kk, "route": "cuda", "source": sources[kk],
                     "replaces": replaces[kk],
                     "launches": main.get(kk, 0), "max_abs_err": errs[kk],
                     "ms": ev_ms if dev_ms is None else dev_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    return rows


def profile_round(booster, name, card):
    """torch.profiler over one more boosting round of the trained
    booster: device busy time (the union of its events' intervals)
    against the host wall clock, and the top operations. Returns (wall
    us, busy us, device us by kernel name)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events, busy = device_busy(prof)
    by_kind = {}
    for e in events:
        kind = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        kind = kind[:48]
        by_kind[kind] = by_kind.get(kind, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_kind.items(), key=lambda kv: -kv[1])[:8]
    print("where the time goes [%s | %s]: one boosting round wall %.2f ms, "
          "device busy %.2f ms (idle share %.3f), %d device events: %s"
          % (name, card, wall_us / 1e3, busy / 1e3, 1.0 - busy / wall_us,
             len(events),
             "; ".join("%s %.3f ms" % (k, v / 1e3) for k, v in top)))
    return wall_us, busy, by_kind


# ---------------------------------------------------------------------
# ranking (phases 5-8)
def rank_oracle(score, qb, label, gain, inv, sigmoid):
    """The lambdarank gradients in float64 torch ops on the inputs'
    device, over padded query batches with ranks counted from their
    definition, and each doc's sums of absolute pair terms (the scale of
    the f32 tolerance). Returns f64 [4, n]: grad, hess, and the two
    absolute sums."""
    dev = score.device
    bounds = qb.cpu().numpy().astype(np.int64)
    sizes = np.diff(bounds)
    out = torch.zeros(4, score.shape[0], dtype=torch.float64, device=dev)
    width = 2 ** np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64)
    for d in sorted(set(width[sizes > 1].tolist())):
        qs = np.nonzero((width == d) & (sizes > 1))[0]
        offs = np.arange(d)
        per = max(1, (1 << 22) // (d * d))
        earlier = (torch.arange(d, device=dev)[None, :]
                   < torch.arange(d, device=dev)[:, None])
        for lo in range(0, len(qs), per):
            batch = qs[lo:lo + per]
            m_np = offs[None] < sizes[batch][:, None]
            idx = torch.from_numpy(np.where(
                m_np, bounds[batch][:, None] + offs[None], 0)).to(dev)
            m = torch.from_numpy(m_np).to(dev)
            s = torch.where(m, score[idx].double(), 0.0)
            lab, g = label[idx], gain[idx].double()
            iq = inv[torch.from_numpy(batch).to(dev)].double()
            # rank_d: the docs above d, and those tied with d before it
            ahead = (s[:, None, :] > s[:, :, None]) | (
                (s[:, None, :] == s[:, :, None]) & earlier)
            rank = (ahead & m[:, None, :]).sum(2).double()
            disc = 1.0 / torch.log2(rank + 2.0)
            norm = ((s != s[:, :1]) & m).any(1)[:, None, None]
            ds = s[:, :, None] - s[:, None, :]
            delta = ((g[:, :, None] - g[:, None, :])
                     * (disc[:, :, None] - disc[:, None, :]).abs()
                     * iq[:, None, None])
            delta = torch.where(norm, delta / (0.01 + ds.abs()), delta)
            p = 2.0 / (1.0 + torch.exp(2.0 * sigmoid * ds))
            valid = (m[:, :, None] & m[:, None, :]
                     & (lab[:, :, None] > lab[:, None, :]))
            lam = torch.where(valid, -delta * p, 0.0)
            hp = torch.where(valid, 2.0 * delta * p * (2.0 - p), 0.0)
            rows = idx[m]
            out[0, rows] = (lam.sum(2) - lam.sum(1))[m]
            out[1, rows] = (hp.sum(2) + hp.sum(1))[m]
            out[2, rows] = (lam.abs().sum(2) + lam.abs().sum(1))[m]
            out[3, rows] = (hp.abs().sum(2) + hp.abs().sum(1))[m]
    return out


def rank_err(got, ref, scale, label):
    """grad and hess within 1e-5 * max(1, scale) of ref; returns the
    max abs error."""
    worst = 0.0
    for k, what in ((0, "grad"), (1, "hess")):
        d = (got[k].double() - ref[k].double()).abs()
        lim = 1e-5 * scale[k].double().clamp(min=1.0)
        check(bool((d <= lim).all()), "%s: %s off by %g where %g is allowed"
              % (label, what, float(d.max()), float(lim[d.argmax()])))
        worst = max(worst, float(d.max()))
    return worst


def rank_work(obj):
    """(bytes, operations) L's least work needs on an objective's
    layout: score, label and gain in and grad, hess out a doc, the
    boundaries and inverse max DCGs; cnt^2 rank compares a query and
    the (high, low) pairs with differing labels."""
    qb = obj.query_boundaries.cpu().numpy().astype(np.int64)
    sizes = np.diff(qb)
    lab = obj.label_int.cpu().numpy().astype(np.int64)
    lab = lab - lab.min() if len(lab) else lab
    qid = np.repeat(np.arange(len(sizes)), sizes)
    width = int(lab.max()) + 1 if len(lab) else 1
    per_label = np.bincount(qid * width + lab,
                            minlength=len(sizes) * width).astype(np.float64)
    same = per_label.reshape(len(sizes), width) ** 2
    squares = float((sizes.astype(np.float64) ** 2).sum())
    pairs = (squares - float(same.sum())) / 2.0
    n, nq = len(lab), len(sizes)
    return (20.0 * n + 8.0 * nq + 4.0,
            squares * INSTR_PER_COMPARE + pairs * INSTR_PER_PAIR)


def rank_layout(sizes, labels, dev):
    """The port's lambdarank objective initialised on a query layout."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.objectives import LambdarankNDCG
    md = Metadata(int(sizes.sum()))
    md.set_label(labels.astype(np.float32))
    md.set_group(sizes)
    obj = LambdarankNDCG(Config.from_params({"objective": "lambdarank"}))
    obj.init(md, int(sizes.sum()), dev)
    return obj


def check_rank_kernel(obj, score, label, sample):
    """Phase 9 on one layout and score: L twice (same bits), against its
    plain version and the f64 oracle on the card, then the queries of
    `sample` against the f64 oracle on the host. Returns L's max abs
    error against the plain version."""
    from lightgbm_tpu_torch.ops import rank
    args = (score, obj.query_boundaries, obj.label_int, obj.gain,
            obj.inv_max_dcg, obj.sigmoid)
    got = rank.lambdarank_grads(*args)
    again = rank.lambdarank_grads(*args)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          label + ": a second launch of L gave other bits")
    plain = rank.lambdarank_grads_plain(*args)
    oracle = rank_oracle(*args)
    err = rank_err(got, plain, oracle[2:], label + " (L vs plain)")
    rank_err(got, oracle[:2], oracle[2:], label + " (L vs f64 oracle)")
    qb = obj.query_boundaries.cpu().numpy().astype(np.int64)
    sizes = np.diff(qb)[sample]
    docs = torch.from_numpy(np.concatenate(
        [np.arange(qb[q], qb[q + 1]) for q in sample])).to(score.device)
    sub_qb = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]))
    host = rank_oracle(score[docs].cpu(), sub_qb, obj.label_int[docs].cpu(),
                       obj.gain[docs].cpu(),
                       obj.inv_max_dcg[torch.from_numpy(sample).to(
                           score.device)].cpu(), obj.sigmoid)
    rank_err([t[docs].cpu() for t in got], host[:2], host[2:],
             label + " (L vs the host f64 oracle, %d queries of %s docs)"
             % (len(sample), sorted(set(sizes.tolist()))))
    return err


def ranking(name, card, dev):
    """Phases 5-8; returns L's JSON row."""
    import os
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import histogram, predict, rank, route, split
    from lightgbm_tpu_torch.testing.synth import mslr_like_groups, rank_data

    counted = {"lambdarank_grads": rank.lambdarank_grads,
               "leaf_histogram": histogram.leaf_histogram,
               "split_scan": split.split_scan,
               "route_partition": route.route_partition,
               "score_update": route.score_update,
               "tree_value_walk_binned": predict.tree_value_walk_binned}

    # ---------------------------------------------------------------- 5
    t0 = time.perf_counter()
    x, y, nq, qlen = rank_data(RANK_ROWS + RANK_VALID_ROWS, qlen=RANK_QLEN,
                               seed=RANK_SEED)
    check(nq * qlen == RANK_ROWS + RANK_VALID_ROWS, "rank_data queries")
    xt, yt, xv, yv = x[:RANK_ROWS], y[:RANK_ROWS], x[RANK_ROWS:], \
        y[RANK_ROWS:]
    gt = [RANK_QLEN] * (RANK_ROWS // RANK_QLEN)
    gv = [RANK_QLEN] * (RANK_VALID_ROWS // RANK_QLEN)
    print("ranking data: rank_data %d + %d rows x %d features, queries of "
          "%d docs, labels %s, in %.1f s"
          % (RANK_ROWS, RANK_VALID_ROWS, x.shape[1], RANK_QLEN,
             sorted(set(y.astype(int).tolist())), time.perf_counter() - t0))
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    booster, evals, update_s, ds, valid = train_run(
        lgb, xt, yt, xv, yv, RANK_PARAMS, TRAIN_ROUNDS, group=gt, group_v=gv)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    print("ranking main path launches:", launches)
    check(launches["lambdarank_grads"] == TRAIN_ROUNDS,
          "L launched %d times in %d rounds" % (launches["lambdarank_grads"],
                                                TRAIN_ROUNDS))
    check(all(v > 0 for v in launches.values()),
          "a kernel of the ranking main path was never launched")
    check(booster.device.type == "cuda" and booster.num_trees()
          == TRAIN_ROUNDS, "ranking: %d trees on %s"
          % (booster.num_trees(), booster.device))
    ndcg = evals["valid"]["ndcg@10"]
    check(len(ndcg) == TRAIN_ROUNDS and all(np.isfinite(ndcg))
          and ndcg[-1] > ndcg[0], "valid ndcg@10 %s did not rise" % ndcg)
    text = booster.model_to_string()
    check("objective=lambdarank" in text, "model text objective")
    print("ranking main path: %d rounds, %d trees of %s leaves, valid "
          "ndcg@10 %.5f (round 1) -> %.5f, %.1f s with dataset "
          "construction" % (TRAIN_ROUNDS, booster.num_trees(),
                            sorted({t.num_leaves
                                    for t in booster._inner.models}),
                            ndcg[0], ndcg[-1], wall))
    again = train_run(lgb, xt, yt, xv, yv, RANK_PARAMS, TRAIN_ROUNDS,
                      group=gt, group_v=gv)[0]
    check(again.model_to_string() == text,
          "two ranking runs gave different model texts")
    del again
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ranker.txt")
    booster.save_model(path)
    predict.forest_value_walk.launches = 0
    served = lgb.Booster(model_file=path)
    check(served.device.type == "cuda", "served ranker not on cuda")
    raw = served.predict(xv, raw_score=True)
    value = served.predict(xv)
    check(predict.forest_value_walk.launches > 0,
          "serving the ranker did not launch K1")
    ref = booster._inner.valid_score(0)
    rel = float(np.max(np.abs(raw - ref) / np.maximum(1.0, np.abs(ref))))
    check(rel <= 1e-5, "served raw scores off W's valid scores by %g" % rel)
    check(float(np.max(np.abs(value - raw))) <= 1e-6 * max(
        1.0, float(np.abs(raw).max())), "identity output != raw score")
    served_ndcg = dict((k, v) for k, v in (
        booster._inner.valid_metrics[0][0].eval(raw, None)))["ndcg@10"]
    check(abs(served_ndcg - ndcg[-1]) <= 1e-3,
          "served ndcg@10 %.6f vs %.6f in training" % (served_ndcg, ndcg[-1]))
    print("ranking main path: a second run gave a byte-identical model text "
          "(%d bytes); the saved model served through K1 (%d launches) on "
          "%d valid rows: raw within %.3g of W's scores, ndcg@10 %.5f"
          % (len(text), predict.forest_value_walk.launches, RANK_VALID_ROWS,
             rel, served_ndcg))
    ranker = lgb.LGBMRanker(
        n_estimators=2, num_leaves=RANK_PARAMS["num_leaves"],
        learning_rate=RANK_PARAMS["learning_rate"],
        max_bin=RANK_PARAMS["max_bin"],
        min_child_samples=RANK_PARAMS["min_data_in_leaf"],
        min_child_weight=RANK_PARAMS["min_sum_hessian_in_leaf"])
    ranker.fit(xt, yt, group=gt, eval_set=[(xv, yv)], eval_group=[gv],
               eval_at=[10])
    check(ranker.booster_.device.type == "cuda", "LGBMRanker not on cuda")
    two = lgb.train(dict(RANK_PARAMS),
                    lgb.Dataset(xt, yt, group=gt, params=dict(RANK_PARAMS)),
                    2, verbose_eval=False)
    check(ranker.booster_.model_to_string() == two.model_to_string(),
          "LGBMRanker and train gave different model texts")
    print("ranking main path: LGBMRanker fit 2 rounds on the card, the "
          "model text of train with the same params; its valid ndcg@10 %s"
          % ranker.evals_result_["valid_0"]["ndcg@10"])

    # ---------------------------------------------------------------- 6
    errs = []
    obj = booster._inner.objective
    n = RANK_ROWS
    proto_sample = np.array([0, 1, len(gt) // 2, len(gt) - 1])
    gen = torch.Generator(device=dev).manual_seed(3)
    scores = {"zero": torch.zeros(n, device=dev),
              "seeded": torch.randn(n, generator=gen, device=dev),
              "after %d rounds" % TRAIN_ROUNDS: booster._inner._score[0]}
    for label, score in scores.items():
        errs.append(check_rank_kernel(obj, score.contiguous(),
                                      "L protocol, %s scores" % label,
                                      proto_sample))
    sizes, labels = mslr_like_groups(0)
    mslr = rank_layout(sizes, labels, dev)
    n_mslr = int(sizes.sum())
    mslr_score = torch.randn(n_mslr, generator=gen, device=dev)
    mslr_sample = np.array([0, 1, 4, 5] + list(np.random.RandomState(
        0).choice(np.arange(8, len(sizes)), 4, replace=False)))
    errs.append(check_rank_kernel(mslr, mslr_score, "L MSLR-shaped",
                                  mslr_sample))
    cap = rank.stage_cap()
    long_sizes = np.array([cap + 1000, 7, cap + 1])
    long_labels = np.random.RandomState(1).randint(0, 5, long_sizes.sum())
    long = rank_layout(long_sizes, long_labels, dev)
    errs.append(check_rank_kernel(
        long, torch.randn(int(long_sizes.sum()), generator=gen, device=dev),
        "L above the %d-doc stage cap" % cap, np.arange(3)))
    print("L vs plain [protocol %d x %d at zero, seeded and trained scores; "
          "MSLR-shaped %d queries, %d docs, up to %d a query; queries of %s "
          "docs above the stage cap]: grad and hess within 1e-5 * max(1, A) "
          "of plain (max abs err %.3g), of the f64 oracle on the card and of "
          "the f64 host oracle on sampled queries; every launch repeated "
          "its bits" % (len(gt), RANK_QLEN, len(sizes), n_mslr,
                        int(sizes.max()), long_sizes.tolist(), max(errs)))

    # ---------------------------------------------------------------- 7
    cpu_params = dict(RANK_PARAMS, num_leaves=CPU_LEAVES)
    cs, cv = RANK_CPU_ROWS, RANK_CPU_VALID_ROWS
    cg, cgv = gt[:cs // RANK_QLEN], gv[:cv // RANK_QLEN]
    t0 = time.perf_counter()
    on_card, ev_card = train_run(lgb, xt[:cs], yt[:cs], xv[:cv], yv[:cv],
                                 cpu_params, RANK_CPU_ROUNDS, group=cg,
                                 group_v=cgv)[:2]
    on_cpu, ev_cpu = train_run(lgb, xt[:cs], yt[:cs], xv[:cv], yv[:cv],
                               cpu_params, RANK_CPU_ROUNDS, device="cpu",
                               group=cg, group_v=cgv)[:2]
    worst = same_trees(on_card, on_cpu, RANK_CPU_ROUNDS)
    d_ndcg = max(abs(a - b) for a, b in zip(ev_card["valid"]["ndcg@10"],
                                            ev_cpu["valid"]["ndcg@10"]))
    check(d_ndcg <= 1e-5, "card/CPU valid ndcg@10 differ by %g" % d_ndcg)
    print("ranking card vs CPU [%d rows, %d leaves, %d rounds]: same "
          "structure, leaf values within %.3g relative, valid ndcg@10 %.6f "
          "vs %.6f (%.2f s)" % (cs, CPU_LEAVES, RANK_CPU_ROUNDS, worst,
                               ev_card["valid"]["ndcg@10"][-1],
                               ev_cpu["valid"]["ndcg@10"][-1],
                               time.perf_counter() - t0))

    # ---------------------------------------------------------------- 8
    med = float(np.median(update_s[1:TRAIN_ROUNDS]))
    print("time [%s | %s]: ranking boosting round %.4f s (median of rounds "
          "2-%d), %.3f million row-iterations/s, rounds %s"
          % (name, card, med, TRAIN_ROUNDS, RANK_ROWS / med / 1e6,
             " ".join("%.4f" % v for v in update_s)))
    times = {}
    for label, o, score, reps in (
            ("protocol", obj, booster._inner._score[0].contiguous(), 3),
            ("MSLR-shaped", mslr, mslr_score, 3)):
        args = (score, o.query_boundaries, o.label_int, o.gain,
                o.inv_max_dcg, o.sigmoid)
        b_ms, b_by = bound(*rank_work(o))
        times[label] = (median_ms(lambda: rank.lambdarank_grads(*args)),
                        median_ms(lambda: rank.lambdarank_grads_plain(*args),
                                  reps=reps), b_ms, b_by)
        print("time [%s | %s]: lambdarank_grads %s (%d docs, %d queries) "
              "%.4f ms, plain %.3f ms, bound %.5f ms (%s)"
              % (name, card, label, score.shape[0],
                 o.inv_max_dcg.shape[0], *times[label]))
    # L's part of the profiled round from CUDA events around its call:
    # torch.profiler left L's kernel out of some rounds (PERF.md)
    obj_grads = obj.get_gradients
    spans = []

    def timed_grads(score):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = obj_grads(score)
        end.record()
        spans.append((start, end))
        return out
    before = rank.lambdarank_grads.launches
    obj.get_gradients = timed_grads
    try:
        wall_us, busy, by_kind = profile_round(booster, name, card)
    finally:
        del obj.get_gradients
    check(rank.lambdarank_grads.launches == before + 1 and len(spans) == 1,
          "the profiled round launched L %d times"
          % (rank.lambdarank_grads.launches - before))
    l_us = spans[0][0].elapsed_time(spans[0][1]) * 1e3
    listed = sum(v for k, v in by_kind.items() if "lambdarank_kernel" in k)
    busy_all = busy + (0.0 if listed else l_us)
    print("where the time goes [%s | %s]: lambdarank_grads %.3f ms of the "
          "round (CUDA events around its call; the profiler %s), share %.3f "
          "of %.2f ms device busy, idle share %.3f"
          % (name, card, l_us / 1e3, "listed %.3f ms" % (listed / 1e3)
             if listed else "did not list it", l_us / busy_all,
             busy_all / 1e3, 1.0 - busy_all / wall_us))
    ms, plain_ms, b_ms, b_by = times["protocol"]
    return {"name": "lambdarank_grads", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/lambdarank.cu",
            "replaces": "lightgbm_tpu/objectives.py:438",
            "launches": launches["lambdarank_grads"],
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# the serving extras (phases 21-24)
ES_FREQ = 10              # pred_early_stop_freq of the main path
CONTRIB_ROWS, FILE_ROWS = 2_048, 4_096
CONT_ROUNDS, CONT_CPU_ROUNDS = 10, 3
OUT_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
# QC's least work a cell: load, NaN and flush tests, the missing test,
# and per binary-search step a load, a flush, a compare and an add
INSTR_PER_CODE, INSTR_PER_STEP = 10, 4


def bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def walked_visits(depth, leaf_t, iters):
    """Node visits of the trees each row walked: depth [T, L] of a
    K = 1 stack, leaf_t [T, N] its rows' leaves, iters [N]."""
    d = depth.gather(1, leaf_t.long())
    walked = (torch.arange(depth.shape[0], device=depth.device)[:, None]
              < iters[None, :].long())
    return int((d * walked).sum())


def margin_median(raw, k):
    """The median margin of [K, N] raw scores (2|raw| for K = 1)."""
    if k == 1:
        return float((2.0 * raw[0].abs()).median())
    top = torch.topk(raw.t(), 2, dim=1).values
    return float((top[:, 0] - top[:, 1]).median())


def check_early_stop(label, P, stack, x, margins, freqs, errs):
    """ES against its plain version, bitwise, at each margin and freq,
    and launched twice repeating its bits; returns {(margin, freq):
    iters} of the kernel."""
    out = {}
    for m in margins:
        for freq in freqs:
            got, it = P.forest_early_stop_walk(stack, x, m, freq,
                                               return_iters=True)
            again, it2 = P.forest_early_stop_walk(stack, x, m, freq,
                                                  return_iters=True)
            ref, it_p = P.forest_early_stop_walk_plain(stack, x, m, freq)
            check(bitwise(got, ref) and torch.equal(it, it_p),
                  "ES [%s, margin %g, freq %d] not bitwise equal to plain"
                  % (label, m, freq))
            check(bitwise(got, again) and torch.equal(it, it2),
                  "ES [%s]: a second launch gave other bits" % label)
            errs["forest_early_stop_walk"] = max(
                errs["forest_early_stop_walk"],
                float((got - ref).abs().max()))
            out[(m, freq)] = it
    return out


def serving_extras(name, card, dev, ctx, phase2_text):
    """Phases 21-24; returns the JSON rows of ES, QC, QW and K1's f16
    mode. `phase2_text` is phase 2's (unbinned) synthetic forest."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import predict as P
    from lightgbm_tpu_torch.ops import histogram, route, split
    from lightgbm_tpu_torch.testing.synth import (
        edge_case_rows, grid_edge_rows, synthetic_forest_text,
        synthetic_rows)

    kernels = {"forest_early_stop_walk": P.forest_early_stop_walk,
               "quant_codes": P.quant_codes,
               "forest_quant_walk": P.forest_quant_walk,
               "forest_value_walk_f16": P.forest_value_walk_f16}
    errs = dict.fromkeys(kernels, 0.0)
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    # --------------------------------------------------------------- 21
    # phase 2's forests, binned: thresholds from <= 254 bounds a feature
    # and one missing type a feature, as a model trained at max_bin 255
    # has them (the phase-2 forest's thousands of distinct thresholds a
    # feature have no int8 layout)
    t0 = time.perf_counter()
    texts = {"full": synthetic_forest_text(0, TREES, LEAVES, FEATURES,
                                           max_bin=255),
             "categorical": synthetic_forest_text(1, 50, 63, FEATURES,
                                                  cat_features=4,
                                                  max_bin=255)}
    phase2 = lgb.Booster(model_str=phase2_text, device="cpu")._inner.models
    print("binned synthetic forests: %.1f s" % (time.perf_counter() - t0))
    try:
        P.stack_trees_quant(phase2, dev)
        refused = ""
    except P.QuantRefused as exc:
        refused = str(exc)
    check("distinct split thresholds" in refused,
          "the unbinned phase-2 forest was not refused an int8 layout")
    margin = None
    es_rows = None
    for label, cats in (("full", 0), ("categorical", 4)):
        trees = lgb.Booster(model_str=texts[label],
                            device="cpu")._inner.models
        half = CHECK_ROWS // 2
        rows = np.concatenate([
            synthetic_rows(2, half, FEATURES, cats),
            edge_case_rows(trees, FEATURES, 3, half, cats),
            grid_edge_rows(trees, FEATURES, 5, 4096)])
        x = torch.from_numpy(rows).to(dev)
        qf = P.stack_trees_quant(trees, dev)
        f16 = P.to_f16(P.stack_trees(trees, dev))
        codes = P.quant_codes(qf, x)
        codes_p = P.quant_codes_plain(qf, x)
        check(torch.equal(codes, codes_p)
              and torch.equal(codes, P.quant_codes(qf, x)),
              label + ": QC codes differ from plain or from a repeat")
        qw = [P.forest_quant_walk(qf, codes, x),
              P.forest_quant_walk(qf, codes, x),
              P.forest_quant_walk_plain(qf, codes_p, x)]
        hw = [P.forest_value_walk_f16(f16, x),
              P.forest_value_walk_f16(f16, x),
              P.forest_value_walk_plain(f16, x)]
        torch.cuda.synchronize()
        check(bitwise(qw[0], qw[2]) and bitwise(qw[0], qw[1]),
              label + ": QW not bitwise equal to plain and its repeat")
        check(bitwise(hw[0], hw[2]) and bitwise(hw[0], hw[1]),
              label + ": K1-f16 not bitwise equal to plain and its repeat")
        check(bitwise(qw[0], hw[0]),
              label + ": QW and K1-f16 not bitwise equal")
        errs["quant_codes"] = max(errs["quant_codes"], float(
            (codes.int() - codes_p.int()).abs().max()))
        errs["forest_quant_walk"] = max(errs["forest_quant_walk"], float(
            (qw[0] - qw[2]).abs().max()))
        errs["forest_value_walk_f16"] = max(
            errs["forest_value_walk_f16"], float((hw[0] - hw[2]).abs().max()))
        print("kernels vs plain [%s, %d trees, %d rows, grid %s]: QC "
              "codes equal (%d to %d), QW and K1-f16 bitwise equal to "
              "plain, to their repeats and to each other"
              % (label, len(trees), len(rows), tuple(qf.grid.shape),
                 int(codes.min()), int(codes.max())))
        t_half = len(trees) // 2
        raw_half = P.forest_value_walk(P.stack_trees(trees[:t_half], dev), x)
        med = margin_median(raw_half[None], 1)
        stack = P.stack_trees_early_stop(trees, 1, len(trees), dev)
        iters = check_early_stop(label, P, stack, x, (0.0, med, 1e30),
                                 (1, 10), errs)
        it = iters[(med, 10)]
        # rows frozen at each check (iterations 10, 20, ...; the last
        # count holds the rows that never froze)
        hist = np.bincount(it.cpu().numpy() // 10,
                           minlength=len(trees) // 10 + 1)[1:]
        check(bool((it == 10).any()) and bool((it == len(trees)).any()),
              label + ": at the median margin no row froze at the first "
              "check, or every row froze")
        print("ES [%s]: bitwise equal to plain at freq 1 and 10, margins 0, "
              "%.6g (median 2|raw| at iteration %d) and 1e30; rows frozen "
              "at checks 10, 20, ... at the median, freq 10: %s" % (label, med, t_half,
                                   " ".join(str(int(c)) for c in hist)))
        if label == "full":
            margin, es_rows = med, x
    # K = 3: three class forests, stored iteration-major
    t0 = time.perf_counter()
    per_class = [lgb.Booster(model_str=synthetic_forest_text(
        20 + c, 100, 63, FEATURES), device="cpu")._inner.models
                 for c in range(3)]
    models = [per_class[c][t] for t in range(100) for c in range(3)]
    stack3 = P.stack_trees_early_stop(models, 3, 100, dev)
    full3 = P.forest_early_stop_walk(stack3, es_rows, 1e30, 1)
    med3 = margin_median(full3, 3)
    iters = check_early_stop("K=3", P, stack3, es_rows, (0.0, med3, 1e30),
                             (1, 10), errs)
    print("ES [K=3, 3 x 100 trees x 63 leaves]: bitwise equal to plain, "
          "margins 0, %.6g (median top-1 minus top-2) and 1e30, freq 1 "
          "and 10; rows frozen at the first check %d, never %d (%.1f s)"
          % (med3, int((iters[(med3, 10)] == 10).sum()),
             int((iters[(med3, 10)] == 100).sum()),
             time.perf_counter() - t0))
    # phase 17's linear forest, on the valid rows with NaN and inf cells
    lin_trees = lgb.Booster(model_str=ctx["linear_text"],
                            device="cpu")._inner.models
    xl = torch.from_numpy(ctx["xv"][:CHECK_ROWS].copy()).to(dev)
    xl[::97, 0] = float("nan")
    xl[5::131, 1] = float("inf")
    stack_l = P.stack_trees_early_stop(lin_trees, 1, len(lin_trees), dev)
    check(stack_l.linear_k > 0, "the phase-17 stack has no linear leaves")
    med_l = margin_median(P.forest_early_stop_walk(stack_l, xl, 1e30, 1), 1)
    check_early_stop("linear", P, stack_l, xl, (0.0, med_l, 1e30), (1, 3),
                     errs)
    print("ES [phase-17 linear forest, %d trees, k %d]: bitwise equal to "
          "plain, margins 0, %.6g and 1e30, freq 1 and 3"
          % (len(lin_trees), stack_l.linear_k, med_l))

    # --------------------------------------------------------------- 22
    text = texts["full"]
    trees = lgb.Booster(model_str=text, device="cpu")._inner.models
    bulk = synthetic_rows(4, BULK_ROWS, FEATURES)
    xb = torch.from_numpy(bulk).to(dev)
    for fn in kernels.values():
        fn.launches = 0
    booster = lgb.Booster(model_str=text)
    check(booster.device.type == "cuda", "default device is not cuda")
    bias = booster._inner.init_score_bias
    es_kw = dict(pred_early_stop=True, pred_early_stop_freq=ES_FREQ,
                 pred_early_stop_margin=margin)
    es_value = booster.predict(bulk, **es_kw)
    es_raw = booster.predict(bulk, raw_score=True, **es_kw)
    quant = {}
    for mode in ("f16", "int8"):
        params = {"tpu_predict_quantize": mode}
        qb = lgb.Booster(model_str=text, params=params)
        value = qb.predict(bulk)
        raw = qb.predict(bulk, raw_score=True)
        key = ("value", TREES, 1, mode)
        delta = qb._inner._compiled_forest.gate_delta(key)
        tol = float(qb._inner.config.io.tpu_predict_quantize_tol)
        check(delta is not None and delta <= tol,
              "%s: gate delta %s past tpu_predict_quantize_tol %g"
              % (mode, delta, tol))
        fresh = lgb.Booster(model_str=text, params=params)
        predictor = fresh.serving_predictor()
        predictor.warmup()
        gate = fresh._inner._compiled_forest
        check(gate.gate_delta(key) is None,
              mode + ": the gate measured Predictor.warmup's rows")
        ones = np.array([predictor.predict_one(r) for r in bulk[:32]])
        first = gate.gate_delta(key)
        stats = predictor.stats()
        predictor.close()
        check(first is not None and first <= tol and stats["quantize"]
              == mode, mode + ": the first real batch was not gated")
        check(np.array_equal(ones, value[:32]),
              mode + ": predict_one != predict")
        quant[mode] = (value, raw)
        print("%s main path: gate delta %.6g on %d calibration rows "
              "(tolerance %g); Predictor: none after warmup, %.6g on the "
              "first real request (1 row)" % (
                  mode, delta, booster._inner._QUANT_CALIB_ROWS, tol,
                  first))
    launches = {k: fn.launches for k, fn in kernels.items()}
    print("serving extras main path launches:", launches)
    check(all(v > 0 for v in launches.values()),
          "a serving-extras kernel of the main path was never launched")
    plain = {
        "early stop": P.forest_early_stop_walk_plain(
            P.stack_trees_early_stop(trees, 1, TREES, dev), xb, margin,
            ES_FREQ)[0][0],
        "f16": P.forest_value_walk_plain(P.to_f16(P.stack_trees(trees, dev)),
                                         xb)}
    qf = P.stack_trees_quant(trees, dev)
    plain["int8"] = P.forest_quant_walk_plain(
        qf, P.quant_codes_plain(qf, xb), xb)
    sig = P.OutputTransform("sigmoid", bias=bias)
    for label, raw, value in (("early stop", es_raw, es_value),
                              ("f16",) + quant["f16"][::-1],
                              ("int8",) + quant["int8"][::-1]):
        ref = plain[label].cpu().numpy().astype(np.float64) + bias
        check(np.array_equal(raw, ref), "%s raw_score not bitwise equal to "
              "plain at %d rows" % (label, BULK_ROWS))
        epi = float(np.abs(value - P.apply_output_plain(
            plain[label], sig).cpu().numpy()).max())
        check(epi <= 1e-6 and np.isfinite(value).all(),
              "%s value off the plain epilogue by %g" % (label, epi))
    f32_raw = booster.predict(bulk, raw_score=True)
    rel = {m: float(np.abs(quant[m][1] - f32_raw).max()
                    / max(1.0, np.abs(f32_raw).max())) for m in quant}
    frozen = float(np.mean(es_raw != f32_raw))
    print("serving extras main path: %d rows; raw scores of early stop, "
          "f16 and int8 equal to their plain versions; relative raw delta "
          "to f32 f16 %.3g, int8 %.3g; early stop changed %.1f%% of rows"
          % (BULK_ROWS, rel["f16"], rel["int8"], 100 * frozen))
    reg = lgb.Booster(model_str=text.replace("objective=binary sigmoid:1",
                                             "objective=regression"))
    part = bulk[:65_536]
    check(np.array_equal(reg.predict(part, **es_kw), reg.predict(part)),
          "pred_early_stop changed a regression model's predictions")
    b9 = lgb.Booster(model_str=ctx["text"])
    xv, yv = ctx["xv"], ctx["yv"]
    t0 = time.perf_counter()
    contrib = b9.predict(xv[:CONTRIB_ROWS], pred_contrib=True)
    contrib_s = time.perf_counter() - t0
    raw9 = b9.predict(xv[:CONTRIB_ROWS], raw_score=True)
    gap = float(np.max(np.abs(contrib.sum(axis=1) - raw9)
                       / np.maximum(1.0, np.abs(raw9))))
    check(contrib.shape == (CONTRIB_ROWS, FEATURES + 1) and gap <= 1e-5,
          "pred_contrib: shape %s, row sums off the raw score by %g"
          % (contrib.shape, gap))
    dumped = json.loads(json.dumps(b9.dump_model()))
    check(len(dumped["tree_info"]) == TRAIN_ROUNDS
          and dumped["tree_info"][0]["num_leaves"] > 1,
          "dump_model of phase 9's model")
    path = OUT_DIR / "valid_rows.tsv"
    np.savetxt(path, np.column_stack([yv[:FILE_ROWS], xv[:FILE_ROWS]]),
               delimiter="\t", fmt="%.9g")
    check(np.array_equal(b9.predict(str(path)), b9.predict(xv[:FILE_ROWS])),
          "predict(path) != predict(array)")
    print("model API: pred_contrib on %d rows of phase 9's model (%.2f s), "
          "row sums within %.3g of the raw score; dump_model %d trees as "
          "JSON; predict from a %d-row TSV equal to the array call; "
          "pred_early_stop ignored by a regression model"
          % (CONTRIB_ROWS, contrib_s, gap, len(dumped["tree_info"]),
             FILE_ROWS))

    # --------------------------------------------------------------- 23
    ds, valid = ctx["data"]
    model_path = OUT_DIR / ("higgs_%d_rounds.txt" % TRAIN_ROUNDS)
    model_path.write_text(ctx["text"])
    counted = {"tree_value_walk_binned": P.tree_value_walk_binned,
               "leaf_histogram": histogram.leaf_histogram,
               "split_scan": split.split_scan,
               "route_partition": route.route_partition}
    for fn in counted.values():
        fn.launches = 0
    replay = lgb.train(dict(TRAIN_PARAMS), ds, 0, init_model=str(model_path),
                       verbose_eval=False)
    w_replay = P.tree_value_walk_binned.launches
    score = replay._inner._train_score_unpadded()
    ref = ctx["train_score"]
    rel = float(np.max(np.abs(score - ref) / np.maximum(1.0, np.abs(ref))))
    split_trees = sum(t.num_leaves > 1 for t in replay._inner.models)
    check(w_replay == split_trees, "the replay launched W %d times for %d "
          "trees" % (w_replay, split_trees))
    check(rel <= 1e-5, "replayed train score off phase 9's by %g" % rel)
    del replay
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        evals = {}
        cont = lgb.train(dict(TRAIN_PARAMS), ds, CONT_ROUNDS,
                         valid_sets=[valid], valid_names=["valid"],
                         init_model=str(model_path), evals_result=evals,
                         verbose_eval=False)
        runs.append((cont.model_to_string(), evals["valid"]["auc"],
                     cont.num_trees()))
        if len(runs) == 1:
            cont_launches = {k: fn.launches for k, fn in counted.items()}
            cont_s = time.perf_counter() - t0
        del cont
    check(runs[0][0] == runs[1][0], "two continued runs gave different "
          "model texts")
    auc = runs[0][1]
    check(runs[0][2] == TRAIN_ROUNDS + CONT_ROUNDS,
          "continued model has %d trees" % runs[0][2])
    check(all(v > 0 for v in cont_launches.values()),
          "continued training: a kernel was never launched: %s"
          % cont_launches)
    check(auc[-1] >= ctx["auc"][-1], "continued valid AUC %.5f fell below "
          "phase 9's %.5f" % (auc[-1], ctx["auc"][-1]))
    print("continued training: replay of %d trees (%d W launches) within "
          "%.3g of phase 9's train score; %d more rounds (launches %s, "
          "%.1f s), twice byte-identical, valid auc %.5f -> %.5f (phase 9 "
          "%.5f)" % (split_trees, w_replay, rel, CONT_ROUNDS, cont_launches,
                     cont_s, auc[0], auc[-1], ctx["auc"][-1]))
    cpu_params = dict(TRAIN_PARAMS, num_leaves=CPU_LEAVES)
    xs, ys = ctx["x"][:CPU_ROWS], ctx["y"][:CPU_ROWS]
    first = train_run(lgb, xs, ys, xv[:CPU_VALID_ROWS], yv[:CPU_VALID_ROWS],
                      cpu_params, CONT_CPU_ROUNDS)[0]
    small_path = OUT_DIR / "cpu_protocol.txt"
    first.save_model(str(small_path))
    pair = [lgb.train(dict(cpu_params), lgb.Dataset(
        xs, ys, params=dict(cpu_params)), CONT_CPU_ROUNDS,
        init_model=str(small_path), verbose_eval=False, device=device)
        for device in (None, "cpu")]
    worst = same_trees(pair[0], pair[1], 2 * CONT_CPU_ROUNDS)
    print("continued training, card vs CPU [%d rows, %d leaves, %d + %d "
          "rounds]: same structure, leaf values within %.3g relative"
          % (CPU_ROWS, CPU_LEAVES, CONT_CPU_ROUNDS, CONT_CPU_ROUNDS, worst))
    del pair, first

    # --------------------------------------------------------------- 24
    forest = P.stack_trees(trees, dev)
    f16 = P.to_f16(forest)
    stack = P.stack_trees_early_stop(trees, 1, TREES, dev)
    codes = P.quant_codes(qf, xb)
    depth = torch.from_numpy(leaf_depths(trees)).to(dev)
    leaf_t = P.forest_leaf_walk(forest, xb).t().contiguous()
    _, iters = P.forest_early_stop_walk(stack, xb, margin, ES_FREQ,
                                        return_iters=True)
    visits = walked_visits(depth, leaf_t, torch.full_like(iters, TREES))
    es_visits = walked_visits(depth, leaf_t, iters)
    del leaf_t
    x_bytes, out_bytes = xb.numel() * 4, BULK_ROWS * 4
    code_bytes = codes.numel() * 2
    steps = int(np.ceil(np.log2(qf.grid.shape[1] + 1)))
    cells = BULK_ROWS * FEATURES
    xt = xb[:, :qf.grid.shape[0]].t().contiguous()
    specs = {
        "forest_early_stop_walk": (
            lambda: P.forest_early_stop_walk(stack, xb, margin, ES_FREQ),
            lambda: P.forest_early_stop_walk_plain(stack, xb, margin,
                                                   ES_FREQ),
            x_bytes + stack.nbytes() + out_bytes,
            es_visits * INSTR_PER_VISIT, None),
        "quant_codes": (
            lambda: P.quant_codes(qf, xb),
            lambda: P.quant_codes_plain(qf, xb),
            x_bytes + code_bytes + qf.grid.numel() * 4,
            cells * (INSTR_PER_CODE + INSTR_PER_STEP * steps),
            lambda: torch.searchsorted(qf.grid, xt)),
        "forest_quant_walk": (
            lambda: P.forest_quant_walk(qf, codes, xb),
            lambda: P.forest_quant_walk_plain(qf, codes, xb),
            x_bytes + code_bytes + qf.nbytes() + out_bytes,
            visits * INSTR_PER_VISIT, None),
        "forest_value_walk_f16": (
            lambda: P.forest_value_walk_f16(f16, xb),
            lambda: P.forest_value_walk_plain(f16, xb),
            x_bytes + f16.nbytes() + out_bytes,
            visits * INSTR_PER_VISIT, None)}
    rows = []
    sources = {"forest_early_stop_walk": "forest_walk.cu",
               "quant_codes": "forest_quant.cu",
               "forest_quant_walk": "forest_quant.cu",
               "forest_value_walk_f16": "forest_walk.cu"}
    replaces = {"forest_early_stop_walk": "lightgbm_tpu/ops/predict.py:957",
                "quant_codes": "lightgbm_tpu/ops/predict.py:820",
                "forest_quant_walk": "lightgbm_tpu/ops/predict.py:882",
                "forest_value_walk_f16": "lightgbm_tpu/ops/predict.py:934"}
    for kname, (kernel, plain_fn, nbytes, ops, library) in specs.items():
        ms = median_ms(kernel)
        plain_ms = median_ms(plain_fn, reps=5)
        b_ms, b_by = bound(nbytes, ops)
        lib_ms = median_ms(library, reps=REPS) if library else None
        print("time [%s | %s]: %s %.4f ms, plain %.2f ms, bound %.4f ms "
              "(%s)%s" % (name, card, kname, ms, plain_ms, b_ms, b_by,
                          "" if lib_ms is None else
                          ", torch.searchsorted %.4f ms" % lib_ms))
        rows.append({"name": kname, "route": "cuda",
                     "source": "lightgbm_tpu_torch/csrc/" + sources[kname],
                     "replaces": replaces[kname],
                     "launches": launches[kname],
                     "max_abs_err": errs[kname], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    print("ES work at margin %.6g, freq %d: %d of %d node visits (%.1f%%), "
          "mean iterations a row %.1f of %d"
          % (margin, ES_FREQ, es_visits, visits, 100.0 * es_visits / visits,
             float(iters.float().mean()), TREES))
    ends = {"f32": (booster, {}), "early stop": (booster, es_kw)}
    for mode in ("f16", "int8"):
        ends[mode] = (lgb.Booster(model_str=text, params={
            "tpu_predict_quantize": mode}), {})
    for label, (b, kw) in ends.items():
        b.predict(bulk, **kw)
        e2e = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            b.predict(bulk, **kw)
            e2e.append((time.perf_counter() - t0) * 1e3)
        e2e_ms = float(np.median(e2e))
        print("time [%s | %s]: Booster.predict %s %d rows %.2f ms, %.0f "
              "rows/s" % (name, card, label, BULK_ROWS, e2e_ms,
                          BULK_ROWS / e2e_ms * 1e3))
    return rows


# ---------------------------------------------------------------------
# GOSS, DART and RF training (phases 25-29)
# the three boosting modes on the HIGGS protocol: GOSS at the JAX
# defaults samples from iteration int(1 / 0.1) = 10, so it runs 20
# rounds; DART at the JAX defaults; RF as the JAX package's own test
# (tests/test_engine.py:212-214)
MODE_PARAMS = {
    "goss": dict(TRAIN_PARAMS, boosting="goss", top_rate=0.2,
                 other_rate=0.1),
    "dart": dict(TRAIN_PARAMS, boosting="dart", drop_rate=0.1,
                 skip_drop=0.5, max_drop=50, drop_seed=4),
    "rf": dict(TRAIN_PARAMS, boosting="rf", bagging_fraction=0.7,
               bagging_freq=1, feature_fraction=0.7)}
MODE_ROUNDS = {"goss": 20, "dart": 10, "rf": 10}
GOSS_FROM = 10
# phase 27's weighted max_bin 255 set, and phase 26's odd row count
HILO_ROWS = 65_536
ODD_ROWS = 1_000_003


# phase 27's sweep of f32 bit patterns (tests/test_torch_hist_bf16.py
# sweeps the same): every exponent (0: zero and subnormals, 255: inf and
# NaN) times mantissas at and around bf16's rounding boundaries, both
# signs; histogrammed SWEEP_BINS rows a call over SWEEP_GROUPS groups
SWEEP_MANTISSAS = [0, 1, 2, 0x7FFF, 0x8000, 0x8001, 0xFFFF, 0x10000,
                   0x17FFF, 0x18000, 0x18001, 0x123456, 0x3FFFFF, 0x400000,
                   0x7F7FFF, 0x7F8000, 0x7FC000, 0x7FFFFF]
SWEEP_BINS, SWEEP_GROUPS = 256, 8


def f32_sweep():
    e = np.arange(256, dtype=np.uint32)
    m = np.asarray(SWEEP_MANTISSAS, np.uint32)
    bits = (e[:, None] << 23 | m[None, :]).ravel()
    return np.concatenate([bits, bits | 0x80000000]).view(np.float32)


def hilo_oracle(binned, w3, num_bins, rows=None):
    """The f64 histogram of the exact hi + lo halves of g*w and h*w."""
    from lightgbm_tpu_torch.ops import histogram
    hi, lo = histogram.hi_lo(w3[:, :2].contiguous())
    v = torch.cat([hi.double() + lo.double(), w3[:, 2:].double()], 1)
    return hist_oracle(binned, v, num_bins, rows)


def goss_case(g, h, top_k, other_k, key, label):
    """GT and GW against their plain versions on the card (weights and
    threshold bitwise, a second launch repeating the bits) and the
    threshold against np.partition on the host."""
    from lightgbm_tpu_torch.ops import goss
    n = g.shape[0]
    rest_p, mult = goss.goss_rates(n, top_k, other_k)
    outs = []
    for _ in range(2):
        mag, thr = goss.goss_threshold(g, h, top_k)
        w = goss.goss_weights(mag, thr, key, rest_p, mult,
                              torch.empty(n, device=g.device))
        outs.append((mag, thr, w))
    mag_p, thr_p = goss.goss_threshold_plain(g, h, top_k)
    w_p = goss.goss_weights_plain(mag_p, thr_p, key, rest_p, mult,
                                  torch.empty(n, device=g.device))
    (mag, thr, w), (mag2, thr2, w2) = outs

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    check(same(thr, thr2) and same(w, w2),
          "GT/GW (%s): a second launch gave other bits" % label)
    check(same(mag, mag_p) and same(thr, thr_p),
          "GT (%s): mag or threshold not bitwise its plain version" % label)
    check(same(w, w_p), "GW (%s): weights not bitwise the plain version "
          "(%d differ)" % (label, int((w != w_p).sum())))
    host = mag.cpu().numpy()
    part = np.partition(host, n - top_k)[n - top_k]
    check(np.float32(thr.item()) == part,
          "GT (%s): threshold %r, np.partition %r" % (label, thr.item(),
                                                      part))
    top = int((w == 1.0).sum())
    check(top >= top_k, "GW (%s): %d top rows of %d" % (label, top, top_k))
    return top


def boosting_modes(name, card, dev, ctx):
    """Phases 25-29; returns the JSON rows of GT, GW, H's hi+lo mode and
    R's average mode."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.boosting import dart as dart_mod
    from lightgbm_tpu_torch.boosting import goss as goss_mod
    from lightgbm_tpu_torch.ops import goss, histogram, predict, rng, route
    from lightgbm_tpu_torch.ops import split
    from lightgbm_tpu_torch.testing.synth import synth_higgs

    counted = {"goss_threshold": goss.goss_threshold,
               "goss_weights": goss.goss_weights,
               "leaf_histogram": histogram.leaf_histogram,
               "split_scan": split.split_scan,
               "route_partition": route.route_partition,
               "score_update": route.score_update,
               "score_average": route.score_average,
               "tree_value_walk_binned": predict.tree_value_walk_binned,
               "bagging_mask": rng.bagging_mask}
    x, y, xv, yv = ctx["x"], ctx["y"], ctx["xv"], ctx["yv"]
    data = ctx["data"]

    # the GOSS run's gradients at its first and last sampled round
    # (phase 26), and DART's drops per round (its ledger)
    kept, drops = {}, []
    goss_hook = goss_mod.GOSS._bagging_weights
    drop_hook = dart_mod.DART._dropping_trees

    def keep(self, it, grad=None, hess=None):
        if it in (GOSS_FROM, MODE_ROUNDS["goss"] - 1) and grad is not None:
            kept[it] = (grad.clone(), hess.clone())
        return goss_hook(self, it, grad, hess)

    def count_drops(self):
        drop_hook(self)
        drops.append(len(self.drop_index))

    # --------------------------------------------------------------- 25
    runs, path_launches = {}, {}
    for mode, params in MODE_PARAMS.items():
        rounds = MODE_ROUNDS[mode]
        for fn in counted.values():
            fn.launches = 0
        histogram.leaf_histogram.launches_hilo = 0
        drops.clear()
        goss_mod.GOSS._bagging_weights = keep
        dart_mod.DART._dropping_trees = count_drops
        try:
            booster, evals, update_s = train_run(
                lgb, x, y, xv, yv, params, rounds, data=data)[:3]
        finally:
            goss_mod.GOSS._bagging_weights = goss_hook
            dart_mod.DART._dropping_trees = drop_hook
        launches = {k: fn.launches for k, fn in counted.items()}
        launches["leaf_histogram_hilo"] = \
            histogram.leaf_histogram.launches_hilo
        path_launches[mode] = launches
        gb = booster._inner
        print("%s path launches: %s" % (mode, launches))
        check(booster.device.type == "cuda" and gb.num_trees() == rounds,
              "%s: %d trees on %s" % (mode, gb.num_trees(), booster.device))
        check(launches["leaf_histogram"] > 0 and launches[
            "leaf_histogram_hilo"] == launches["leaf_histogram"],
            "%s: H ran %d times, %d in hi+lo mode" % (
                mode, launches["leaf_histogram"],
                launches["leaf_histogram_hilo"]))
        check(all(launches[k] > 0 for k in ("split_scan", "route_partition",
                                             "tree_value_walk_binned")),
              mode + ": a kernel of the path was never launched")
        if mode == "goss":
            sampled = rounds - GOSS_FROM
            check(launches["goss_threshold"] == sampled
                  and launches["goss_weights"] == sampled,
                  "goss: GT %d and GW %d launches, not %d" % (
                      launches["goss_threshold"], launches["goss_weights"],
                      sampled))
            check(sorted(kept) == [GOSS_FROM, rounds - 1],
                  "goss: sampled rounds %s" % sorted(kept))
        else:
            check(launches["goss_threshold"] == 0, mode + ": GT launched")
        if mode == "rf":
            check(launches["score_average"] == 2 * rounds
                  and launches["score_update"] == 0,
                  "rf: R's average mode launched %d times (train and valid "
                  "score, %d rounds), the score update %d" % (
                      launches["score_average"], rounds,
                      launches["score_update"]))
            check(launches["tree_value_walk_binned"] == rounds
                  and launches["bagging_mask"] == rounds,
                  "rf: W %d, M %d launches in %d rounds" % (
                      launches["tree_value_walk_binned"],
                      launches["bagging_mask"], rounds))
        else:
            check(launches["score_average"] == 0,
                  mode + ": R's average mode launched")
        if mode == "dart":
            # a round walks the new tree on the valid set; a drop walks
            # the dropped tree off the train score, onto the valid scores
            # rescaled, and back onto the train score
            check(len(drops) == rounds and launches[
                "tree_value_walk_binned"] == rounds + 3 * sum(drops),
                "dart: W launched %d times, drops %s" % (
                    launches["tree_value_walk_binned"], drops))
            check(len(gb.tree_weight) == rounds,
                  "dart: ledger of %d weights" % len(gb.tree_weight))
        auc = evals["valid"]["auc"]
        check(len(auc) == rounds and np.isfinite(auc).all()
              and auc[-1] > 0.7, "%s: valid AUC %s" % (mode, auc))
        text = booster.model_to_string()
        again = train_run(lgb, x, y, xv, yv, params, rounds, data=data)[0]
        check(again.model_to_string() == text,
              mode + ": two runs gave different model texts")
        del again
        served = lgb.Booster(model_str=text)
        raw = served.predict(xv, raw_score=True)
        kept_scores = gb.valid_score(0)
        off = np.abs(raw - kept_scores) / np.maximum(1.0,
                                                      np.abs(kept_scores))
        check(float(off.max()) <= 1e-5,
              "%s: served raw scores off the kept valid scores by %g"
              % (mode, off.max()))
        sel = update_s[GOSS_FROM:] if mode == "goss" else update_s[1:]
        med = float(np.median(sel))
        runs[mode] = (booster, med)
        print("%s path: %d rounds, trees of %s leaves, valid auc %.5f, a "
              "second run byte-identical (%d bytes), the reloaded model "
              "served through K1 within %.3g of the kept valid scores%s"
              % (mode, rounds, sorted({t.num_leaves for t in gb.models}),
                 auc[-1], len(text), float(off.max()),
                 ", drops %s" % drops if mode == "dart" else ""))
        print("time [%s | %s]: %s boosting round %.4f s (median of rounds "
              "%s), %.3f million row-iterations/s, rounds %s"
              % (name, card, mode, med, "%d-%d" % (
                  GOSS_FROM + 1, rounds) if mode == "goss" else
                 "2-%d" % rounds, TRAIN_ROWS / med / 1e6,
                 " ".join("%.4f" % v for v in update_s)))

    # --------------------------------------------------------------- 26
    gb = runs["goss"][0]._inner
    n = TRAIN_ROWS
    bc = gb.config.boosting
    top_k, other_k = int(n * bc.top_rate), int(n * bc.other_rate)
    seed = int(bc.bagging_seed)
    for it, (g, h) in sorted(kept.items()):
        top = goss_case(g, h, top_k, other_k,
                        rng.fold_in(rng.prng_key(seed), it),
                        "round %d" % (it + 1))
        print("GT/GW vs plain [goss round %d, %d rows]: weights and "
              "threshold bitwise, threshold = np.partition, %d top rows"
              % (it + 1, n, top))
    g19, h19 = kept[MODE_ROUNDS["goss"] - 1]
    key = rng.fold_in(rng.prng_key(seed), 99)
    gen = torch.Generator(device="cpu").manual_seed(26)
    odd_g = torch.randn(ODD_ROWS, generator=gen).to(dev)
    odd_h = torch.rand(ODD_ROWS, generator=gen).to(dev)
    cases = [
        ("all-equal mags", torch.full_like(g19, -0.5),
         torch.full_like(h19, 0.125), top_k),
        ("all-zero mags", torch.zeros_like(g19), h19, top_k),
        ("top_k 1", g19, h19, 1),
        ("top_k n-1", g19, h19, n - 1),
        ("%d rows" % ODD_ROWS, odd_g, odd_h, int(ODD_ROWS * 0.2))]
    for label, g, h, k in cases:
        m = g.shape[0]
        goss_case(g, h, k, max(1, int(m * 0.1)), key, label)
    print("GT/GW vs plain: all-equal and all-zero mags, top_k 1 and n-1, "
          "%d rows: weights and threshold bitwise, threshold = "
          "np.partition, repeats equal" % ODD_ROWS)

    # --------------------------------------------------------------- 27
    hl_err = 0.0
    binned, nb = gb._binned, gb._grower.num_bins
    mag, thr = goss.goss_threshold(g19, h19, top_k)
    rest_p, mult = goss.goss_rates(n, top_k, other_k)
    wg = goss.goss_weights(mag, thr, rng.fold_in(rng.prng_key(seed), 19),
                           rest_p, mult, torch.empty(n, device=dev))
    w3 = torch.stack([g19 * wg, h19 * wg, wg], 1).contiguous()
    perm, n_left = ctx["perm"], ctx["n_left"]
    small = perm[:n_left] if n_left * 2 <= n else perm[n_left:]
    small = small.contiguous()
    hx = xv[:HILO_ROWS]
    hw = np.where(np.arange(HILO_ROWS) % 3 == 0, 0.5, 1.0)
    ds255 = lgb.Dataset(hx, yv[:HILO_ROWS], weight=hw,
                        params={"max_bin": 255}).construct()
    b255 = torch.from_numpy(ds255._inner.binned).to(dev)
    nb255 = ds255._inner.max_num_bin()
    check(nb255 > 64, "the max_bin 255 set has groups of %d bins" % nb255)
    gen = torch.Generator(device="cpu").manual_seed(27)
    gw = (torch.randn(HILO_ROWS, generator=gen)
          * torch.from_numpy(hw).float()).to(dev)
    hwt = (torch.rand(HILO_ROWS, generator=gen) * 0.25
           * torch.from_numpy(hw).float()).to(dev)
    w255 = torch.stack([gw, hwt, torch.from_numpy(hw).float().to(dev)],
                       1).contiguous()
    rows255 = torch.nonzero(b255[:, 0] < nb255 // 3)[:, 0].to(
        torch.int32).contiguous()
    for label, (bn, w, bins, rows) in {
            "max_bin 63, GOSS round 20, root": (binned, w3, nb, None),
            "max_bin 63, GOSS round 20, child": (binned, w3, nb, small),
            "max_bin 255, weighted, root": (b255, w255, nb255, None),
            "max_bin 255, weighted, child": (b255, w255, nb255,
                                             rows255)}.items():
        kw = {} if rows is None else {"rows": rows,
                                      "n_rows": rows.shape[0]}
        got = histogram.leaf_histogram(bn, w, bins, bf16=True, **kw)
        check(torch.equal(got, histogram.leaf_histogram(bn, w, bins,
                                                        bf16=True, **kw)),
              "H hi+lo (%s): a second launch gave other bits" % label)
        ref = histogram.leaf_histogram_plain(bn, w, bins, bf16=True, **kw)
        hl_err = max(hl_err, sums_err(got, ref,
                                      hilo_oracle(bn, w, bins, rows),
                                      "H hi+lo (%s)" % label))
        f32 = histogram.leaf_histogram(bn, w, bins, **kw)
        check(not torch.equal(f32, got), "H hi+lo (%s) equals the f32 mode"
              % label)
    print("H hi+lo vs plain: max_bin 63 (GOSS weights, root and a %d-row "
          "child) and max_bin 255 (%d weighted rows, %d bins, root and a "
          "%d-row child): counts exact, g/h within 1e-5 of plain and of "
          "the f64 sum of the halves (max abs err %.3g), repeats equal, "
          "the f32 mode differs" % (small.shape[0], HILO_ROWS, nb255,
                                    rows255.shape[0], hl_err))
    # one row a (group, bin): each bin is f32(hi) + f32(lo) of one value,
    # so the kernel's split must give the plain version's bits (round to
    # nearest even, XLA's subnormal flushes, quiet NaNs); NaN payloads
    # are left to the hardware, so a NaN need only be a NaN
    sweep = torch.from_numpy(f32_sweep()).to(dev)
    r = torch.arange(SWEEP_BINS, device=dev)
    bins1 = torch.stack([(r * (2 * k + 1) + 37 * k) % SWEEP_BINS
                         for k in range(SWEEP_GROUPS)], 1).to(
        torch.uint8).contiguous()
    back = r.flip(0).to(torch.int32).contiguous()
    calls = 0
    for i in range(0, sweep.shape[0], SWEEP_BINS):
        gv = sweep[i:i + SWEEP_BINS]
        hv = sweep.flip(0)[i:i + SWEEP_BINS]
        w1 = torch.stack([gv, hv, torch.ones_like(gv)], 1).contiguous()
        for kw in ({}, {"rows": back, "n_rows": SWEEP_BINS}):
            got = histogram.leaf_histogram(bins1, w1, SWEEP_BINS, bf16=True,
                                           **kw)
            ref = histogram.leaf_histogram_plain(bins1, w1, SWEEP_BINS,
                                                 bf16=True, **kw)
            nan = torch.isnan(ref)
            bad = int((got.view(torch.int32) != ref.view(torch.int32))[
                ~nan].sum())
            check(torch.equal(torch.isnan(got), nan) and bad == 0,
                  "H hi+lo on the sweep (rows %d-%d, %s): %d words differ "
                  "from plain, NaNs at %d and %d places"
                  % (i, i + SWEEP_BINS - 1, "row list" if kw else "all "
                     "rows", bad, int(torch.isnan(got).sum()),
                     int(nan.sum())))
            calls += 1
    print("H hi+lo vs plain on a sweep of %d f32 values (every exponent, "
          "subnormals, ties, +-0, +-inf, NaN), one row a (group, bin), %d "
          "calls, all rows and a row list: bitwise, NaNs where plain has "
          "them" % (sweep.shape[0], calls))
    rb = runs["rf"][0]._inner
    rtree = rb.models[-1]
    values = torch.from_numpy(rtree.leaf_value.astype(np.float32)).to(dev)
    lid = gb._grower.leaf_id.clone()
    lid.clamp_(max=rtree.num_leaves - 1)
    vadd = torch.zeros(VALID_ROWS, device=dev)
    predict.tree_value_walk_binned(predict.binned_tree(rtree, dev),
                                   rb._valid_binned[0], vadd)
    for label, score0, ids, vals in (
            ("train, leaf ids", rb._score[0], lid, values),
            ("valid, per-row values", rb._valid_score[0][0], None, vadd)):
        outs = []
        for fn in (route.score_average, route.score_average,
                   route.score_average_plain):
            sc = score0.clone()
            fn(sc, ids, vals, MODE_ROUNDS["rf"])
            outs.append(sc)
        check(all(torch.equal(outs[0].view(torch.int32), o.view(torch.int32))
                  for o in outs[1:]),
              "R average (%s): not bitwise its repeat and plain" % label)
    print("R average mode vs plain [%d train rows, %d valid rows]: bitwise, "
          "repeats equal" % (n, VALID_ROWS))

    # --------------------------------------------------------------- 28
    xs, ys = x[:CPU_ROWS], y[:CPU_ROWS]
    xvs, yvs = xv[:CPU_VALID_ROWS], yv[:CPU_VALID_ROWS]
    for mode, params in MODE_PARAMS.items():
        p = dict(params, num_leaves=CPU_LEAVES, learning_rate=0.5)
        t0 = time.perf_counter()
        on_card, ev_card = train_run(lgb, xs, ys, xvs, yvs, p,
                                     CPU_ROUNDS)[:2]
        on_cpu, ev_cpu = train_run(lgb, xs, ys, xvs, yvs, p, CPU_ROUNDS,
                                   device="cpu")[:2]
        worst = same_trees(on_card, on_cpu, CPU_ROUNDS)
        d_auc = abs(ev_card["valid"]["auc"][-1] - ev_cpu["valid"]["auc"][-1])
        check(d_auc <= 2e-3, "%s: card/CPU valid AUC differ by %g"
              % (mode, d_auc))
        print("card vs CPU [%s, %d rows, %d leaves, learning rate 0.5, %d "
              "rounds]: same structure, leaf values within %.3g relative, "
              "valid auc %.5f vs %.5f (%.2f s)"
              % (mode, CPU_ROWS, CPU_LEAVES, CPU_ROUNDS, worst,
                 ev_card["valid"]["auc"][-1], ev_cpu["valid"]["auc"][-1],
                 time.perf_counter() - t0))

    # --------------------------------------------------------------- 29
    print("clocks [%s]: SM clock, max SM clock: %s (before the timings)"
          % (card, clocks()))
    times = {}
    gt_ms = device_ms(lambda: goss.goss_threshold(g19, h19, top_k),
                      ("gt_count_kernel", "gt_pick_kernel", "Memset"))
    wbuf = torch.empty(n, device=dev)
    key19 = rng.fold_in(rng.prng_key(seed), 19)
    gw_ms = device_ms(lambda: goss.goss_weights(mag, thr, key19, rest_p,
                                                mult, wbuf), ("gw_kernel",))
    gt_plain = median_ms(lambda: goss.goss_threshold_plain(g19, h19, top_k),
                         reps=5)
    gw_plain = median_ms(lambda: goss.goss_weights_plain(
        mag, thr, key19, rest_p, mult, wbuf), reps=5)
    kth_ms = median_ms(lambda: torch.kthvalue(mag, n - top_k + 1))
    check(torch.kthvalue(mag, n - top_k + 1).values.view(1).view(
        torch.int32).equal(thr.view(torch.int32)),
        "torch.kthvalue disagrees with GT's threshold")
    # the pair's function reads g and h and writes w (12 B a row); split
    # between the two without the intermediate mag: GT reads g and h, GW
    # writes w and draws a threefry uniform a row
    times["goss_threshold"] = (gt_ms, gt_plain, bound(8 * n), kth_ms)
    times["goss_weights"] = (gw_ms, gw_plain,
                             bound(4 * n, n * INSTR_PER_DRAW), None)
    print("time [%s | %s]: GT + GW %.4f ms on %d rows (GT %.4f, GW %.4f), "
          "plain %.3f ms, torch.kthvalue %.4f ms, bound of the function "
          "%.5f ms (g and h read, w written: %d MB)"
          % (name, card, gt_ms + gw_ms, n, gt_ms, gw_ms, gt_plain + gw_plain,
             kth_ms, bound(12 * n)[0], 12 * n // 10 ** 6))
    g_cnt = binned.shape[1]
    h_names = ("hist_tile_kernel", "hist_reduce_kernel")
    hl_ms = device_ms(lambda: histogram.leaf_histogram(binned, w3, nb,
                                                       bf16=True), h_names)
    f32_ms = device_ms(lambda: histogram.leaf_histogram(binned, w3, nb),
                       h_names)
    flat = ((torch.arange(g_cnt, device=dev) * nb)[None]
            + binned.long()).reshape(-1)
    hi, lo = histogram.hi_lo(w3[:, :2].contiguous())
    chans = [c[:, None].expand(n, g_cnt).reshape(-1)
             for c in (hi[:, 0], hi[:, 1], (w3[:, 2] > 0).float(), lo[:, 0],
                       lo[:, 1])]

    def library():
        for c in chans:
            torch.bincount(flat, weights=c, minlength=g_cnt * nb)
    lib_ms = median_ms(library, reps=5)
    del flat, chans
    times["leaf_histogram_hilo"] = (
        hl_ms, median_ms(lambda: histogram.leaf_histogram_plain(
            binned, w3, nb, bf16=True), reps=5),
        bound(n * g_cnt + n * 12 + g_cnt * nb * 12, 5.0 * n * g_cnt),
        lib_ms)
    print("time [%s | %s]: H root (%d rows) hi+lo %.4f ms against f32 %.4f "
          "ms device time, torch.bincount x5 %.4f ms"
          % (name, card, n, hl_ms, f32_ms, lib_ms))
    sc = rb._score[0].clone()
    times["score_average"] = (
        device_ms(lambda: route.score_average(sc, lid, values, 3),
                  ("score_average_kernel",)),
        median_ms(lambda: route.score_average_plain(sc, lid, values, 3),
                  reps=5),
        bound(12 * n), None)
    for k, (ms, plain_ms, (b_ms, b_by), lib) in times.items():
        print("time [%s | %s]: %s %.4f ms, plain %.3f ms, bound %.5f ms "
              "(%s)%s" % (name, card, k, ms, plain_ms, b_ms, b_by,
                          "" if lib is None else ", library %.4f ms" % lib))
    print("time [%s | %s]: boosting round goss %.4f s (rounds %d-%d), dart "
          "%.4f s, rf %.4f s, gbdt %.4f s (phase 12)"
          % (name, card, runs["goss"][1], GOSS_FROM + 1,
             MODE_ROUNDS["goss"], runs["dart"][1], runs["rf"][1],
             ctx["rounds_s"]))
    profile_round(runs["goss"][0], name + ", goss round", card)

    replaces = {
        "goss_threshold": "lightgbm_tpu/boosting/goss.py:59",
        "goss_weights": "lightgbm_tpu/boosting/goss.py:59",
        "leaf_histogram_hilo": "lightgbm_tpu/ops/histogram.py:333",
        "score_average": "lightgbm_tpu/boosting/rf.py:87"}
    sources = {
        "goss_threshold": "lightgbm_tpu_torch/csrc/goss.cu",
        "goss_weights": "lightgbm_tpu_torch/csrc/goss.cu",
        "leaf_histogram_hilo": "lightgbm_tpu_torch/csrc/histogram.cu",
        "score_average": "lightgbm_tpu_torch/csrc/route_partition.cu"}
    # H's hi+lo mode: the launches of phase 9's default run and of the
    # three runs above
    launches = {"goss_threshold": path_launches["goss"]["goss_threshold"],
                "goss_weights": path_launches["goss"]["goss_weights"],
                "leaf_histogram_hilo": ctx["hilo_launches"] + sum(
                    v["leaf_histogram_hilo"]
                    for v in path_launches.values()),
                "score_average": path_launches["rf"]["score_average"]}
    errs = {"goss_threshold": 0.0, "goss_weights": 0.0,
            "leaf_histogram_hilo": hl_err, "score_average": 0.0}
    rows = []
    for k in times:
        ms, plain_ms, (b_ms, b_by), lib = times[k]
        rows.append({"name": k, "route": "cuda", "source": sources[k],
                     "replaces": replaces[k], "launches": launches[k],
                     "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
    return rows


def main():
    # ---------------------------------------------------------------- 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops.predict import (
        OutputTransform, apply_output_plain, forest_leaf_walk,
        forest_leaf_walk_plain, forest_value_walk, forest_value_walk_plain,
        stack_trees)
    from lightgbm_tpu_torch.testing.synth import (
        edge_case_rows, synthetic_forest_text, synthetic_rows)

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print("device:", name, "| count", torch.cuda.device_count(),
          "| torch", torch.__version__, "cuda", torch.version.cuda)
    print(card)

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    records = _build.build_all()
    print("build: %d libraries, one nvcc each, in %.1f s" % (
        len(records), time.perf_counter() - t0))
    for lib_name, record in records.items():
        print("build: lib%s.so %s (nvcc %.1f s)" % (
            lib_name, "compiled" if record.compiled else "up to date",
            record.seconds))
        for line in record.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
        _build.load_library(lib_name)

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    text = synthetic_forest_text(0, TREES, LEAVES, FEATURES)
    cat_text = synthetic_forest_text(1, 50, 63, FEATURES, cat_features=4)
    print("synthetic forests: %.1f s" % (time.perf_counter() - t0))
    errs = {"forest_value_walk": 0.0, "forest_leaf_walk": 0}
    host = {}
    for label, model, cats in (("full", text, 0), ("categorical", cat_text,
                                                   4)):
        trees = lgb.Booster(model_str=model, device="cpu")._inner.models
        host[label] = trees
        forest = stack_trees(trees, dev)
        half = CHECK_ROWS // 2
        rows = np.concatenate([
            synthetic_rows(2, half, FEATURES, cats),
            edge_case_rows(trees, FEATURES, 3, half, cats)])
        x = torch.from_numpy(rows).to(dev)
        sig = OutputTransform("sigmoid")
        leaf_k = forest_leaf_walk(forest, x)
        leaf_p = forest_leaf_walk_plain(forest, x)
        raw_k = forest_value_walk(forest, x)
        raw_p = forest_value_walk_plain(forest, x)
        out_k = forest_value_walk(forest, x, sig)
        out_p = apply_output_plain(raw_p, sig)
        torch.cuda.synchronize()
        check(torch.equal(leaf_k, leaf_p), label + ": K2 != plain")
        check(torch.equal(raw_k.view(torch.int32), raw_p.view(torch.int32)),
              label + ": K1 not bitwise equal to plain")
        epi = float((out_k - out_p).abs().max())
        check(epi <= 2e-7, label + ": K1 epilogue off by %g" % epi)
        check(torch.equal(forest_value_walk(forest, x).view(torch.int32),
                          raw_k.view(torch.int32))
              and torch.equal(forest_leaf_walk(forest, x), leaf_k),
              label + ": a second run gave other bits")
        errs["forest_value_walk"] = max(errs["forest_value_walk"], float(
            (raw_k - raw_p).abs().max()))
        errs["forest_leaf_walk"] = max(errs["forest_leaf_walk"], int(
            (leaf_k - leaf_p).abs().max()))
        clean = rows[:half][~np.isnan(rows[:half]).any(axis=1)][:64]
        oracle = np.array([sum(t.predict_row(r.astype(np.float64))
                               for t in trees) for r in clean])
        got = raw_k[:half].cpu().numpy()[~np.isnan(rows[:half]).any(
            axis=1)][:64]
        rel = float(np.max(np.abs(got - oracle) / np.maximum(
            1.0, np.abs(oracle))))
        check(len(clean) == 64 and rel <= 1e-4,
              label + ": host oracle off by %g" % rel)
        print("kernels vs plain [%s, %d trees]: K2 equal, K1 bitwise equal, "
              "epilogue %.3g, repeat equal, oracle rel %.3g"
              % (label, len(trees), epi, rel))

    # ---------------------------------------------------------------- 3
    bulk = synthetic_rows(4, BULK_ROWS, FEATURES)
    forest_value_walk.launches = 0
    forest_leaf_walk.launches = 0
    booster = lgb.Booster(model_str=text)
    check(booster.device.type == "cuda", "default device is not cuda")
    value = booster.predict(bulk)
    raw = booster.predict(bulk, raw_score=True)
    leaf = booster.predict(bulk, pred_leaf=True)
    capped = booster.predict(bulk[:4096], num_iteration=5)
    predictor = booster.serving_predictor()
    predictor.warmup()
    ones = np.array([predictor.predict_one(r) for r in bulk[:32]])
    futures = [None] * 256

    def submit(k):
        for i in range(k, 256, 8):
            futures[i] = predictor.submit(bulk[i])

    threads = [threading.Thread(target=submit, args=(k,)) for k in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    check(not any(th.is_alive() for th in threads), "submit threads hung")
    submitted = np.array([f.result(timeout=120) for f in futures])
    stats = predictor.stats()
    predictor.close()
    launches = {"forest_value_walk": forest_value_walk.launches,
                "forest_leaf_walk": forest_leaf_walk.launches}
    print("main path launches:", launches)
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")
    check(booster.model_to_string() == text, "model text round trip")
    check(value.shape == (BULK_ROWS,) and raw.shape == (BULK_ROWS,)
          and leaf.shape == (BULK_ROWS, TREES) and leaf.dtype == np.int32,
          "output shapes")
    check(np.isfinite(value).all() and np.isfinite(raw).all()
          and ((value > 0) & (value < 1)).all(), "outputs not finite")
    check(np.abs(value - 1 / (1 + np.exp(-raw))).max() <= 1e-6,
          "value != sigmoid(raw_score)")
    check(np.array_equal(ones, value[:32]), "predict_one != predict")
    check(np.array_equal(submitted, value[:256]), "submit != predict")
    # the whole bulk output, as GBDT._chunks launched it in chunks of
    # 131,072 rows, against the plain versions on the card at full size
    trees = host["full"]
    forest = stack_trees(trees, dev)
    x = torch.from_numpy(bulk).to(dev)
    leaf_p = forest_leaf_walk_plain(forest, x)
    raw_p = forest_value_walk_plain(forest, x)
    check(np.array_equal(leaf, leaf_p.cpu().numpy()),
          "main path pred_leaf != plain at %d rows" % BULK_ROWS)
    raw_host = raw_p.cpu().numpy().astype(np.float64)
    raw_host += booster._inner.init_score_bias
    check(np.array_equal(raw, raw_host),
          "main path raw_score not bitwise equal to plain at %d rows"
          % BULK_ROWS)
    epi = float(np.abs(value - apply_output_plain(
        raw_p, OutputTransform("sigmoid")).cpu().numpy()).max())
    check(epi <= 2e-7, "main path value: epilogue off by %g" % epi)
    cpu = lgb.Booster(model_str=text, device="cpu")
    small = bulk[:2048]
    check(np.array_equal(cpu.predict(small, pred_leaf=True), leaf[:2048]),
          "pred_leaf != CPU plain")
    check(np.array_equal(cpu.predict(small, raw_score=True), raw[:2048]),
          "raw_score != CPU plain")
    check(np.abs(cpu.predict(small[:1024], num_iteration=5)
                 - capped[:1024]).max() <= 1e-6, "num_iteration=5 != CPU")
    print("main path: %d rows value/raw_score/pred_leaf/num_iteration, "
          "32 predict_one, 256 submit from 8 threads: checked, bulk "
          "outputs equal the plain versions (epilogue %.3g)"
          % (BULK_ROWS, epi))

    # ---------------------------------------------------------------- 4
    # the kernels at the timed shape: all rows in one launch and in the
    # main path's chunks, each against the plain version on the same rows
    chunk = booster._inner._predict_chunk_rows()
    leaf_d = forest_leaf_walk(forest, x)
    raw_d = forest_value_walk(forest, x)
    leaf_c = torch.cat([forest_leaf_walk(forest, x[i:i + chunk])
                        for i in range(0, BULK_ROWS, chunk)])
    raw_c = torch.cat([forest_value_walk(forest, x[i:i + chunk])
                       for i in range(0, BULK_ROWS, chunk)])
    torch.cuda.synchronize()
    for got, label in ((leaf_d, "one launch"), (leaf_c, "chunks")):
        check(torch.equal(got, leaf_p),
              "K2 != plain at %d rows (%s)" % (BULK_ROWS, label))
    for got, label in ((raw_d, "one launch"), (raw_c, "chunks")):
        check(torch.equal(got.view(torch.int32), raw_p.view(torch.int32)),
              "K1 not bitwise equal to plain at %d rows (%s)"
              % (BULK_ROWS, label))
    errs["forest_value_walk"] = max(errs["forest_value_walk"], float(
        torch.maximum((raw_d - raw_p).abs().max(),
                      (raw_c - raw_p).abs().max())))
    errs["forest_leaf_walk"] = max(errs["forest_leaf_walk"], int(
        torch.maximum((leaf_d - leaf_p).abs().max(),
                      (leaf_c - leaf_p).abs().max())))
    print("kernels vs plain [full, %d rows, one launch and chunks of %d]: "
          "K2 equal, K1 bitwise equal" % (BULK_ROWS, chunk))
    del leaf_p, raw_p, leaf_c, raw_c, raw_d
    depth = torch.from_numpy(leaf_depths(trees)).to(dev)
    visits = int(depth.gather(1, leaf_d.t().long()).sum())
    in_bytes = x.numel() * 4 + forest.nbytes()
    ops_ms = visits * INSTR_PER_VISIT / INSTR_PER_S * 1e3
    times = {}
    for kname, kernel, plain, out_bytes in (
            ("forest_value_walk", lambda: forest_value_walk(forest, x),
             lambda: forest_value_walk_plain(forest, x), BULK_ROWS * 4),
            ("forest_leaf_walk", lambda: forest_leaf_walk(forest, x),
             lambda: forest_leaf_walk_plain(forest, x),
             BULK_ROWS * TREES * 4)):
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        times[kname] = {
            "ms": median_ms(kernel), "plain_ms": median_ms(plain, reps=10),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        print("time [%s | %s]: %s %.4f ms, plain %.2f ms, bound %.4f ms "
              "(%s; %d node visits)" % (
                  name, card, kname, times[kname]["ms"],
                  times[kname]["plain_ms"], times[kname]["bound_ms"],
                  times[kname]["bound_by"], visits))
    one_row = x[:1].contiguous()
    print("time [%s | %s]: forest_value_walk on 1 row %.4f ms" % (
        name, card, median_ms(lambda: forest_value_walk(forest, one_row))))
    booster.predict(bulk)
    e2e = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        booster.predict(bulk)
        e2e.append((time.perf_counter() - t0) * 1e3)
    e2e_ms = float(np.median(e2e))
    print("time [%s | %s]: Booster.predict %d rows %.2f ms, %.0f rows/s"
          % (name, card, BULK_ROWS, e2e_ms, BULK_ROWS / e2e_ms * 1e3))
    where_time_goes(booster, bulk, name, card)
    lat = []
    predictor = booster.serving_predictor()
    predictor.warmup()
    for r in bulk[:200]:
        t0 = time.perf_counter()
        predictor.predict_one(r)
        lat.append((time.perf_counter() - t0) * 1e3)
    predictor.close()
    print("time [%s | %s]: Predictor.predict_one p50 %.3f ms p99 %.3f ms "
          "(200 requests; stats() p50 %s p99 %s over the main-path run)"
          % (name, card, np.percentile(lat, 50), np.percentile(lat, 99),
             stats.get("p50_latency_ms"), stats.get("p99_latency_ms")))

    replaces = {"forest_value_walk": "lightgbm_tpu/ops/predict.py:305",
                "forest_leaf_walk": "lightgbm_tpu/ops/predict.py:656"}
    rows = [
        {"name": k, "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/forest_walk.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"], "library_ms": None}
        for k in ("forest_value_walk", "forest_leaf_walk")]
    rank_row = ranking(name, card, dev)
    train_rows, ctx = training(name, card, dev)
    rows.extend(train_rows)
    rows.append(rank_row)
    rows.extend(quantized(name, card, dev, ctx))
    rows.extend(linear(name, card, dev, ctx))
    rows.extend(serving_extras(name, card, dev, ctx, text))
    rows.extend(boosting_modes(name, card, dev, ctx))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
