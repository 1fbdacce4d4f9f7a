"""Smoke run of lightgbm_tpu_torch on one CUDA card (an H100 for this repo).

    python3 chip_smoke.py

(`python3 chip_smoke.py --ab OLD --ab NEW ...` compares checkouts on one
card instead; see ab_main.)

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
   oracle Tree.predict_row within 1e-4 relative; then K1 at 1, 7, 32,
   256, 4,096, 32,768 and 32,769 rows (its trees mode up to
   TREE_PARALLEL_MAX_ROWS, rows mode past it) and 262,144, each twice,
   bitwise equal to its plain version and its repeat, on 4,096 edge-case
   rows, 4,096 rows of NaN, +inf and -inf cells and seeded rows: on
   both forests, on one with two trees of 4,096 leaves among 20 of the
   full forest's (records read from device memory), on a 20-tree forest
   over 300-column rows (rows read from device memory; up to 65,536
   rows), alone and with two such large trees; K1-f16 the same way on
   the full forest; K2 at the same row counts on the same forests and
   rows, equal to its plain version and its repeat (hold_k2);
3. serving main path: Booster(model_str=...) on the default device,
   predict on 262,144 rows (value, raw_score, pred_leaf) and pred_leaf
   on 32 of them (K2's trees mode), the serving Predictor (warmup, 32
   predict_one, 256 submit from 8 threads, stats), the model text round
   trip, and every serving kernel's launch count over that run, K1's
   and K2's by mode (K2 must have launched both); the whole bulk
   raw_score and pred_leaf output
   (launched in the engine's row chunks) must equal the plain versions
   on the same rows, and the value output must be within 2e-7 of the
   plain epilogue;
4. serving times: K1 and K2 on all 262,144 rows, in one launch and in
   the engine's row chunks, must equal their plain versions (K1
   bitwise); then CUDA events around each kernel and its plain version
   at 262,144 rows (median of 12 after warm-up), K1, K1-f16 and K2
   device time alone (a CUDA graph of one call, replayed; the JSON rows
   keep K1's and K2's at 262,144 rows) at 262,144 rows, the engine's
   131,072-row chunk (K1, K2) and one row, and K1 and K2 on one row with
   CUDA events around the wrapper, K1 in each of its modes at 4,096 to
   131,072 rows (the crossover), Booster.predict end to end (and with
   pred_leaf=True), a torch.profiler breakdown of
   one Booster.predict (device busy time against host wall time),
   Predictor latency percentiles; the main path's K1 launches are
   counted by mode;
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
   the model text train gives with the same params; int8 lambdarank 3
   rounds on 49,997 of the rows (not a multiple of 4, so L's hessian row
   does not start on 16 bytes), Q held bitwise its plain version and its
   repeat on those gradients;
6. L (lambdarank_grads) against its plain version on the card: on the
   ranking protocol's 5,000 x 100-doc layout (its objective's labels,
   gains and inverse max DCGs) at all-zero scores (the first round),
   seeded scores and the scores after 10 rounds, on an MSLR-WEB30K-
   shaped layout (31,531 queries, 3,758,505 docs, up to 1,251 a query,
   empty and one-doc queries) and on queries longer than L stages in
   shared memory, and at seeded scores with row weights: bit for bit
   its order replay (ops/rank.py lambdarank_grads_order), grad and hess
   within 1e-5 * max(1, A) of the plain version and of a float64 oracle
   on the card, A a doc's sum of absolute pair terms; a float64 oracle
   on the host for a sample of queries (the 1,251-doc one among them); a
   second launch must repeat the bits;
7. the card against the CPU: the protocol at 50,000 rows (500
   queries), 63 leaves, 3 rounds: the same tree structure, leaf values
   within 1e-5 relative, valid ndcg@10 within 1e-5;
8. ranking times: L (CUDA-graph replay, and CUDA events around the
   call) and its plain version (CUDA events, median of 12 after 0.3 s of
   back-to-back calls) and its bound at the protocol's and the
   MSLR-shaped layout, seconds per ranking round (median of
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
    root split, and R alone on segments of 0, 1, 511, 512, 513 and 2,637
    rows and a late small one of 3,000 (sorted ids drawn from all rows),
    the root split and its all-left and all-right variants, in place and
    into a second buffer as the grower calls it, on row- and
    column-major bins (hold_route; phases 30 and 36 the same), W
    (tree_value_walk_binned) with the trained first tree on the valid
    set, on the booster's bins (row-major at 28 bytes a row, checked)
    and on the same bins column-major. Counts, leaf ids, the partition, the
    split choices and W's scores must equal the plain versions exactly
    (S, W bitwise), the g/h
    sums must be within 1e-5 * max(1, |plain|) of the plain version and
    of an f64 oracle, and each kernel launched twice on the same inputs
    must repeat its bits; H (f32, and hi+lo on both gradients at the
    root and the smaller child) must equal bit for bit the replay of its
    summation order (ops/histogram.py leaf_histogram_order); then H in
    both modes on cancelling gradients at the root's shape (seeded
    uniform bins, 2,000,000 x 28 at B 64, g ~ N(0, 0.25) and h ~ U(0,
    0.25) on 90% of the rows): all rows and a 966,119-row list, bitwise
    its order, a repeat of its bits, within 1e-5 * max(1, |ref|) of plain
    and of the f64 oracle (f32 chains of f32 values miss that here);
11. the card against the CPU: the same protocol at 131,072 rows, 63
    leaves and 3 rounds on the card and with device="cpu" (the plain
    versions), under tpu_hist_bf16=true and false: the same tree
    structure, leaf values within 1e-5 relative, valid AUC within 2e-3;
12. training times: seconds per boosting round (median of rounds 2-10)
    and million row-iterations per second as bench.py reports them; per
    kernel its device time per call (torch.profiler, which leaves out the
    Python wrapper's host time; CUDA events around the call when the
    profiler lists other than the calls' kernels; H and S by CUDA-graph
    replay, the mean of 50), launches per tree, the plain version's
    CUDA-event ms and the bound, and for H the torch.bincount library
    time; R as the grower calls it at the root on row- and column-major
    bins and on a late small segment (CUDA-graph replay and profiler),
    its call's host time and its device ms in the profiled round, every timing after 0.3 s of back-to-back calls that take the
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
    mask, each in both scale modes (a training iteration's max * f32(1 /
    qmax), which GBDT._quantize runs every round, and the gate's max /
    qmax); Q on inputs that do not start on 16 bytes (rows of a [2, m]
    tensor, m 1, 3, 1,001 and n - 3) bitwise its plain version and its
    repeat; Q with a NaN or an inf in a gradient or an inf in a hessian
    (all rows and a bag mask, both modes): scales and w01 bitwise its
    plain version and its repeat (a NaN scale where the plain version's
    is NaN), the codes where the plain version defines them (gw / scale
    a number); Q one kernel node and no memset in a CUDA graph of one
    call; HQ exactly at the root (all rows, and bagged) and on the root
    split's smaller child as a row list; parent == left + right in int32;
    S in XLA's cumsum order (the order quantized growth scans in) with
    the int8 grower's params on the dequantized root and on its two
    children, bitwise against its plain version; each kernel launched
    twice repeating its bits;
15. the card against the CPU at 131,072 rows, 63 leaves and 3 rounds for
    int8, int16, int8 + bagging and f32 + bagging: the same tree
    structure, leaf values within 1e-5 relative, valid AUC within 2e-3;
    Q in the training scale mode on the card and on the CPU from the
    same gradients gives the same codes (and how many differ from each
    side's own gradients);
16. times: M, Q and HQ (root and row list) with their plain versions
    (CUDA events, median of 12 after 0.3 s of back-to-back calls; HQ's
    root by CUDA-graph replay, the mean of 50) and
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
    inf rows; K1 on the trained linear forest bitwise and repeating its
    bits at phase 2's row counts up to the 262,144 valid rows; W's
    leaf mode equal; LM as the main path calls it (leaf_feature_moments
    over the last tree's 255 leaf ids and the trained model's gradients),
    on the first tree's leaves and on seeded 65,536 x 70 rows (16 ids in
    shuffled order, one of no rows, rows of no id, NaN and -inf values;
    one id over a constant leaf_id; 3,000 ids over 8 of the features,
    past what the sort counts in shared memory), all four channels per bin
    within 1e-5 * max(1, sum of |terms|) of the plain version and an f64
    oracle and bitwise the replay of its summation order
    (`ops/histogram.leaf_moments_order`), the bin-summed sum w g x of the
    first tree's largest leaf equal to LF's b; LF and LS at k = 64
    (65,536 rows x 70 columns, 16 leaves, LF's sums split over nine
    blocks a tile) against their plain versions and LF's f64 oracle;
    LF at k 5 and k 64 bit for bit the replay of its summation order
    (`ops/linear.py linear_normal_eq_order`); each launched twice
    repeating its bits;
19. the card against the CPU at 131,072 rows, 63 leaves and 3 rounds,
    linear f32 and linear int8: the same tree structure and leaf
    features, leaf values and coefficients within 1e-5 relative, valid
    AUC within 2e-3;
20. times: each new kernel's device time (torch.profiler; CUDA events
    for LS; a CUDA graph replay for K1, for LF at k 5 and k 64, for LA
    (graphs of 20 calls) and for LM
    on the main path's call, whose call's events and host time print
    beside it; LF's host time with new segments and cached ones), its plain
    version, bound and library yardstick (index_add_ for LF and LM, with
    torch.bincount x4 beside LM's, torch.linalg.solve for LS); seconds per
    linear round against phase 12's constant round; one profiled linear
    round; the BENCH_SHAPE=linear gate (bench.py:1562-1620: 20,000 x 10
    rows, regression, 31 leaves, 60 rounds) on the card, its ratio at
    most 0.7;
21. serving-extras kernels vs plain: the phase-2 forests with binned
    thresholds (`synthetic_forest_text(..., max_bin=255)`: at most 254
    bounds and one missing type a feature, as a model trained at
    max_bin 255 has; the unbinned phase-2 forest must be refused an
    int8 layout by name), on phase 2's check rows plus 4,096 rows of
    grid-bound edge values (`grid_edge_rows`: every bound and its
    nextafter neighbours, +-0, subnormals, +-inf, NaN): QC's codes
    exact; QW and K1's f16 mode bitwise against their plain versions,
    their repeats and each other, and QW bitwise its plain version, its
    repeat and K1-f16 at 1, 7, 32, 256, 4,096, 32,768, 32,769 and
    262,144 rows (both of its modes) on 4,096 grid-edge rows and
    held_rows; ES bitwise (iterations too) and its repeat at freq 1
    and 10, margins 0, 1e30 and the median 2|raw| at half the
    iterations, with the freeze histogram (some rows freeze at the
    first check, some never), on the check rows and at K1's row counts
    on the 262,144 grid-edge and held rows (both of its modes); ES the
    same way on a K = 3 stack of three synthetic class forests (on those
    262,144 rows) and on phase 17's linear forest (the 262,144 valid
    rows with NaN and inf cells); QC bitwise on
    hand-made grids and rows (`qc_edge_cases`: subnormals, +-0, +-inf,
    NaN, values equal to a bound, both missing types, columns past the
    grid, grids of 1 and 255 bounds and of 64 features, N x F not a
    multiple of 4, unaligned views);
22. serving-extras main path: Booster(model_str=...) of the binned
    500 x 255 x 28 forest on the default device, 262,144 rows through
    predict with pred_early_stop (freq 10, phase 21's margin) and with
    tpu_predict_quantize=f16 and int8; the gate's delta within
    tpu_predict_quantize_tol; through Predictor the gate waits out
    warmup and measures the first real request; pred_early_stop on 256
    of the rows (ES's trees mode) equal to the bulk call's; every count
    of ES, QC, QW and K1-f16 set to 0 before and read after (K1-f16's,
    QW's and ES's by mode; ES must have launched both);
    the bulk raw scores equal to the plain versions on the same rows;
    K1-f16 bitwise its plain version and its repeat at 1 and 262,144
    rows; pred_early_stop
    ignored by a regression model; pred_contrib on 2,048 rows of phase
    9's model (row sums within 1e-5 * max(1, |raw|)); dump_model as
    JSON; predict from a 4,096-row TSV of the valid set equal to the
    array call;
23. continued training: phase 9's saved model continues through
    train(..., init_model=path) on phase 9's Datasets: the 0-round
    replay (W once a tree) within 1e-5 * max(1, |ref|) of phase 9's
    final train score, W on the train bins as the replay walks them
    (`GBDT._walk_binned`) bitwise its plain version and a repeat; 10 more rounds twice, byte-identical, H, S, R
    and W launched, valid AUC not below phase 9's; card against CPU on
    the phase-11 protocol, 3 + 3 rounds: the same structure, leaves
    within 1e-5 relative;
24. times: ES, QC, QW and K1-f16 at 262,144 rows (CUDA events, median
    of 12 after 0.3 s of calls), their plain versions (median of 5),
    bounds (ES over the node visits of the trees each row walked), QC's
    yardstick torch.searchsorted over the [F, K] grid; QC and
    torch.searchsorted also as device time alone (a CUDA graph of one
    call, replayed), which the JSON row keeps, and K1-f16 and ES the
    same way (also on one row; ES on one row at the main path's margin
    and at 1e30, never frozen), and QW the same way, with its two modes either
    side of the crossover; Booster.predict end to end for f32, f16, int8
    and early stop; Predictor.predict_one p50 and p99 over 200 requests
    for f32, f16 and int8;
25. GOSS, DART and RF main paths on the phase-9 Datasets, every count
    set to 0 before each run and read after it: boosting=goss (top_rate
    0.2, other_rate 0.1, 20 rounds: it samples from round 11), GT and GW
    launched once a sampled round; boosting=dart (drop_rate 0.1,
    skip_drop 0.5, max_drop 50, drop_seed 4, 10 rounds), W launched once
    a round for the valid set and three times a dropped tree, and W
    taking the last dropped tree off the 2,000,000 train rows (as DART
    walks them, sign -1) bitwise its plain version and a repeat;
    boosting=rf (bagging_fraction 0.7, bagging_freq 1, feature_fraction
    0.7, 10 rounds), R's average mode once a round for the train score
    and once for the valid set, W and M once a round; every H launch in
    hi+lo mode (the default tpu_hist_bf16); each run twice with
    byte-identical model texts; valid AUC finite and above 0.7; the saved
    model reloaded and served through K1 within 1e-5 * max(1, |ref|) of
    the valid scores kept in training (RF through average_output);
26. GT and GW against their plain versions on the card: on the GOSS
    run's gradients at rounds 11 and 20, on all-equal and all-zero
    magnitudes, ties at the k-th value (and top_k at a run of ties'
    end), NaN and inf magnitudes (a NaN threshold too), 70% zero
    magnitudes (a zero threshold too), subnormal products and inputs
    (read as zero, as XLA does), at top_k 1, n - 1 and n, and on
    1,000,003 rows: weights and threshold bitwise, the threshold bitwise
    the replay of GT's select (ops/goss.py goss_threshold_order) and
    equal to np.partition on the host (a NaN the smallest), a second
    launch repeating the bits;
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
    leaves, learning rate 0.5 (GOSS samples from round 3), 3 rounds: the
    same trees, leaves within 1e-5 relative, valid AUC within 2e-3;
29. times (CUDA events or torch.profiler, median of 12 after 0.3 s of
    calls; GT and GW by CUDA-graph replay): GT + GW at 2,000,000 rows
    against their plain versions and
    torch.kthvalue (the library yardstick, checked equal), H hi+lo
    against H f32 at the root, R's average mode, seconds per round of
    goss (its sampled rounds), dart and rf, and one profiled GOSS
    round's idle share;
30. uint16 kernels against their plain versions on the Bosch matrix
    (phase 31's Datasets): H in f32 and hi+lo modes at the root (the
    first round's and the tenth's gradients), on the root split's
    smaller child as a row list and on a random quarter of the rows in
    random order (the tenth's): counts exact, g/h within 1e-5 *
    max(1, |ref|) of the plain version and of an f64 oracle (hi+lo: the
    f64 sum of the exact halves), a second launch repeating the bits; S
    on the root and on the root split's two children, and on that leaf
    pair with a seeded feature mask, with max_depth 2 blocking the
    second leaf and with the second leaf emptied (no split valid: the
    flat-index-0 pick), and (phase 34) at ~1,024 and at 2,048 bins a
    feature on the max_bin=1023 root, bitwise its plain version and its
    repeat; R's partition and leaf ids on the root split
    and W's value and leaf modes (the first tree, the 100,000 valid
    rows), exactly; every group of every H launch (lane-private and
    warp-shared) bit for bit the replay of its summation order; H on
    262,144 rows
    of the uint8 HIGGS matrix (B 64) and on 65,536 rows of seeded bins at
    B 256, both modes, all rows and a row list, bit for bit the replay of
    its summation order (leaf_histogram_order);
31. the Bosch main path: bench.py's bosch shape, synth_bosch(600,000,
    968, seed 2), rows 0-499,999 training and 500,000-599,999 valid
    (338 EFB groups: 70 of 631 bins, the rest of at most 63; a uint16
    matrix), binary, metric auc, max_bin 63, 255 leaves, learning rate
    0.1, min_data_in_leaf 1, min_sum_hessian_in_leaf 100, 10 rounds
    through lightgbm_tpu_torch.train on the default device, every count
    set to 0 before and read after: H (all in its uint16 hi+lo mode), S,
    R and W (uint16) launched; a second run's model text byte-identical;
    valid AUC rising from round 1 to 10; the saved model reloaded and
    served through K1 at 968 features within 1e-5 * max(1, |ref|) of
    the valid scores W kept; 3 rounds with tpu_hist_bf16=false (H's
    uint16 f32 mode);
32. files and the binary cache: 10,000 Bosch rows written as a TSV,
    label first (each value the shortest decimal of its float64);
    Dataset(path) streamed in chunks of 8,192 rows (the last one
    ragged) and loaded whole (tpu_ingest=false), both bitwise the array
    Dataset's matrix and labels, 3 rounds from the file giving the
    array Dataset's model text; save_binary of the 500,000-row training
    Dataset, load_binary, the matrix equal and 3 rounds giving the same
    text, with the save, load and skipped binning times; a mismatched
    fingerprint raising CacheMismatch, a corrupted byte CacheCorrupt
    and the file quarantined;
33. the card against the CPU on Bosch at 65,536 rows (16,384 valid), 63
    leaves, 3 rounds: the same trees, leaves within 1e-5 relative,
    valid AUC within 2e-3; then 3 rounds of linear trees on those
    uint16 Datasets (W's leaf mode, LF, LS, LA launched);
34. the HIGGS protocol of phase 9 at max_bin=1023 (28 single-feature
    groups of up to 1,023 bins, uint16): 3 rounds with every S launch
    past 256 bins a feature, twice and byte-identical; S on its root
    against its plain version (phase 30); the card against the CPU at
    131,072 rows, 63 leaves, 3 rounds;
35. H's warp-shared pass and its reduction, in both modes, each case
    bitwise the replay of its summation order, repeating its bits and
    within 1e-5 * max(1, |ref|) of plain and of the f64 oracle
    (`hold_wide_cases`): the Bosch matrix on row lists of 0, 1 and 37
    rows, the max_bin=1023 root, 262,144 seeded rows of groups of 2,048,
    1,023, 631, 352, 351, 63 and 7 bins (all rows and a third) and
    cancelling gradients on one 631-bin group (2,000,000 rows in four
    bins), its error against the f64 sums printed beside f32 chains';
    then times (CUDA-graph replay for H, CUDA events or torch.profiler
    for the rest, median of 12 after 0.3 s of calls): H's uint16 f32
    and hi+lo modes at the Bosch root (and its row list) against their
    bound, their plain versions, torch.bincount x3 (x5 for hi+lo) over
    group x B + bin and H's uint8 time at the HIGGS root, with the
    blocks, tiles and partial bytes of each mode's plans; both modes at
    the max_bin=1023 root against its bound; S on the
    Bosch leaf pair and at ~1,024 bins (by CUDA-graph replay); R (as
    in phase 12, and its device ms in the profiled Bosch round) and
    W
    (both modes) on uint16 bins; Dataset.construct() of the 500,000
    rows; seconds per Bosch round (median of rounds 2-10); one profiled
    Bosch round's idle share;
36. categorical kernels against their plain versions on phase 37's
    Datasets: S on the root and on the root split's two children, and on
    that pair's feature-mask, max_depth and empty-leaf cases (phase 30),
    bitwise its plain version and its repeat (at least one categorical
    feature wins a split in the first tree); R's partition and leaf ids on the
    root split and on the first tree's first categorical split (every
    row), exactly; W's value and leaf modes on the first tree (with its
    categorical nodes) over the 100,000 test rows, exactly; K1 serving
    the saved model within 1e-5 * max(1, |ref|) of W's scores;
37. the categorical main path: the protocol behind ACCURACY_r05.json's
    categorical gate (scripts/measure_accuracy.py:114-146),
    synth_expo(600,000, seed 13), rows 0-499,999 training and the rest
    test, 40 features of which 8 categorical (12-96 categories),
    categorical_feature=[0..7] in the params, binary, metric auc,
    max_bin 63, 255 leaves, learning rate 0.1, min_data_in_leaf 1,
    min_sum_hessian_in_leaf 100, a uint8 matrix; 10 rounds through
    lightgbm_tpu_torch.train with every count set to 0 before and read
    after: H, S (every launch in its categorical variant), R and W
    launched, R and W on categorical nodes; a second run's model text
    byte-identical; valid AUC rising; LGBMClassifier(...).fit(X, y,
    categorical_feature=[0..7]) for 10 rounds gives the same model text;
    then 500 rounds, whose test AUC (raw scores, the script's rank
    statistic) must lie within 2e-3 of reference LightGBM's 0.815114,
    printed beside the JAX package's 0.815474;
38. categorical, the card against the CPU: the protocol at 131,072
    rows, 63 leaves, 3 rounds: the same trees, leaves within 1e-5
    relative, valid AUC within 2e-3; 50,000 rows written as a TSV (label
    first), Dataset(path, params={"categorical_column": "0,...,7"}) (the
    indices count features, not the label column) bitwise the array
    Dataset's matrix, 3 rounds giving its model text;
39. HQ and LM on uint16 bins against their plain versions: HQ in int8
    and int16 at the Bosch root (round 1's and round 10's codes), on the
    first tree's root split's smaller child as a row list and on a
    random quarter of the rows in random order, exactly, a second launch
    repeating the int32 histogram; HQ at the max_bin=1023 root; HQ on the
    uint8 HIGGS matrix exactly (its uint16 mode not launched); on the
    Bosch and the uint8 HIGGS matrices HQ at the root and on a seeded
    1,000-row list, both again with a fifth of w01 at 0, and under plans
    whose skipped bins hold none of those rows, exactly and repeating; LM at
    max_bin=1023 on the last linear tree's leaves (phase 40), on seeded
    65,536 x 70 uint16 rows at its width (phase 18's cases), and LM on
    the uint8 HIGGS matrix over phase 9's last tree's leaves, within
    1e-5 * max(1, sum of |terms|) of the plain version and of an f64
    oracle, bitwise their replays, repeats equal;
40. the quantized uint16 main paths on phase 31's Bosch Datasets, every
    count set to 0 before each run and read after: int8 (twice,
    byte-identical), int16 and int8 + bagging 0.8 every round, 10 rounds
    each: HQ launched once a split and for the gate's quantized tree,
    every launch in its uint16 mode, H only for the gate's f32 tree, Q
    once a round and once for the gate, M once a round when bagging;
    valid AUC rising and within 0.02 of phase 31's; on phase 34's
    max_bin=1023 Datasets int8 for 3 rounds, and linear trees for 3
    rounds with leaf_feature_moments (LM u16) of the last tree's leaves;
    the card against the CPU on Bosch at 65,536 rows, int8 and int16, 3
    rounds: the same trees, leaves within 1e-5 relative;
41. times (CUDA events or torch.profiler, median of 12 after 0.3 s of
    calls; HQ and S's categorical scan by CUDA-graph replay): HQ u16
    at the Bosch root, on its row list and at the max_bin=1023 root
    against its bound, torch.bincount x3 (the codes as
    weights), its plain version and HQ at the uint8 HIGGS root; LM u16
    (CUDA-graph replay, the call's events and host time) against its
    bound, torch.bincount x4, one index_add_ of the [rows x groups, 4]
    channels into the [(ids + 1) x groups x bins, 4] output (the JSON
    row's yardstick), its plain version and LM on uint8 bins;
    S's categorical scan on an Expo leaf pair, R on the categorical
    split (as in phase 12, and its ms in the profiled categorical round)
    and W on the categorical tree; seconds per round of
    the categorical path and of the three quantized Bosch runs against
    phase 31's round; one profiled categorical round's and one profiled
    Bosch int8 round's idle share; the 500-round run's wall time.

Phases 5-34 train with the default tpu_hist_bf16, so H runs in its
hi+lo mode on their paths; phase 9's tpu_hist_bf16=false run is the
path of its f32 mode, and phase 10 holds that mode to its plain version
(phase 31's 3-round run and phase 30 the same for uint16 bins).

The line before the last is the kernels' JSON summary, the last line
`{"ok": true, "device": {...}}`.
"""
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

TREES, LEAVES, FEATURES = 500, 255, 28
BULK_ROWS = 262_144
CHECK_ROWS = 16_384
# rows of the calls whose host time LM's timings report: few enough that
# the device keeps up with the launches
LM_HOST_ROWS = 1000
# rows of the k = 64 linear design (phase 18): its f64 oracle holds
# [rows, 65 x 65] products
WIDE_ROWS = 65_536
# the A/B's LS widths on seeded systems (k, leaves): the register mode's
# last k and the block mode's first (k 16), then k 120
LS_AB_WIDTHS = ((15, 255), (16, 255), (120, 4))
# K1's rows read from device memory (phase 2): 300-column rows, whose
# staged block would pass the card's shared memory
K1_WIDE_FEATURES, K1_WIDE_ROWS = 300, 65_536
# trees of 4,096 leaves (4,095 nodes, 64 KB of records each, more than
# K1's record buffer) grow over 32,768 sample rows
BIG_LEAVES, BIG_SAMPLE_ROWS = 4096, 32_768
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
CPU_ROWS, CPU_VALID_ROWS, CPU_LEAVES, CPU_ROUNDS = 131_072, 32_768, 63, 3
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


def bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


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


def graph_ms(fn, reps=50, calls=1):
    """Device time of one fn() call without its host time: a CUDA graph
    captures `calls` calls and is replayed `reps` times between two
    events after a spin-up; the mean a call. A replay costs the host
    about 8 us (PERF.md, PR 18), so a graph of one call cannot time a
    shorter one: those take calls=20."""
    spin_up(fn)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / calls


# the calls a CUDA graph captures to time a call shorter than a replay's
# host cost
SHORT_CALLS = 20


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


def tree_bytes(bt):
    """The bytes of W's packed tree: its 16-byte records and bitsets."""
    return 4 * (bt.recs.numel() + bt.bits.numel())


def hold_w_train(label, gbdt, tree, sign):
    """W on the train bins as DART's drops, rollback and the continued-
    training replay walk them (`GBDT._walk_binned`: the grower's
    column-major copy where rows are wide, else the matrix): sign times
    the tree's values added to the train score, bitwise the plain
    version and a repeat."""
    from lightgbm_tpu_torch.ops import predict
    bins = gbdt._walk_binned
    n = bins.shape[0]
    by_columns = predict.walk_by_columns(gbdt._binned)
    check(bins.stride() == ((1, n) if by_columns else (bins.shape[1], 1)),
          "%s: W's train bins have strides %s" % (label, bins.stride()))
    bt = predict.binned_tree(tree, bins.device, tree.leaf_value * sign)
    outs = []
    for fn in (predict.tree_value_walk_binned, predict.tree_value_walk_binned,
               predict.tree_value_walk_binned_plain):
        sc = gbdt._score[0].clone()
        fn(bt, bins, sc)
        outs.append(sc)
    check(all(bitwise(outs[0], o) for o in outs[1:]),
          "W on the train bins (%s): not bitwise its repeat and plain"
          % label)
    print("W vs plain [%s, %d train rows x %d groups, %s-major, sign %+g]: "
          "bitwise, repeats equal" % (label, n, bins.shape[1], "column"
                                      if by_columns else "row", sign))


def k1_counts(P, n_max):
    """The row counts K1 is held at: its trees mode (1 to 4,096 rows),
    either side of the crossover to rows mode, and the bulk shape."""
    return [n for n in (1, 7, 32, 256, 4096, P.TREE_PARALLEL_MAX_ROWS,
                        P.TREE_PARALLEL_MAX_ROWS + 1, BULK_ROWS)
            if n <= n_max]


def hold_k1(label, walk, forest, x, ref, P):
    """walk(forest, rows) on the first n rows of x for each k1_counts n,
    twice: bitwise the plain output `ref` on those rows and its repeat.
    Returns the largest |walk - plain|."""
    err, modes = 0.0, []
    for n in k1_counts(P, x.shape[0]):
        xn = x[:n].contiguous()
        got, again = walk(forest, xn), walk(forest, xn)
        torch.cuda.synchronize()
        check(bitwise(got, ref[:n]) and bitwise(got, again),
              "%s: K1 not bitwise equal to plain and its repeat at %d rows"
              % (label, n))
        err = max(err, float((got - ref[:n]).abs().max()))
        modes.append("%d (%s mode)" % (n, P.walk_plan(
            forest.num_trees, forest.split_feature.shape[1],
            forest.num_features, n, forest.linear_k > 0).mode))
    print("kernels vs plain [%s]: bitwise equal to plain and its repeat at "
          "%s rows" % (label, ", ".join(modes)))
    return err


def hold_k2(label, forest, x, P):
    """K2 on the first n rows of x for each k1_counts n, twice: equal to
    the plain leaves on those rows and to its repeat. Returns the largest
    |K2 - plain|."""
    ref = P.forest_leaf_walk_plain(forest, x)
    err, modes = 0, []
    for n in k1_counts(P, x.shape[0]):
        xn = x[:n].contiguous()
        got, again = P.forest_leaf_walk(forest, xn), P.forest_leaf_walk(
            forest, xn)
        torch.cuda.synchronize()
        check(torch.equal(got, ref[:n]) and torch.equal(got, again),
              "%s: K2 not equal to plain and its repeat at %d rows"
              % (label, n))
        err = max(err, int((got - ref[:n]).abs().max()))
        plan = P.walk_plan(forest.num_trees, forest.split_feature.shape[1],
                           forest.num_features, n, output="leaf")
        modes.append("%d (%s mode%s)" % (n, plan.mode, ", tile %d" % (
            plan.tile_trees) if plan.mode == "rows" else ""))
    print("kernels vs plain [%s]: K2 equal to plain and its repeat at %s "
          "rows" % (label, ", ".join(modes)))
    return err


def hold_qw(label, P, qf, f16, x, codes):
    """QW on the first n rows of x (and their codes) for each k1_counts n,
    twice: bitwise the plain version on the full rows' codes, its repeat
    and K1-f16 on the same rows. Returns the largest |QW - plain|."""
    ref = P.forest_quant_walk_plain(qf, codes, x)
    err, modes = 0.0, []
    for n in k1_counts(P, x.shape[0]):
        xn, cn = x[:n].contiguous(), codes[:n].contiguous()
        got, again = (P.forest_quant_walk(qf, cn, xn),
                      P.forest_quant_walk(qf, cn, xn))
        half = P.forest_value_walk_f16(f16, xn)
        torch.cuda.synchronize()
        check(bitwise(got, ref[:n]) and bitwise(got, again)
              and bitwise(got, half),
              "%s: QW not bitwise equal to plain, its repeat and K1-f16 at "
              "%d rows" % (label, n))
        err = max(err, float((got - ref[:n]).abs().max()))
        modes.append("%d (%s mode)" % (n, P.walk_plan(
            qf.walk.num_trees, qf.walk.split_feature.shape[1],
            qf.walk.num_features, n, value_bytes=2).mode))
    print("kernels vs plain [%s]: QW bitwise equal to plain, its repeat and "
          "K1-f16 at %s rows" % (label, ", ".join(modes)))
    return err


# rows of R's late small segment: a deep leaf's, spread over the matrix
ROUTE_LATE_ROWS = 3000


def route_call(route, binned, src, n, rule, lid, scratch, out=None):
    """R as the grower calls it: src[0:n] into another buffer, with the
    grower's scratch and count buffer."""
    out = torch.empty_like(src) if out is None else out
    cnt = torch.empty(1, dtype=torch.int32, device=src.device)
    return lambda: route.route_partition(binned, src, 0, n, rule, lid,
                                         count_out=cnt, out=out,
                                         scratch=scratch)


def hold_route(label, binned, rule, seed=0):
    """R against its plain version on segments of route_sizes rows and a
    late small one (sorted row ids drawn from the whole matrix, as a deep
    leaf holds them), on `rule` and its all-left and all-right numeric
    variants; in place, and as the grower calls it (into another buffer,
    with one scratch for every call), on the bins as they are and on a
    column-major copy: the reordered segment, the leaf ids and the left
    count exact, and the source buffer untouched. Returns the cases."""
    import dataclasses
    from lightgbm_tpu_torch.ops import route
    dev, n = binned.device, binned.shape[0]
    gen = np.random.RandomState(seed)
    sizes = [0, 1, route.PASS_ROWS - 1, route.PASS_ROWS,
             route.PASS_ROWS + 1, 5 * route.PASS_ROWS + 77, ROUTE_LATE_ROWS]
    rules = [rule] + [dataclasses.replace(
        rule, is_cat=False, threshold=thr, default_left=dl)
        for thr, dl in ((rule.num_bin + 1, True), (-1, False))]
    layouts = (binned, binned.t().contiguous().t())
    scratch = route.route_scratch(n, dev)
    cases, lefts = 0, []
    for m in sizes:
        src = torch.arange(n, dtype=torch.int32, device=dev)
        src[:m] = torch.from_numpy(np.sort(gen.choice(n, m, replace=False))
                                   .astype(np.int32)).to(dev)
        for r in rules:
            ref, lid_p = src.clone(), torch.zeros(n, dtype=torch.int32,
                                                  device=dev)
            n_p = int(route.route_partition_plain(binned, ref, 0, m, r,
                                                  lid_p))
            for mat in layouts:
                lid = torch.zeros(n, dtype=torch.int32, device=dev)
                inplace = src.clone()
                n_k = int(route.route_partition(mat, inplace, 0, m, r, lid))
                out = torch.full_like(src, -1)
                lid2 = torch.zeros(n, dtype=torch.int32, device=dev)
                cnt = torch.full((1,), -1, dtype=torch.int32, device=dev)
                keep = src.clone()
                route.route_partition(mat, src, 0, m, r, lid2, count_out=cnt,
                                      out=out, scratch=scratch)
                torch.cuda.synchronize()
                check(n_k == n_p == int(cnt) and torch.equal(inplace, ref)
                      and torch.equal(out[:m], ref[:m])
                      and bool((out[m:] == -1).all())
                      and torch.equal(src, keep)
                      and torch.equal(lid, lid_p) and torch.equal(lid2, lid_p),
                      "%s: R differs from plain at %d rows (rule %s, bins "
                      "strides %s)" % (label, m, r, mat.stride()))
                cases += 2
            lefts.append(n_p)
    print("kernels vs plain [%s]: R equal to plain (partition, leaf ids, "
          "left count) on segments of %s rows (the last a late small one), "
          "the split and its all-left and all-right variants, in place and "
          "into another buffer, row- and column-major bins: %d cases"
          % (label, ", ".join(str(m) for m in sizes), cases))
    return cases


def late_segment(n, dev):
    """A row buffer whose first ROUTE_LATE_ROWS ids are a late small
    segment: sorted ids drawn from the whole matrix (seeded)."""
    src = torch.arange(n, dtype=torch.int32, device=dev)
    src[:ROUTE_LATE_ROWS] = torch.from_numpy(np.sort(
        np.random.RandomState(5).choice(n, ROUTE_LATE_ROWS, replace=False))
        .astype(np.int32)).to(dev)
    return src


def route_times(label, binned, rule, name, card):
    """R as the grower calls it, device time at the root on the bins as
    they are and on a column-major copy (the grower's), and on a late
    small segment: CUDA-graph replays (which add a replay's few us to a
    small launch) and torch.profiler's kernel time; the call's host time
    (no synchronisation). Returns the root's graph ms on the column-major
    copy, as the grower reads it."""
    from lightgbm_tpu_torch.ops import route
    dev, n = binned.device, binned.shape[0]
    scratch = route.route_scratch(n, dev)
    lid = torch.zeros(n, dtype=torch.int32, device=dev)
    root = torch.arange(n, dtype=torch.int32, device=dev)
    late = late_segment(n, dev)
    cols = binned.t().contiguous().t()
    ms = {}
    for key, mat, src, m in (("root, row-major", binned, root, n),
                             ("root, column-major", cols, root, n),
                             ("late %d rows, row-major" % ROUTE_LATE_ROWS,
                              binned, late, ROUTE_LATE_ROWS),
                             ("late, column-major", cols, late,
                              ROUTE_LATE_ROWS)):
        fn = route_call(route, mat, src, m, rule, lid, scratch)
        ms[key] = (graph_ms(fn), device_ms(fn, ("partition_kernel",)))
    host = host_us(route_call(route, cols, late, ROUTE_LATE_ROWS, rule, lid,
                              scratch))
    print("time [%s | %s]: R (%s, %d rows, %s bins) device ms (CUDA-graph "
          "replay / profiler): %s; a call's host time %.1f us; the "
          "column-major copy %.1f MB"
          % (name, card, label, n, str(binned.dtype).split(".")[-1],
             ", ".join("%s %.4f / %.4f" % ((k,) + v) for k, v in ms.items()),
             host, cols.numel() * cols.element_size() / 1e6))
    del cols
    return ms["root, column-major"][0]


def round_r_ms(by_kind):
    """R's device ms in a profiled round (profile_round's by_kind)."""
    return sum(v for k, v in by_kind.items() if "partition_kernel" in k) / 1e3


def held_rows(trees, nf, cats, n):
    """n rows to hold K1 on: 4,096 edge cases (`edge_case_rows`), 4,096
    seeded rows with NaN, +inf and -inf cells, then seeded rows."""
    from lightgbm_tpu_torch.testing.synth import edge_case_rows, synthetic_rows
    special = synthetic_rows(8, 4096, nf, cats)
    special[::3, ::2] = np.inf
    special[1::3, 1::2] = -np.inf
    special[2::3, ::3] = np.nan
    special[::5, 1::4] = np.nan
    return np.concatenate([edge_case_rows(trees, nf, 3, 4096, cats), special,
                           synthetic_rows(2, n - 8192, nf, cats)])


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
    from lightgbm_tpu_torch.ops.histogram import take_bins
    g_cnt = binned.shape[1]
    sel = torch.arange(binned.shape[0], device=binned.device) \
        if rows is None else rows.long()
    w = w3[sel].double()
    vals = torch.stack([w[:, 0], w[:, 1], (w[:, 2] > 0).double()], 1)
    flat = (torch.arange(g_cnt, device=binned.device) * num_bins)[None] \
        + take_bins(binned, sel)
    out = torch.zeros(g_cnt * num_bins, 3, dtype=torch.float64,
                      device=binned.device)
    out.index_add_(0, flat.reshape(-1), vals[:, None, :].expand(
        -1, g_cnt, 3).reshape(-1, 3))
    return out.view(g_cnt, num_bins, 3)


def hold_hist(label, binned, w, nb, bf16, layout=None, rows=None,
              cnt=None):
    """H on `binned` (a uint16 matrix with its `layout`) against its
    repeat (the same bits, written into an `out` view one float off a
    16-byte boundary, as the grower's views of its histogram pool may
    be), the replay of its summation order (bit for bit, every group),
    its plain version and the f64 oracle (hi+lo: the f64 sum of the
    exact halves). Returns (H, its max abs error against plain)."""
    from lightgbm_tpu_torch.ops import histogram

    def call(out=None):
        return histogram.leaf_histogram(binned, w, nb, rows=rows, n_rows=cnt,
                                        out=out, bf16=bf16, layout=layout)
    got = call()
    shape = tuple(got.shape)
    pool = torch.full((got.numel() + 1,), float("nan"), device=got.device)
    check(torch.equal(got, call(pool[1:].view(shape))),
          "%s: a second launch (into an unaligned view) gave other bits"
          % label)
    check(torch.equal(got, histogram.leaf_histogram_order(
        binned, w, nb, rows, cnt, bf16, layout)),
        "%s: not its summation order" % label)
    sel = None if rows is None else rows[:cnt]
    if bf16:
        hi, lo = histogram.hi_lo(w[:, :2].contiguous())
        oracle = hist_oracle(binned, torch.cat([hi, w[:, 2:3]], 1), nb, sel)
        oracle[..., :2] += hist_oracle(binned, torch.cat(
            [lo, w[:, 2:3]], 1), nb, sel)[..., :2]
    else:
        oracle = hist_oracle(binned, w, nb, sel)
    err = sums_err(got, histogram.leaf_histogram_plain(
        binned, w, nb, rows, cnt, bf16), oracle, label)
    return got, err


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
    hold_route("HIGGS root split, uint8", binned, rule)
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
        check(torch.equal(h_list, histogram.leaf_histogram_order(
            binned, w, nb, rows=perm[b0:], n_rows=cnt)),
            "H row list (%s): not its summation order" % label)
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
    check(torch.equal(h_late, histogram.leaf_histogram_order(
        binned, w10, nb)), "H all rows: not its summation order")
    late = "gradients after %d rounds" % TRAIN_ROUNDS
    errs["leaf_histogram"] = max(errs["leaf_histogram"],
                                 children(w10, h_late, None, late)[0])
    # hi+lo at the root and on the smaller child, both gradients: bit for
    # bit its summation order, within 1e-5 of plain and of the f64 sum of
    # the exact halves
    hilo_err = 0.0
    for w in (w3, w10):
        hi, lo = histogram.hi_lo(w[:, :2].contiguous())
        for rows, c in ((None, None), (perm[b0:], cnt)):
            got = histogram.leaf_histogram(binned, w, nb, rows=rows,
                                           n_rows=c, bf16=True)
            check(torch.equal(got, histogram.leaf_histogram_order(
                binned, w, nb, rows, c, bf16=True)),
                  "H hi+lo (%s): not its summation order"
                  % ("all rows" if rows is None else "row list"))
            sel = None if rows is None else rows[:c]
            oracle = hist_oracle(binned, torch.cat([hi, w[:, 2:3]], 1), nb,
                                 sel)
            oracle[..., :2] += hist_oracle(binned, torch.cat(
                [lo, w[:, 2:3]], 1), nb, sel)[..., :2]
            hilo_err = max(hilo_err, sums_err(
                got, histogram.leaf_histogram_plain(binned, w, nb, rows, c,
                                                    bf16=True), oracle,
                "H hi+lo at the main path's shapes"))
    print("H hi+lo [%d rows x %d groups]: root and smaller child, round-1 "
          "and round-%d gradients: bitwise its summation order, max abs "
          "err %.3g against plain" % (TRAIN_ROWS, binned.shape[1],
                                      TRAIN_ROUNDS, hilo_err))
    del w10, g10, h10, h_late, hi, lo, oracle
    # cancelling gradients at the root's shape: each bin's g sum is a
    # small part of its terms' magnitudes, where f32 chains of f32 values
    # miss 1e-5 * max(1, |ref|); H sums in f64 and rounds once
    gen = np.random.RandomState(1)
    cb = torch.from_numpy(gen.randint(0, 64, (TRAIN_ROWS, FEATURES))
                          .astype(np.uint8)).to(dev)
    mask_c = (gen.rand(TRAIN_ROWS) < 0.9).astype(np.float32)
    wc = torch.from_numpy(np.stack([
        gen.randn(TRAIN_ROWS).astype(np.float32) * 0.5 * mask_c,
        gen.rand(TRAIN_ROWS).astype(np.float32) * 0.25 * mask_c, mask_c],
        1)).to(dev)
    c_rows = torch.from_numpy(gen.permutation(TRAIN_ROWS)[:966_119]
                              .astype(np.int32)).to(dev)
    cancel = {}
    for bf16 in (False, True):
        if bf16:
            hi, lo = histogram.hi_lo(wc[:, :2].contiguous())
        for rows, c in ((None, None), (c_rows, int(c_rows.shape[0]))):
            label = "H %s on cancelling gradients (%s)" % (
                "hi+lo" if bf16 else "f32",
                "all rows" if rows is None else "%d-row list" % c)
            got = histogram.leaf_histogram(cb, wc, 64, rows=rows, n_rows=c,
                                           bf16=bf16)
            check(torch.equal(got, histogram.leaf_histogram(
                cb, wc, 64, rows=rows, n_rows=c, bf16=bf16)),
                label + ": a second launch gave other bits")
            check(torch.equal(got, histogram.leaf_histogram_order(
                cb, wc, 64, rows, c, bf16=bf16)),
                label + ": not its summation order")
            if bf16:
                oracle = hist_oracle(cb, torch.cat([hi, wc[:, 2:3]], 1), 64,
                                     rows)
                oracle[..., :2] += hist_oracle(cb, torch.cat(
                    [lo, wc[:, 2:3]], 1), 64, rows)[..., :2]
            else:
                oracle = hist_oracle(cb, wc, 64, rows)
            plain = histogram.leaf_histogram_plain(cb, wc, 64, rows, c,
                                                   bf16=bf16)
            sums_err(got, plain, oracle, label)
            d = (got[..., :2].double() - oracle[..., :2]).abs()
            cancel[label] = float((d / oracle[..., :2].abs().clamp(
                min=1.0)).max())
            errs["leaf_histogram"] = max(errs["leaf_histogram"], float(
                (got[..., :2] - plain[..., :2]).abs().max()))
    print("H on cancelling gradients [%d rows x %d groups, B 64]: bitwise "
          "its summation order, repeats equal, within 1e-5 of plain and "
          "f64; error against f64 relative to max(1, |ref|): %s"
          % (TRAIN_ROWS, FEATURES, "; ".join(
              "%s %.3g" % (k[2:], v) for k, v in cancel.items())))
    del cb, wc, c_rows, got, plain, oracle
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
    check(vb.is_contiguous() and not predict.walk_by_columns(vb),
          "the narrow valid bins W walks are not row-major (strides %s)"
          % (vb.stride(),))
    walked = []
    # the booster's row-major bins, and the same bins column-major
    for bins in (vb, vb.t().contiguous().t()):
        for fn in (predict.tree_value_walk_binned,
                   predict.tree_value_walk_binned,
                   predict.tree_value_walk_binned_plain):
            sc = torch.zeros(VALID_ROWS, dtype=torch.float32, device=dev)
            fn(bt, bins, sc)
            walked.append(sc)
    check(all(bitwise(walked[0], sc) for sc in walked[1:]),
          "W differs between launches, layouts or from plain")
    errs["tree_value_walk_binned"] = 0.0
    print("training kernels vs plain [first tree, %d rows]: H all rows "
          "and row list (%d rows), on the first tree's gradients and on "
          "those after %d rounds, within 1e-5 of plain and f64 (max abs "
          "err %.3g), counts exact; S root and children (both gradients) "
          "bitwise; R partition, leaf ids and score update exact; W bitwise "
          "on %d valid rows, row- and column-major; every kernel repeated "
          "its bits"
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
    # H's device time by CUDA-graph replay: one to three kernels a call
    times["leaf_histogram"] = (
        graph_ms(lambda: histogram.leaf_histogram(binned, w3, nb)),
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
          % (name, card, cnt, n, graph_ms(
              lambda: histogram.leaf_histogram(binned, w3, nb, rows=perm[b0:],
                                               n_rows=cnt)),
             median_ms(lambda: histogram.leaf_histogram_plain(
                 binned, w3, nb, rows=perm[b0:], n_rows=cnt), reps=5),
             b_ms, b_by))
    print("time [%s | %s]: leaf_histogram root, CUDA events around the "
          "call %.4f ms" % (name, card, median_ms(
              lambda: histogram.leaf_histogram(binned, w3, nb))))
    # S: the two children of the root split
    s_ops = 2 * fmeta["num_bin"].shape[0] * fb * 50
    times["split_scan"] = (
        graph_ms(lambda: split.split_scan(pair, csums, depth1, fmeta, mask,
                                          prm, fb)),
        median_ms(lambda: split.split_scan_plain(pair, csums, depth1, fmeta,
                                                mask, prm, fb), reps=5),
        bound(pair.numel() * 4 + 64, s_ops), None)
    # R: the root split of all rows; routing a routed segment again
    # repeats the same work and leaves it as it is
    rperm, rlid = perm0.clone(), lid0.clone()
    times["route_partition"] = (
        route_times("HIGGS", binned, rule, name, card),
        median_ms(lambda: route.route_partition_plain(binned, rperm, 0, n,
                                                     rule, rlid), reps=5),
        bound(13 * n), None)
    check(torch.equal(rperm, perm) and torch.equal(rlid, lid),
          "R: routing the routed rows again changed them")
    sc = gb._score[0].clone()
    print("time [%s | %s]: R score update (%d rows) %.4f ms device time"
          % (name, card, n, device_ms(lambda: route.score_update(
              sc, lid, values, 0.1), ("score_kernel",))))
    # score_update as the trainer calls it once a tree: a graph of 20
    # calls; its bound reads a leaf id and a score and writes the score,
    # 12 bytes a row
    score_row = (graph_ms(lambda: route.score_update(sc, lid, values, 0.1),
                          calls=SHORT_CALLS),
                 median_ms(lambda: route.score_update_plain(
                     sc, lid, values, 0.1), reps=5), bound(12 * n))
    print("time [%s | %s]: score_update (%d rows) %.5f ms (CUDA graph of "
          "%d calls), plain %.3f ms, bound %.5f ms (%s)"
          % (name, card, n, score_row[0], SHORT_CALLS, score_row[1],
             score_row[2][0], score_row[2][1]))
    # W: the first tree on the valid set; a row reads one bin a node it
    # visits
    leaf = predict.tree_leaf_binned_plain(bt, vb)
    depth = torch.from_numpy(leaf_depths([tree0])[0]).to(dev)
    visits = int(depth[leaf].sum())
    sc = torch.zeros(VALID_ROWS, dtype=torch.float32, device=dev)
    times["tree_value_walk_binned"] = (
        graph_ms(lambda: predict.tree_value_walk_binned(bt, vb, sc),
                 calls=SHORT_CALLS),
        median_ms(lambda: predict.tree_value_walk_binned_plain(bt, vb, sc),
                 reps=5),
        bound(visits + 8 * VALID_ROWS + tree_bytes(bt),
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
    print("time [%s | %s]: R in the profiled HIGGS round %.4f ms" % (
        name, card, round_r_ms(profile_round(booster, name, card)[2])))

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
    rows.append({"name": "score_update", "route": "cuda",
                 "source": "lightgbm_tpu_torch/csrc/route_partition.cu",
                 "replaces": "lightgbm_tpu/boosting/gbdt.py:185",
                 "launches": launches["score_update"], "max_abs_err": 0.0,
                 "ms": score_row[0], "plain_ms": score_row[1],
                 "bound_ms": score_row[2][0], "bound_by": score_row[2][1],
                 "library_ms": None})
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


def q_defined(q, g, h, w, hess_const):
    """The rows where Q's plain version defines each code: gw / scale (hw
    / scale) a number. A NaN there is cast to int16 by the plain version,
    which C leaves undefined; the kernel's clip gives -qmax."""
    dg = ~torch.isnan((g * w) / q.qscale[0])
    dh = torch.ones_like(dg) if hess_const else ~torch.isnan(
        (h * w) / q.qscale[1])
    return dg, dh


def q_held(a, b, g, h, w, hess_const):
    """Q's scales and w01 bit for bit, and the codes where both are
    defined (`q_defined`); returns the rows of each channel left out."""
    dg, dh = q_defined(b, g, h, w, hess_const)
    ok = (torch.equal(a.w01, b.w01)
          and torch.equal(a.qscale.view(torch.int32),
                          b.qscale.view(torch.int32))
          and torch.equal(a.codes[:, 0][dg], b.codes[:, 0][dg])
          and torch.equal(a.codes[:, 1][dh], b.codes[:, 1][dh]))
    return ok, int((~dg).sum()), int((~dh).sum())


def graph_node_types(fn):
    """The node types (CUgraphNodeType: 0 kernel, 2 memset) of a CUDA
    graph that captured one fn() call, on a stream where fn() ran once
    before, so no first call's set-up is captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        types.append(kind.value)
    del graph
    return types


def s_held(label, args):
    """S on args = (hist, sums, depth, fmeta, mask, params, fb), bitwise
    its repeat and its plain version; returns its outputs."""
    from lightgbm_tpu_torch.ops import split
    got = split.split_scan(*args)
    for other in (split.split_scan(*args), split.split_scan_plain(*args)):
        check(all(torch.equal(a, b) for a, b in zip(got, other)),
              "S %s: not bitwise its repeat and plain version" % label)
    return got


def s_cases(label, pair, sums, fmeta, prm, fb, dev):
    """S on a leaf pair [2, G, B, 3] in the cases its grid of feature
    tiles and per-leaf pick could get wrong, each bitwise its repeat and
    plain version: both leaves, a seeded feature mask (half the
    features), a max_depth that blocks the second leaf, and a second leaf
    with no rows (no split valid: the flat-index-0 path). Returns the
    case names."""
    import dataclasses
    f_cnt = int(fmeta["num_bin"].shape[0])
    full = torch.ones(f_cnt, dtype=torch.uint8, device=dev)
    half = torch.from_numpy((np.random.RandomState(11).rand(f_cnt) < 0.5)
                            .astype(np.uint8)).to(dev)
    one = torch.ones(2, dtype=torch.int32, device=dev)
    s_held(label + " pair", (pair, sums, one, fmeta, full, prm, fb))
    s_held(label + " pair, feature mask",
           (pair, sums, one, fmeta, half, prm, fb))
    got = s_held(label + " pair, max_depth 2 blocks the second leaf",
                 (pair, sums, torch.tensor([0, 2], dtype=torch.int32,
                                           device=dev), fmeta, full,
                  dataclasses.replace(prm, max_depth=2), fb))
    check(float(got[0][1, 0]) == float("-inf"),
          "S %s: the leaf max_depth blocks got a split" % label)
    empty, esums = pair.clone(), sums.clone()
    empty[1].zero_()
    esums[1].zero_()
    got = s_held(label + " pair, an empty second leaf",
                 (empty, esums, one, fmeta, full, prm, fb))
    check(float(got[0][1, 0]) == float("-inf")
          and got[1][1, :2].tolist() == [0, 0],
          "S %s: the empty leaf is not the flat-index-0 pick" % label)
    return ["pair", "feature mask", "max_depth", "empty leaf"]


def hq_cases(label, binned, q, nb, plan, dev):
    """HQ exactly its plain version and its repeat on the cases its row
    blocks and skipped bins could get wrong: the root, a seeded
    1,000-row list in random order, both again with a fifth of w01 set to
    0 (bagging), and the list and the root under plans whose skipped bins
    hold none of their rows where a group has such a bin. Returns the
    number of groups whose skipped bin was empty on the list."""
    from lightgbm_tpu_torch.ops import histogram
    HQ = histogram.leaf_histogram_i32
    n = binned.shape[0]
    gen = np.random.RandomState(13)
    rows = torch.from_numpy(gen.permutation(n)[:1000].astype(np.int32)
                            ).to(dev)
    bag = q.w01 * torch.from_numpy((gen.rand(n) >= 0.2).astype(np.float32)
                                   ).to(dev)

    def held(case, w01, sel=None, cnt=None, pl=plan):
        got = HQ(binned, q.codes, w01, nb, rows=sel, n_rows=cnt, plan=pl)
        check(torch.equal(got, HQ(binned, q.codes, w01, nb, rows=sel,
                                  n_rows=cnt, plan=pl)),
              "HQ %s %s: a second launch gave other bits" % (label, case))
        check(torch.equal(got, histogram.leaf_histogram_i32_plain(
            binned, q.codes, w01, nb, sel, cnt)),
              "HQ %s %s: not equal to its plain version" % (label, case))

    held("root", q.w01)
    held("1,000-row list", q.w01, rows, 1000)
    held("root, bagged", bag)
    held("1,000-row list, bagged", bag, rows, 1000)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    group_bins = None if binned.dtype == torch.uint8 else plan.widths
    emptied = 0
    for case, sel, cnt in (("list", rows, 1000), ("root", None, None)):
        rows_in = histogram.leaf_histogram_i32_plain(
            binned, q.codes, ones, nb, sel, cnt)[..., 2].cpu().numpy()
        skip = plan.skip.copy()
        for g, w in enumerate(plan.widths):
            none = np.flatnonzero(rows_in[g, :w] == 0)
            if len(none):
                skip[g] = none[0]
        changed = int(np.sum(skip != plan.skip))
        emptied = emptied or changed
        if changed:
            held("%s, %d skipped bins holding no row" % (case, changed),
                 q.w01, sel, cnt,
                 histogram.i32_plan(binned, nb, group_bins, skip=skip))
    check(emptied > 0, "HQ %s: no group had a bin without rows" % label)
    return emptied


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
    plan = gb8._grower.hq_plan
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
    # the round-1 gradients with a maximum whose two scales differ in the
    # last bit (max / qmax != max * f32(1 / qmax)), so that the checks
    # below tell the modes apart
    qm32 = np.float32(qmax)
    apart = np.float32(1.0)
    while apart / qm32 == apart * (np.float32(1.0) / qm32):
        apart = np.nextafter(apart, np.float32(2.0))
    g_apart = g1.clone()
    g_apart[0] = float(apart)
    cases["scales apart"] = (g_apart, h1, ones, keys[0], keys[1], False)
    # each case in both scale modes: a training iteration's (max *
    # f32(1 / qmax), GBDT._quantize's every round) and the gate's (max /
    # qmax); the training mode's codes go on to HQ below
    qs, held, scale_diff = {}, [], 0
    for label, (g, h, w, kg, kh, hc) in cases.items():
        modes = {}
        for recip, mode in ((True, "training"), (False, "gate")):
            got = histogram.quantize_gradients(
                g, h, w, qmax=qmax, key_g=kg, key_h=kh, hess_const=hc,
                reciprocal_scale=recip)
            again = histogram.quantize_gradients(
                g, h, w, qmax=qmax, key_g=kg, key_h=kh, hess_const=hc,
                reciprocal_scale=recip)
            plain = histogram.quantize_gradients_plain(
                g, h, w, qmax, kg, kh, hc, reciprocal_scale=recip)
            check(q_equal(got, again) and q_equal(got, plain),
                  "Q (%s, %s mode): codes, w01 or scale not bitwise equal to "
                  "its repeat and plain" % (label, mode))
            held.append("%s (%s)" % (label, mode))
            modes[mode] = got
        scale_diff += int((modes["training"].qscale[:2].view(torch.int32)
                           != modes["gate"].qscale[:2].view(torch.int32))
                          .sum())
        qs[label] = modes["training"]
    check(scale_diff > 0, "Q: no case held the two scale modes apart")
    # non-finite gradients: a NaN and an inf in gw and an inf in
    # hw; the scales propagate them as the plain version (and jnp.max /
    # jnp.maximum) do, and the codes are held where the plain version
    # defines them
    nonfin = {}
    bad = int(torch.nonzero(masks[0])[17])
    for label, (chan, val) in (("NaN gradient", (0, float("nan"))),
                               ("inf gradient", (0, float("inf"))),
                               ("inf hessian", (1, float("inf")))):
        gh = [g1.clone(), h1.clone()]
        gh[chan][bad] = val
        for recip, mode in ((True, "training"), (False, "gate")):
            for w, wl in ((ones, ""), (masks[0], ", bag mask")):
                args = (gh[0], gh[1], w)
                got = histogram.quantize_gradients(
                    *args, qmax=qmax, key_g=keys[0], key_h=keys[1],
                    reciprocal_scale=recip)
                again = histogram.quantize_gradients(
                    *args, qmax=qmax, key_g=keys[0], key_h=keys[1],
                    reciprocal_scale=recip)
                plain = histogram.quantize_gradients_plain(
                    *args, qmax, keys[0], keys[1], reciprocal_scale=recip)
                ok, out_g, out_h = q_held(got, plain, *args, False)
                check(q_equal(got, again) and ok,
                      "Q (%s, %s mode%s): not bitwise its repeat, or its "
                      "scales, w01 or defined codes not its plain version's"
                      % (label, mode, wl))
                nonfin["%s (%s%s)" % (label, mode, wl)] = (
                    got.qscale[:2].tolist(), out_g, out_h,
                    got.codes[bad].tolist(), plain.codes[bad].tolist())
    print("Q with non-finite rows [%d rows, row %d]: scales, w01 and the "
          "defined codes bitwise its plain version and its repeat; (scales, "
          "rows left out of the g / h codes, the bad row's codes kernel vs "
          "plain): %s" % (n, bad, "; ".join(
              "%s: %s" % kv for kv in nonfin.items())))
    # inputs that do not start on 16 bytes (gradients and hessians as the
    # rows of one [2, m] tensor, the weight a view one float in) at row
    # counts that are not multiples of 4: Q reads a row at a time there
    for m in (1, 3, 1001, n - 3):
        gh = torch.stack([g1[:m], h1[:m]])
        wb = torch.cat([ones[:1], masks[0][:m]])[1:]
        for hc in (False, True):
            for recip in (True, False):
                args = (gh[0], gh[1], wb)
                got, again = (histogram.quantize_gradients(
                    *args, qmax=qmax, key_g=keys[0], key_h=keys[1],
                    hess_const=hc, reciprocal_scale=recip)
                    for _ in range(2))
                plain = histogram.quantize_gradients_plain(
                    *args, qmax, keys[0], keys[1], hc,
                    reciprocal_scale=recip)
                check(q_equal(got, again) and q_equal(got, plain),
                      "Q (%d rows off 16 bytes, hess_const %s, reciprocal "
                      "%s): not bitwise its repeat and plain"
                      % (m, hc, recip))
    # the row-at-a-time reads against the 16-byte ones, at n - 3 rows
    off_ms, on_ms = (graph_ms(lambda a=a: histogram.quantize_gradients(
        *a, qmax=qmax, key_g=keys[0], key_h=keys[1],
        reciprocal_scale=True), calls=SHORT_CALLS) for a in (
            (gh[0], gh[1], wb), tuple(t.clone() for t in (gh[0], gh[1],
                                                          wb))))
    print("Q on inputs off 16 bytes [1, 3, 1001 and %d rows, bag mask]: "
          "bitwise its repeat and plain, both hessian and scale modes; "
          "%.5f ms at %d rows off 16 bytes against %.5f on 16 (CUDA graphs "
          "of %d calls)" % (n - 3, off_ms, n - 3, on_ms, SHORT_CALLS))
    # Q is one cooperative launch: a CUDA graph of one call holds one
    # kernel node and no memset
    q_nodes = graph_node_types(lambda: histogram.quantize_gradients(
        g1, h1, ones, qmax=qmax, key_g=keys[0], key_h=keys[1],
        reciprocal_scale=True))
    check(q_nodes == [0], "Q: a call's CUDA graph holds nodes %s, not one "
          "kernel" % q_nodes)
    print("Q: a call's CUDA graph holds one kernel node and no memset")
    print("Q [%d rows, qmax %d]: codes, w01 and scales bitwise its repeat "
          "and plain in %s; the two modes' scales differ in %d of %d words "
          "(max |g| %r in the scales-apart case)"
          % (n, qmax, ", ".join(held), scale_diff, 2 * len(cases),
             float(apart)))
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
        got = histogram.leaf_histogram_i32(binned, q.codes, q.w01, nb,
                                           plan=plan, **kw)
        again = histogram.leaf_histogram_i32(binned, q.codes, q.w01, nb,
                                             plan=plan, **kw)
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
            # the training mode, as GBDT._quantize runs every round
            q_card, q_same, q_own = (histogram.quantize_gradients(
                g, h, wt, qmax=gc._quant_qmax, key_g=kg, key_h=kh,
                reciprocal_scale=True) for g, h, wt in (
                    (g_c, h_c, w), (g_c.cpu(), h_c.cpu(), w.cpu()),
                    (g_h, h_h, w.cpu())))
            same = int((q_card.codes.cpu() != q_same.codes).sum())
            own = int((q_card.codes.cpu() != q_own.codes).sum())
            check(same == 0, "%s: Q on the card and on the CPU give %d "
                  "different codes from the same gradients" % (label, same))
            codes = ("; round-%d codes (training mode): card vs CPU from "
                     "the same gradients "
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
                g10, h10, ones, qmax=qmax, key_g=kg, key_h=kh,
                reciprocal_scale=True)),
            median_ms(lambda: histogram.quantize_gradients_plain(
                g10, h10, ones, qmax, kg, kh, reciprocal_scale=True),
                reps=5), q_bound, None),
        "leaf_histogram_i32": (
            graph_ms(lambda: histogram.leaf_histogram_i32(
                binned, q10.codes, q10.w01, nb, plan=plan)),
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
                                                 key_g=kg, key_h=kh,
                                                 reciprocal_scale=True),
            ("quantize_kernel",)),
        "leaf_histogram_i32": device_ms(
            lambda: histogram.leaf_histogram_i32(binned, q10.codes, q10.w01,
                                                 nb, plan=plan),
            ("hist_i32_kernel", "hist_i32_reduce_kernel", "Memset"))}
    for k, (ms, plain_ms, (b_ms, b_by), lib_ms) in times.items():
        print("time [%s | %s]: %s %.4f ms (%s; profiler device time %.4f "
              "ms), plain %.3f ms, bound %.5f ms (%s)%s"
              % (name, card, k, ms, "CUDA-graph replay"
                 if k == "leaf_histogram_i32" else "CUDA events around the "
                 "call", device[k], plain_ms, b_ms, b_by,
                 "" if lib_ms is None else
                 ", torch.bincount x3 %.4f ms" % lib_ms))
    list_dev = device_ms(lambda: histogram.leaf_histogram_i32(
        binned, q10.codes, q10.w01, nb, plan=plan, **rows_arg),
        ("hist_i32_kernel", "hist_i32_reduce_kernel", "Memset"))
    print("time [%s | %s]: leaf_histogram_i32 row list (%d of %d rows) "
          "%.4f ms (device time %.4f ms), plain %.3f ms, bound %.5f ms (%s)"
          % (name, card, cnt, n, median_ms(
              lambda: histogram.leaf_histogram_i32(
                  binned, q10.codes, q10.w01, nb, plan=plan, **rows_arg)),
             list_dev,
             median_ms(lambda: histogram.leaf_histogram_i32_plain(
                 binned, q10.codes, q10.w01, nb, **rows_arg), reps=5),
             *hq_list_bound))
    print("time [%s | %s]: rounds int8 %.4f s, int8 + bagging %.4f s, f32 "
          "(phase 12) %.4f s (medians of rounds 2-%d)"
          % (name, card, med8, med_bag, ctx["rounds_s"], TRAIN_ROUNDS))
    wall_us, busy, by_kind = profile_round(b8, name, card)
    hq_us = sum(v for k, v in by_kind.items() if "hist_i32" in k)
    q_us = sum(v for k, v in by_kind.items() if "quantize_kernel" in k)
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


def ls_systems(k, leaves, seed, dev, edges=False):
    """Seeded LS inputs built directly (no LF, no training): each leaf's
    normal equations of 3d rows (f32), b, cnt, features (a fifth of the
    leaves with their upper slots padded) and constants. `edges` puts
    the odd leaves in the first ten: a pivot column with two rows of
    equal |a| (and of opposite signs), a NaN and an inf entry in A, an
    all-zero slope row and column, two NaN in a pivot column, a NaN in
    b, an under-populated and a padded leaf."""
    rs = np.random.RandomState(seed)
    d = k + 1
    n = 3 * d
    z = rs.randn(leaves, n, d).astype(np.float32)
    z[:, :, k] = 1.0
    h = (rs.rand(leaves, n) + 0.5).astype(np.float32)
    a = np.einsum("lni,lnj->lij", z * h[:, :, None], z).astype(np.float32)
    b = np.einsum("lni,ln->li", z, rs.randn(leaves, n)).astype(np.float32)
    cnt = np.full(leaves, float(n), np.float32)
    feats = rs.randint(0, 70, (leaves, k)).astype(np.int32)
    feats[1::5, k // 2 + 1:] = -1
    const = rs.randn(leaves).astype(np.float32)
    if edges:
        top = float(np.abs(a).max()) * 4
        a[0, 1, 0] = a[0, 2, 0] = top
        a[1, 1, 0], a[1, 2, 0] = -top, top
        a[2, 1, 1] = np.nan
        a[3, 0, 0] = np.inf
        a[4, 2, :] = 0.0
        a[4, :, 2] = 0.0
        a[5, 0, 0] = a[5, 2, 0] = np.nan
        b[6, 1] = np.nan
        cnt[7] = float(2 * d - 1)
        feats[8, :] = -1
    return tuple(torch.from_numpy(v).to(dev)
                 for v in (a, b, cnt, feats, const))


def hold_ls(label, args, lam):
    """LS bitwise its plain version (value, coeff) and equal in fitted,
    and the same bits over two launches; returns the plain outputs."""
    from lightgbm_tpu_torch.ops import linear as lin
    got = [lin.linear_solve(*args, lam) for _ in range(2)]
    ref = lin.linear_solve_plain(*args, lam)
    for g in got:
        check(bitwise(g[0], ref[0]) and bitwise(g[1], ref[1])
              and g[2].dtype == torch.bool and torch.equal(g[2], ref[2]),
              "LS (%s): not bitwise its plain version or its repeat (max "
              "diff %g, fitted %d vs %d)" % (
                  label, max(float((g[i] - ref[i]).abs().nan_to_num(
                      float("inf")).max()) for i in (0, 1)),
                  int(g[2].sum()), int(ref[2].sum())))
    return ref


def ls_cases(dev):
    """Phase 18's seeded LS systems: the A/B's widths (the register
    mode's largest k and the next, 255 leaves at k 16, 4 at k 120, past
    48 KB of shared memory), 2 leaves at k 250 (the system in a global
    scratch), and the edge cases in both modes at linear_lambda 0.01 and
    0; each held by hold_ls. Returns the cases' labels."""
    from lightgbm_tpu_torch.ops import linear as lin
    (top, _), (nxt, _) = LS_AB_WIDTHS[:2]
    check(lin.solve_plan(top)["mode"] == "regs"
          and lin.solve_plan(nxt)["mode"] == "block",
          "LS_AB_WIDTHS do not straddle LS's mode boundary")
    labels = []
    for k, leaves in LS_AB_WIDTHS + ((250, 2),):
        label = "k %d, %d leaves, %s mode" % (k, leaves,
                                              lin.solve_plan(k)["mode"])
        hold_ls(label, ls_systems(k, leaves, k, dev, edges=leaves > 8),
                0.01)
        labels.append(label)
    for k in (5, 16):
        for lam in (0.01, 0.0):
            label = "edge cases, k %d, linear_lambda %g" % (k, lam)
            ref = hold_ls(label, ls_systems(k, 64, 100 + k, dev, True), lam)
            fitted = ref[2][:9].tolist()
            check(fitted == [True, True, False, True, lam > 0, False, False,
                             False, True],
                  "LS (%s): fitted flags %s" % (label, fitted))
            labels.append(label)
    return labels


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
    their terms' absolute values, in f64 on the card; a bin past
    num_bins adds nothing."""
    from lightgbm_tpu_torch.ops.histogram import take_bins
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
    bins = take_bins(binned, sel)
    keep = (bins < num_bins).reshape(-1)
    flat = ((slot[:, None] * f_cnt
             + torch.arange(f_cnt, device=binned.device)[None]) * num_bins
            + bins).reshape(-1)[keep]
    terms = terms.reshape(-1, 4)[keep]
    out = []
    for t in (terms, terms.abs()):
        acc = torch.zeros((c_cnt * f_cnt * num_bins, 4), dtype=torch.float64,
                          device=binned.device)
        out.append(acc.index_add_(0, flat, t).view(
            c_cnt, f_cnt, num_bins, 4))
    return out


def hold_lm(label, args):
    """LM on args (binned, x, w3, num_bins, leaf_id, ids): its repeat and
    ops/histogram.leaf_moments_order (the replay of its summation order)
    bit for bit, leaf_moments_plain and the f64 oracle within 1e-5 *
    max(1, sum of the terms' |values|). Returns (LM, the max abs error
    against plain)."""
    from lightgbm_tpu_torch.ops import histogram
    got = histogram.leaf_moments(*args)
    check(torch.equal(got, histogram.leaf_moments(*args)),
          "LM (%s): a second launch gave other bits" % label)
    check(torch.equal(got, histogram.leaf_moments_order(*args)),
          "LM (%s): not bitwise the replay of its summation order" % label)
    ref, scale = moment_oracle(*args)
    err = within(got, histogram.leaf_moments_plain(*args), scale,
                 "LM (%s) vs plain" % label)
    within(got, ref, scale, "LM (%s) vs f64 oracle" % label)
    return got, err


def lm_cases(dev, num_bins, seed):
    """LM's seeded cases at 65,536 rows x 70 features (the k = 64 check's
    size; F past 32 takes three slices): uint8 bins below 256, else
    uint16, a few past num_bins; NaN and -inf values; 16 leaf ids in
    shuffled order, the last holding no row, and rows of no id; one id
    over a constant leaf_id; 3,000 ids (the last holding no row) over 8
    of the features. {label: args}."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = num_bins > 256
    bins = torch.randint(0, num_bins, (WIDE_ROWS, 70), device=dev,
                         generator=gen, dtype=torch.int32)
    bins[::97, 5] = num_bins + 1 if wide else 0
    bins = bins.to(torch.int16).view(torch.uint16) if wide \
        else bins.to(torch.uint8)
    x = torch.randn((WIDE_ROWS, 70), device=dev, generator=gen)
    x[::53, 3] = float("nan")
    x[7::89, 40] = float("-inf")
    m = (torch.rand(WIDE_ROWS, device=dev, generator=gen) < 0.9).float()
    w = torch.stack([torch.randn(WIDE_ROWS, device=dev, generator=gen) * m,
                     (torch.rand(WIDE_ROWS, device=dev, generator=gen)
                      + 0.1) * m, m], 1).contiguous()
    ids = (torch.randperm(16, device=dev, generator=gen) * 3 + 1).to(
        torch.int32)
    lid = ids[torch.randint(0, 15, (WIDE_ROWS,), device=dev, generator=gen)]
    lid[::41] = -7
    # more ids than the sort counts in shared memory (kSortSlots), on 8
    # of the features: the sort's counters stay in device memory
    many = torch.randperm(3000, device=dev, generator=gen).to(torch.int32)
    return {"%d x 70, 16 ids" % WIDE_ROWS: (bins, x, w, num_bins, lid, ids),
            "one id over all rows": (
                bins, x, w, num_bins,
                torch.full((WIDE_ROWS,), 3, dtype=torch.int32, device=dev),
                torch.tensor([3], dtype=torch.int32, device=dev)),
            "3,000 ids over 8 features": (
                bins[:, :8].contiguous(), x[:, :8].contiguous(), w,
                num_bins, many[torch.randint(0, 2999, (WIDE_ROWS,),
                                             device=dev, generator=gen)],
                many)}


def lm_timing(args):
    """LM's times on args (binned, x, w3, num_bins, leaf_id, ids) as
    leaf_feature_moments calls it: `device` (a CUDA graph of the call's
    LM, leaf_moments_ids), `call` (CUDA events around
    leaf_feature_moments) and `call_graph`, `host_us` (a call's host
    time on the first LM_HOST_ROWS rows), the `plain`
    version, the `bound`, and the yardsticks: `index_add` (one
    index_add_ of the [rows x F, 4] terms into [(ids + 1) x F x B, 4],
    rows of no id into the spare id) and `bincount4` (torch.bincount
    x4)."""
    from lightgbm_tpu_torch.linear import leaf_feature_moments
    from lightgbm_tpu_torch.ops import histogram
    lb, raw, w3, width, lid, ids = args
    ids_l = ids.tolist()
    rows, f_cnt = lb.shape
    c_cnt = len(ids_l)
    dev = lb.device
    out = {"bound": bound(rows * (f_cnt * (lb.element_size() + 4) + 12 + 4)
                          + c_cnt * f_cnt * width * 16,
                          8.0 * rows * f_cnt)}
    match = lid.long()[:, None] == ids.long()[None, :]
    slot = torch.where(match.any(1), match.int().argmax(1),
                       torch.full_like(lid.long(), c_cnt))
    del match
    flat = ((slot[:, None] * f_cnt + torch.arange(f_cnt, device=dev))
            * width + histogram.take_bins(lb)).reshape(-1)
    xv = torch.where(torch.isfinite(raw), raw, torch.zeros_like(raw))
    terms = [(xv * w3[:, 2:3]).reshape(-1), (xv * xv * w3[:, 2:3]).reshape(-1),
             (xv * w3[:, 0:1]).reshape(-1), (xv * w3[:, 1:2]).reshape(-1)]
    del xv, slot
    src4 = torch.stack(terms, 1)
    acc = torch.zeros(((c_cnt + 1) * f_cnt * width, 4), dtype=torch.float32,
                      device=dev)
    out["index_add"] = median_ms(lambda: acc.index_add_(0, flat, src4),
                                 reps=5)
    del src4, acc

    def library():
        for t in terms:
            torch.bincount(flat, weights=t,
                           minlength=(c_cnt + 1) * f_cnt * width)
    out["bincount4"] = median_ms(library, reps=3)
    del terms, flat

    def call():
        return leaf_feature_moments(lb, raw, w3, lid, ids_l, width)
    out["device"] = graph_ms(
        lambda: histogram.leaf_moments_ids(lb, raw, w3, width, lid, ids_l))
    out["call"] = median_ms(call)
    out["call_graph"] = graph_ms(call)
    # the host time on the first 1,000 rows, where the device keeps up
    small = [t[:LM_HOST_ROWS].contiguous() for t in (lb, raw, w3, lid)]
    out["host_us"] = host_us(lambda: leaf_feature_moments(
        small[0], small[1], small[2], small[3], ids_l, width))
    out["plain"] = median_ms(lambda: histogram.leaf_moments_plain(*args),
                             reps=3)
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
    check(bitwise(a_k, a_r) and bitwise(b_k, b_r) and bitwise(c_k, c_r),
          "LF: a second launch gave other bits")
    order = lin.linear_normal_eq_order(*lf_args)
    check(all(bitwise(u, v) for u, v in zip((a_k, b_k, c_k), order)),
          "LF: not bitwise its order replay (max diff %g)" % max(
              float((u - v).abs().max()) for u, v in zip((a_k, b_k, c_k),
                                                         order)))
    del order
    check(torch.equal(c_k, c_p) and torch.equal(c_k.double(), c64),
          "LF: counts differ from the plain version or the oracle")
    errs["linear_normal_eq"] = max(
        within(a_k, a_p, a_abs, "LF A vs plain"),
        within(b_k, b_p, b_abs, "LF b vs plain"))
    within(a_k, a64, a_abs, "LF A vs f64 oracle")
    within(b_k, b64, b_abs, "LF b vs f64 oracle")
    const = torch.from_numpy(st.leaf_value).to(dev)
    lam = LINEAR_PARAMS["linear_lambda"]
    # LS bitwise its plain version on the main path's first tree, and on
    # singular (a slope column equal to the intercept's), under-populated
    # and padded-slot leaves at linear_lambda 0
    ls = [lin.linear_solve(a_k, b_k, c_k, feats, const, lam)]
    hold_ls("the main path's first tree", (a_k, b_k, c_k, feats, const), lam)
    a_s, c_s, f_s = a_k.clone(), c_k.clone(), feats.clone()
    a_s[0, 0, :] = a_s[0, k, :]
    a_s[0, :, 0] = a_s[0, :, k]
    c_s[1] = 5.0
    f_s[2, 3:] = -1
    odd = hold_ls("singular, under-populated and padded leaves",
                  (a_s, b_k, c_s, f_s, const), 0.0)
    check(not bool(odd[2][0]) and not bool(odd[2][1]) and bool(odd[2][2]),
          "LS: singular / under-populated / padded leaves: fitted %s"
          % odd[2][:3].tolist())
    check(bool((odd[1][2, 3:] == 0).all()), "LS: a padded slot got a "
          "coefficient")
    errs["linear_solve"] = 0.0
    # both modes on seeded systems; one CUDA graph node a call
    lin.linear_solve.launches = lin.linear_solve.launches_block = 0
    ls_labels = ls_cases(dev)
    ls_modes = (lin.linear_solve.launches - lin.linear_solve.launches_block,
                lin.linear_solve.launches_block)
    check(min(ls_modes) > 0, "LS: a mode never launched (register %d, "
          "block %d)" % ls_modes)
    for kk, args in ((k, (a_k, b_k, c_k, feats, const)),
                     (64, ls_systems(64, 16, 64, dev))):
        nodes = graph_node_types(lambda: lin.linear_solve(*args, lam))
        check(nodes == [0], "LS at k %d: a call's CUDA graph holds nodes %s, "
              "not one kernel" % (kk, nodes))
    print("LS bitwise its plain version and its repeat, value, coeff and "
          "fitted, on the main path's first tree, its odd leaves and: %s; "
          "register mode %d launches, block mode %d; one kernel node a "
          "call at k %d and k 64" % ("; ".join(ls_labels), ls_modes[0],
                                     ls_modes[1], k))
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
    check(all(bitwise(p1, p2) for p1, p2 in zip(wide[0], wide[1])),
          "LF k=64: a second launch gave other bits")
    check(all(bitwise(p1, p2) for p1, p2 in zip(
        wide[0], lin.linear_normal_eq_order(*lf64))),
        "LF k=64: not bitwise its order replay")
    check(torch.equal(wide[0][2], wide[2][2]), "LF k=64: counts differ")
    errs["linear_normal_eq"] = max(
        errs["linear_normal_eq"],
        within(wide[0][0], wide[2][0], wa_abs, "LF k=64 A vs plain"),
        within(wide[0][1], wide[2][1], wb_abs, "LF k=64 b vs plain"))
    within(wide[0][0], wa64, wa_abs, "LF k=64 A vs feats64 oracle")
    within(wide[0][1], wb64, wb_abs, "LF k=64 b vs feats64 oracle")
    c64k = torch.zeros(16, device=dev)
    ls64 = hold_ls("k 64 on LF's sums", (*wide[0], feats64, c64k), lam)
    check(bool(ls64[2].all()), "LS k=64: a leaf was not fitted")
    print("LF/LS at k=64 (%d rows x 70 columns, 16 leaves): equal to the "
          "plain versions as stated (LS bitwise), LF bitwise its order "
          "replay, repeat equal" % WIDE_ROWS)
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
              "device (CUDA-graph replay of %d calls; CUDA events around the "
              "call %.4f ms), plain %.3f ms, bound %.5f ms (%s)"
              % (name, card, kname, WIDE_ROWS, graph_ms(
                  kernel, calls=SHORT_CALLS), SHORT_CALLS, median_ms(kernel),
                 median_ms(plain_fn, reps=5), b_ms, b_by))
    eye64 = torch.eye(d64, device=dev)
    a_lib64 = torch.where((wide[0][2] >= 2.0 * d64)[:, None, None],
                          wide[0][0] + eye64 * lam, eye64)
    print("time [%s | %s]: torch.linalg.solve_ex on the same k=64 systems "
          "%.4f ms (CUDA events around the call)" % (name, card, median_ms(
              lambda: torch.linalg.solve_ex(a_lib64, -wide[0][1]), reps=5)))
    del a_lib64
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
    errs["forest_value_walk_linear"] = hold_k1(
        "linear forest", predict.forest_value_walk, forest, xvd,
        predict.forest_value_walk_plain(forest, xvd), predict)
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
        got, err = hold_lm(label, (binned, raw_x, w, nb, lid, ids))
        lm_err = max(lm_err, err)
        if label.startswith("main path"):
            check(torch.equal(moments, got.sum(dim=2)),
                  "leaf_feature_moments is not LM summed over bins")
            ref, scale = moment_oracle(binned, raw_x, w, nb, lid, ids)
            within(moments, ref.sum(dim=2), scale.sum(dim=2),
                   "leaf_feature_moments vs f64 oracle")
            del ref, scale
    for label, args in lm_cases(dev, nb, 18).items():
        case, err = hold_lm(label, args)
        lm_err = max(lm_err, err)
        check(args[5].shape[0] == 1 or not bool(case[-1].any()),
              "LM (%s): the id of no rows is not 0" % label)
        del case
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
          "%.3g (counts exact), LS bitwise (singular, under-populated "
          "and padded leaves fall back or pin as plain), LA bitwise with "
          "NaN/inf rows, K1 linear bitwise at 1 to %d rows, W leaf mode equal, "
          "LM's four channels within %.3g on the main path's call (%d leaf "
          "ids), on the first tree's leaves and on %d x 70 seeded rows (16 "
          "ids, one of no rows; one id over all rows), bitwise its replay, "
          "leaf_feature_moments its sum over bins, equal to LF's b; every "
          "kernel repeated its bits"
          % (TRAIN_ROWS, st.num_leaves_used, k, errs["linear_normal_eq"],
             VALID_ROWS, lm_err, len(lm_ids), WIDE_ROWS))

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
    times["linear_normal_eq"] = (
        graph_ms(lambda: lin.linear_normal_eq(*lf_args)),
        median_ms(lambda: lin.linear_normal_eq(*lf_args)),
        median_ms(lambda: lin.linear_normal_eq_plain(*lf_args), reps=5),
        bound(n * (16 + 4 * k) + leaves * (d * d + d + 1) * 4,
              n * entries * 3.0), median_ms(lf_library, reps=5))
    del zz

    def lf_new_segments():
        # a tree's call: its segments are not among the cached ones
        lin._segment_cache.clear()
        lin.linear_normal_eq(*lf_args)
    print("time [%s | %s]: linear_normal_eq host time %.1f us a call (%.1f "
          "us with its segments cached)"
          % (name, card, host_us(lf_new_segments),
             host_us(lambda: lin.linear_normal_eq(*lf_args))))
    ls_args = (a_k, b_k, c_k, feats, const, lam)
    eye = torch.eye(d, device=dev)
    a_lib = torch.where((c_k >= 2.0 * d)[:, None, None], a_k + eye * lam,
                        eye)
    times["linear_solve"] = (
        graph_ms(lambda: lin.linear_solve(*ls_args), calls=SHORT_CALLS),
        median_ms(lambda: lin.linear_solve(*ls_args)),
        median_ms(lambda: lin.linear_solve_plain(*ls_args), reps=5),
        bound(a_k.numel() * 4 + b_k.numel() * 8,
              leaves * d ** 3 / 3.0 * 2),
        median_ms(lambda: torch.linalg.solve_ex(a_lib, -b_k), reps=5))
    print("time [%s | %s]: an empty kernel (torch.cuda._sleep(0), one "
          "thread) %.5f ms a call in a CUDA graph of %d calls: the floor "
          "under LS's %d leaves at k %d" % (name, card, graph_ms(
              lambda: torch.cuda._sleep(0), calls=SHORT_CALLS), SHORT_CALLS,
              leaves, k))
    sc = gb._score[0].clone()
    la_args = (raw_x, st.leaf_id, value, coeff, feats, sc, 0.1)
    # LA on the main path's first tree as the trainer calls it, 12 + 4k
    # bytes a row its bound
    times["linear_addend"] = (
        graph_ms(lambda: lin.linear_addend(*la_args), calls=SHORT_CALLS),
        median_ms(lambda: lin.linear_addend(*la_args)),
        median_ms(lambda: lin.linear_addend_plain(*la_args), reps=5),
        bound(n * (12 + 4 * k), n * (3.0 * k + 4)), None)
    # LM as the main path calls it: leaf_feature_moments over the last
    # tree's leaf ids; a row's F bins and F values, 12 bytes of channels
    # and its leaf id, and the [C, F, B, 4] output
    lm_t = lm_timing((binned, raw_x, w_l, nb, leaf_of, torch.tensor(
        lm_ids, dtype=torch.int32, device=dev)))
    times["leaf_moments"] = (lm_t["device"], lm_t["call"], lm_t["plain"],
                             lm_t["bound"], lm_t["index_add"])
    print("time [%s | %s]: leaf_moments (%d ids over %d x %d, B %d): device "
          "%.4f ms (CUDA graph), leaf_feature_moments %.4f ms (CUDA events; "
          "graph %.4f ms), host %.1f us a call, bound %.5f ms, one "
          "index_add_ %.4f ms, torch.bincount x4 %.4f ms, plain %.3f ms"
          % (name, card, len(lm_ids), n, nf, nb, lm_t["device"],
             lm_t["call"], lm_t["call_graph"], lm_t["host_us"],
             lm_t["bound"][0], lm_t["index_add"], lm_t["bincount4"],
             lm_t["plain"]))
    # K1 on the linear forest: node visits, and k loads and multiply-adds
    # a (row, tree)
    leaf = predict.forest_leaf_walk_plain(forest, xvd)
    depth = torch.from_numpy(leaf_depths(booster._inner.models)).to(dev)
    visits = int(depth.gather(1, leaf.t().long()).sum())
    walk_ops = visits * INSTR_PER_VISIT + VALID_ROWS * TRAIN_ROUNDS * k * 4
    times["forest_value_walk_linear"] = (
        graph_ms(lambda: predict.forest_value_walk(forest, xvd)),
        median_ms(lambda: predict.forest_value_walk(forest, xvd)),
        median_ms(lambda: predict.forest_value_walk_plain(forest, xvd),
                  reps=5),
        bound(xvd.numel() * 4 + VALID_ROWS * 4 + forest.nbytes(), walk_ops),
        None)
    vleaf = predict.tree_leaf_binned_plain(bt, vb)
    dep0 = torch.from_numpy(leaf_depths(booster._inner.models[:1])[0]).to(dev)
    v0 = int(dep0[vleaf].sum())
    times["tree_leaf_walk_binned"] = (
        graph_ms(lambda: predict.tree_leaf_walk_binned(bt, vb),
                 calls=SHORT_CALLS),
        median_ms(lambda: predict.tree_leaf_walk_binned(bt, vb)),
        median_ms(lambda: predict.tree_leaf_walk_binned_plain(bt, vb),
                  reps=5),
        bound(v0 + 4 * VALID_ROWS + tree_bytes(bt),
              v0 * INSTR_PER_VISIT), None)
    main = dict(launches, forest_value_walk_linear=k1_launches,
                leaf_moments=lm_launches)
    for kk, (dev_ms, ev_ms, plain_ms, (b_ms, b_by), lib_ms) in times.items():
        print("time [%s | %s]: %s %.4f ms (CUDA events around the call; "
              "device time %s, LF's, LS's and LA's by CUDA-graph replay), "
              "plain "
              "%.3f ms, bound %.5f ms (%s), library "
              "%s, %s launches on the main path"
              % (name, card, kk, ev_ms, "not measured" if dev_ms is None
                 else "%.4f ms" % dev_ms, plain_ms, b_ms, b_by,
                 "none" if lib_ms is None else "%.4f ms" % lib_ms,
                 main.get(kk)))
    print("time [%s | %s]: rounds linear %.4f s, linear int8 %.4f s, linear "
          "int8 + bagging %.4f s, constant f32 (phase 12) %.4f s (medians of "
          "rounds 2-%d)" % (name, card, med, med8, med_bag, ctx["rounds_s"],
                            TRAIN_ROUNDS))
    wall_us, busy, by_kind = profile_round(booster, name, card)
    lin_us = {kk: sum(v for n_, v in by_kind.items() if kk in n_)
              for kk in ("normal_eq", "solve_", "addend_kernel")}
    print("where the time goes [%s | %s]: linear round: LF %.3f ms, LS %.3f "
          "ms, LA %.3f ms of %.3f ms device busy, idle share %.3f"
          % (name, card, lin_us["normal_eq"] / 1e3,
             lin_us["solve_"] / 1e3, lin_us["addend_kernel"] / 1e3,
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


def check_rank_kernel(obj, score, label, sample, weights=None):
    """Phase 6 on one layout and score: L twice (same bits) on the
    objective's plan, bit for bit its order replay
    (lambdarank_grads_order), against its plain version and the f64
    oracle on the card, then the queries of `sample` against the f64
    oracle on the host; with `weights`, the oracle's sums times them.
    Returns L's max abs error against the plain version."""
    from lightgbm_tpu_torch.ops import rank
    args = (score, obj.query_boundaries, obj.label_int, obj.gain,
            obj.inv_max_dcg, obj.sigmoid, weights)
    got = rank.lambdarank_grads(*args, plan=obj.plan)
    again = rank.lambdarank_grads(*args, plan=obj.plan)
    check(all(bitwise(a, b) for a, b in zip(got, again)),
          label + ": a second launch of L gave other bits")
    order = rank.lambdarank_grads_order(*args)
    check(all(bitwise(a, b) for a, b in zip(got, order)),
          label + ": L is not bitwise its order replay (max diff %g)"
          % max(float((a - b).abs().max()) for a, b in zip(got, order)))
    plain = rank.lambdarank_grads_plain(*args)
    oracle = rank_oracle(*args[:6])
    if weights is not None:
        oracle = oracle * weights.double()[None]
        oracle[2:] = oracle[2:].abs()
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
    if weights is not None:
        host = host * weights[docs].cpu().double()[None]
        host[2:] = host[2:].abs()
    rank_err([t[docs].cpu() for t in got], host[:2], host[2:],
             label + " (L vs the host f64 oracle, %d queries of %s docs)"
             % (len(sample), sorted(set(sizes.tolist()))))
    return err


def ranking(name, card, dev):
    """Phases 5-8; returns L's JSON row."""
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
    # quantized lambdarank on a doc count that is not a multiple of 4:
    # L's gradients come as the rows of one [2, n] tensor, so the
    # hessian does not start on 16 bytes and Q reads a row at a time
    sizes = [int(v) for v in gt[:500]]
    sizes[-1] -= 3
    nq8 = sum(sizes)
    q8 = dict(RANK_PARAMS, tpu_hist_quantize="int8")
    before = histogram.quantize_gradients.launches
    qb = lgb.train(dict(q8), lgb.Dataset(xt[:nq8], yt[:nq8], group=sizes,
                                         params=dict(q8)), 3,
                   verbose_eval=False)
    q_launches = histogram.quantize_gradients.launches - before
    check(q_launches >= 3, "quantized lambdarank: Q launched %d times in 3 "
          "rounds" % q_launches)
    lg, lh = qb._inner.objective.get_gradients(qb._inner._score[0])
    check(lh.data_ptr() % 16 != 0, "quantized lambdarank: the hessian "
          "starts on 16 bytes, the case is not held")
    q_ones = torch.ones(nq8, device=dev)
    for hc in (False, True):
        for recip in (True, False):
            got, again = (histogram.quantize_gradients(
                lg, lh, q_ones, qmax=127, key_g=(0, 1), key_h=(0, 2),
                hess_const=hc, reciprocal_scale=recip) for _ in range(2))
            plain = histogram.quantize_gradients_plain(
                lg, lh, q_ones, 127, (0, 1), (0, 2), hc,
                reciprocal_scale=recip)
            check(q_equal(got, again) and q_equal(got, plain),
                  "Q on lambdarank's gradients (%d docs, hess_const %s, "
                  "reciprocal %s): not bitwise its repeat and plain"
                  % (nq8, hc, recip))
    check(qb.num_trees() == 3 and bool(torch.isfinite(
        qb._inner._score[0]).all()), "quantized lambdarank: %d trees, or "
          "a score not finite" % qb.num_trees())
    print("ranking, int8: %d docs (not a multiple of 4), 3 rounds on the "
          "card, Q launched %d times; Q on its gradients (the hessian %d "
          "bytes past 16) bitwise its repeat and plain, both hessian and "
          "scale modes" % (nq8, q_launches, lh.data_ptr() % 16))

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
    row_w = torch.rand(n, generator=gen, device=dev) * 2.5 + 0.25
    errs.append(check_rank_kernel(obj, scores["seeded"],
                                  "L protocol, seeded scores, row weights",
                                  proto_sample, row_w))
    sizes, labels = mslr_like_groups(0)
    mslr = rank_layout(sizes, labels, dev)
    n_mslr = int(sizes.sum())
    mslr_score = torch.randn(n_mslr, generator=gen, device=dev)
    mslr_sample = np.array([0, 1, 4, 5] + list(np.random.RandomState(
        0).choice(np.arange(8, len(sizes)), 4, replace=False)))
    errs.append(check_rank_kernel(mslr, mslr_score, "L MSLR-shaped",
                                  mslr_sample))
    cap = rank.SORT_CAP
    long_sizes = np.array([cap + 1000, 7, cap + 1])
    long_labels = np.random.RandomState(1).randint(0, 5, long_sizes.sum())
    long = rank_layout(long_sizes, long_labels, dev)
    errs.append(check_rank_kernel(
        long, torch.randn(int(long_sizes.sum()), generator=gen, device=dev),
        "L above the %d-doc stage cap" % cap, np.arange(3)))
    print("L vs plain [protocol %d x %d at zero, seeded and trained scores "
          "and seeded scores with row weights; MSLR-shaped %d queries, %d "
          "docs, up to %d a query; queries of %s docs above the stage cap]: "
          "bitwise its order replay, grad and hess within 1e-5 * max(1, A) "
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
        times[label] = (graph_ms(lambda: rank.lambdarank_grads(
            *args, plan=o.plan)),
            median_ms(lambda: rank.lambdarank_grads_plain(*args), reps=reps),
            b_ms, b_by, median_ms(lambda: rank.lambdarank_grads(
                *args, plan=o.plan)))
        print("time [%s | %s]: lambdarank_grads %s (%d docs, %d queries) "
              "%.4f ms device (CUDA-graph replay; CUDA events around the "
              "call %.4f ms), plain %.3f ms, bound %.5f ms (%s)"
              % (name, card, label, score.shape[0], o.inv_max_dcg.shape[0],
                 times[label][0], times[label][4], *times[label][1:4]))
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
    listed = sum(v for k, v in by_kind.items() if "rank_" in k)
    busy_all = busy + (0.0 if listed else l_us)
    print("where the time goes [%s | %s]: lambdarank_grads %.3f ms of the "
          "round (CUDA events around its call; the profiler %s), share %.3f "
          "of %.2f ms device busy, idle share %.3f"
          % (name, card, l_us / 1e3, "listed %.3f ms" % (listed / 1e3)
             if listed else "did not list it", l_us / busy_all,
             busy_all / 1e3, 1.0 - busy_all / wall_us))
    ms, plain_ms, b_ms, b_by = times["protocol"][:4]
    return {"name": "lambdarank_grads", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/lambdarank.cu",
            "replaces": "lightgbm_tpu/objectives.py:438",
            "launches": launches["lambdarank_grads"],
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# the serving extras (phases 21-24)
ES_FREQ = 10              # pred_early_stop_freq of the main path
# the A/B's ES rows-mode variants: (iterations a round, rows its
# trees-mode tail takes on; 0: none, and 500 iterations: one round)
ES_VARIANTS = ((500, 0), (40, 0), (20, 32_768), (40, 32_768),
               (80, 32_768), (40, 65_536), (80, 65_536))
CONTRIB_ROWS, FILE_ROWS = 2_048, 4_096
CONT_ROUNDS, CONT_CPU_ROUNDS = 10, 3
OUT_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
# QC's least work a cell: load, NaN and flush tests, the missing test,
# and per binary-search step a load, a flush, a compare and an add
INSTR_PER_CODE, INSTR_PER_STEP = 10, 4


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
    """ES against its plain version, bitwise in its sums and `iters`, at
    each margin and freq, on the first n rows of x for each k1_counts n
    (both modes), launched twice repeating its bits; returns {(margin,
    freq): iters} of the kernel on all of x."""
    out = {}
    counts = k1_counts(P, x.shape[0])
    if counts[-1] != x.shape[0]:
        counts.append(x.shape[0])
    for m in margins:
        for freq in freqs:
            ref, it_p = P.forest_early_stop_walk_plain(stack, x, m, freq)
            for n in counts:
                xn = x[:n].contiguous()
                got, it = P.forest_early_stop_walk(stack, xn, m, freq,
                                                   return_iters=True)
                again, it2 = P.forest_early_stop_walk(stack, xn, m, freq,
                                                      return_iters=True)
                check(bitwise(got, ref[:, :n]) and torch.equal(it, it_p[:n]),
                      "ES [%s, margin %g, freq %d, %d rows] not bitwise "
                      "equal to plain" % (label, m, freq, n))
                check(bitwise(got, again) and torch.equal(it, it2),
                      "ES [%s, %d rows]: a second launch gave other bits"
                      % (label, n))
                errs["forest_early_stop_walk"] = max(
                    errs["forest_early_stop_walk"],
                    float((got - ref[:, :n]).abs().max()))
            out[(m, freq)] = it
    modes = ["%d (%s)" % (n, P.walk_plan(
        stack.num_trees, stack.split_feature.shape[1], stack.num_features, n,
        stack.linear_k > 0, output="early_stop",
        classes=stack.num_classes).mode) for n in counts]
    print("ES [%s]: bitwise equal to plain (sums and iters) and its repeat "
          "at %s rows" % (label, ", ".join(modes)))
    return out


def qc_edge_cases(P, qf, dev):
    """QC bitwise its plain version on hand-made grids and rows: bounds
    and values that are subnormal, +-0, +-inf (values NaN too), values
    equal to a bound and its neighbours, values at the zero threshold,
    each missing-type mix (none, NaN, zero, both) a feature, columns past
    the grid, grids of 1 and of 255 bounds, 64 features of 255 bounds
    (the grid searched in device memory, past the shared budget), N x F
    not a multiple of 4, and views 4 and 8 bytes off 16-byte alignment.
    Returns the number of (grid, rows) cases held."""
    import dataclasses
    rng = np.random.RandomState(21)
    nf = qf.walk.num_features + 2
    cases = 0
    for feats, k, n in ((FEATURES, 1, 1001), (FEATURES, 255, 777),
                        (64, 255, 999), (3, 7, 5), (FEATURES, 237, 4097)):
        grid = rng.randn(feats, k).astype(np.float32)
        special = np.array([1e-40, -1e-40, 0.0, -0.0, 1e-36, 5e-36],
                           np.float32)
        grid.flat[rng.choice(grid.size, min(grid.size, 2 * feats),
                             replace=False)] = rng.choice(special,
                                                          2 * feats)
        grid[rng.rand(feats, k) < 0.2] = np.inf
        grid = np.sort(grid, 1)
        cols = max(nf, feats + 2)
        x = rng.randn(n + 8, cols).astype(np.float32)
        # a bound of the cell's feature, or its neighbours, in a third
        f_of = np.minimum(np.arange(cols), feats - 1)
        at = grid[f_of[None, :], rng.randint(0, k, x.shape)]
        pick = rng.rand(*x.shape)
        x = np.where(pick < 0.2, at, x)
        x = np.where((pick >= 0.2) & (pick < 0.27),
                     np.nextafter(at, np.float32(np.inf)), x)
        x = np.where((pick >= 0.27) & (pick < 0.33),
                     np.nextafter(at, np.float32(-np.inf)), x)
        odd = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40,
                        -1e-40, 1e-35, -1e-35, 1.1e-35, 1e-36],
                       np.float32)
        x = np.where(rng.rand(*x.shape) < 0.15,
                     rng.choice(odd, x.shape), x).astype(np.float32)
        for miss in (None, rng.randint(0, 4, feats).astype(np.uint8)):
            q = dataclasses.replace(
                qf, grid=torch.from_numpy(grid).to(dev),
                miss=None if miss is None else torch.from_numpy(miss).to(
                    dev))
            flat = torch.from_numpy(x).to(dev).view(-1)
            for off in (0, 1, 2):
                xv = flat[off:off + n * cols].view(n, cols)
                got = P.quant_codes(q, xv)
                check(torch.equal(got, P.quant_codes_plain(q, xv))
                      and torch.equal(got, P.quant_codes(q, xv)),
                      "QC edge case (%d features, %d bounds, %d x %d rows, "
                      "offset %d, miss %s): not its plain version"
                      % (feats, k, n, cols, off * 4, miss is not None))
                cases += 1
    return cases


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
        if label == "full":
            print("QC edge cases: %d grids x rows x views bitwise the plain "
                  "version" % qc_edge_cases(P, qf, dev))
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
        # QW in both modes: at every row count up to the bulk shape, the
        # grid's edge values first
        xq = torch.from_numpy(np.concatenate([
            grid_edge_rows(trees, FEATURES, 5, 4096),
            held_rows(trees, FEATURES, cats, BULK_ROWS - 4096)])).to(dev)
        cq = P.quant_codes(qf, xq)
        check(torch.equal(cq, P.quant_codes_plain(qf, xq)),
              label + ": QC codes differ from plain at %d rows" % BULK_ROWS)
        errs["forest_quant_walk"] = max(errs["forest_quant_walk"], hold_qw(
            label + ", int8 layout", P, qf, f16, xq, cq))
        del cq
        t_half = len(trees) // 2
        raw_half = P.forest_value_walk(P.stack_trees(trees[:t_half], dev), x)
        med = margin_median(raw_half[None], 1)
        stack = P.stack_trees_early_stop(trees, 1, len(trees), dev)
        # ES in both modes: the check rows, then K1's row counts on xq
        iters = check_early_stop(label, P, stack, x, (0.0, med, 1e30),
                                 (1, 10), errs)
        check_early_stop(label + ", %d rows" % BULK_ROWS, P, stack, xq,
                         (0.0, med, 1e30), (1, 10), errs)
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
            margin, es_rows = med, xq
        del xq
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
    xl = torch.from_numpy(ctx["xv"].copy()).to(dev)
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
    P.forest_value_walk_f16.launches_rows = 0
    P.forest_quant_walk.launches_rows = 0
    P.forest_early_stop_walk.launches_rows = 0
    booster = lgb.Booster(model_str=text)
    check(booster.device.type == "cuda", "default device is not cuda")
    bias = booster._inner.init_score_bias
    es_kw = dict(pred_early_stop=True, pred_early_stop_freq=ES_FREQ,
                 pred_early_stop_margin=margin)
    es_value = booster.predict(bulk, **es_kw)
    es_raw = booster.predict(bulk, raw_score=True, **es_kw)
    # a small request walks ES's trees mode
    check(np.array_equal(booster.predict(bulk[:256], raw_score=True,
                                         **es_kw), es_raw[:256]),
          "early stop on 256 rows != the bulk call's rows")
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
    f16_rows = P.forest_value_walk_f16.launches_rows
    qw_rows = P.forest_quant_walk.launches_rows
    es_rows_mode = P.forest_early_stop_walk.launches_rows
    print("serving extras main path launches:", launches, "(K1-f16: %d in "
          "trees mode, %d in rows mode; QW: %d in trees mode, %d in rows "
          "mode; ES: %d in trees mode, %d in rows mode)" % (
              launches["forest_value_walk_f16"] - f16_rows, f16_rows,
              launches["forest_quant_walk"] - qw_rows, qw_rows,
              launches["forest_early_stop_walk"] - es_rows_mode,
              es_rows_mode))
    check(all(v > 0 for v in launches.values()),
          "a serving-extras kernel of the main path was never launched")
    check(0 < es_rows_mode < launches["forest_early_stop_walk"],
          "ES did not launch both modes on the main path")
    plain = {
        "early stop": P.forest_early_stop_walk_plain(
            P.stack_trees_early_stop(trees, 1, TREES, dev), xb, margin,
            ES_FREQ)[0][0],
        "f16": P.forest_value_walk_plain(P.to_f16(P.stack_trees(trees, dev)),
                                         xb)}
    qf = P.stack_trees_quant(trees, dev)
    plain["int8"] = P.forest_quant_walk_plain(
        qf, P.quant_codes_plain(qf, xb), xb)
    f16 = P.to_f16(P.stack_trees(trees, dev))
    for n in (1, BULK_ROWS):
        xn = xb[:n].contiguous()
        got = P.forest_value_walk_f16(f16, xn)
        check(bitwise(got, plain["f16"][:n])
              and bitwise(got, P.forest_value_walk_f16(f16, xn)),
              "K1-f16 not bitwise equal to plain and its repeat at %d rows"
              % n)
        errs["forest_value_walk_f16"] = max(
            errs["forest_value_walk_f16"],
            float((got - plain["f16"][:n]).abs().max()))
    print("kernels vs plain [binned full, f16 leaves]: K1-f16 bitwise equal "
          "to plain and its repeat at 1 and %d rows" % BULK_ROWS)
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
    hold_w_train("the continued-training replay", replay._inner,
                 replay._inner.models[-1], 1.0)
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
        if kname == "forest_early_stop_walk":
            # device time alone at the bulk shape (the JSON row's), and on
            # one row at the main path's margin and at one it never
            # reaches (all 500 iterations)
            wrapper_ms = ms
            ms = graph_ms(kernel)
            one = xb[:1].contiguous()
            print("time [%s | %s]: forest_early_stop_walk device %.4f ms "
                  "(CUDA graph replay), call %.4f ms, bound %.4f ms; 1 row "
                  "device %.4f ms (margin %.6g), %.4f ms (margin 1e30, "
                  "never frozen), call %.4f ms" % (
                      name, card, ms, wrapper_ms, b_ms, graph_ms(
                          lambda: P.forest_early_stop_walk(
                              stack, one, margin, ES_FREQ)), margin,
                      graph_ms(lambda: P.forest_early_stop_walk(
                          stack, one, 1e30, ES_FREQ)),
                      median_ms(lambda: P.forest_early_stop_walk(
                          stack, one, 1e30, ES_FREQ))))
        if kname == "forest_value_walk_f16":
            # device time alone at the bulk shape, which the JSON row
            # keeps, and on one row
            wrapper_ms = ms
            ms = graph_ms(kernel)
            one = xb[:1].contiguous()
            print("time [%s | %s]: forest_value_walk_f16 device %.4f ms (CUDA "
                  "graph replay), call %.4f ms; 1 row device %.4f ms, call "
                  "%.4f ms" % (name, card, ms, wrapper_ms, graph_ms(
                      lambda: P.forest_value_walk_f16(f16, one)),
                      median_ms(lambda: P.forest_value_walk_f16(f16, one))))
        if kname == "forest_quant_walk":
            # device time alone at the bulk shape (the JSON row's), on one
            # row, and QW's two modes either side of the crossover
            wrapper_ms = ms
            ms = graph_ms(kernel)
            one, c1 = xb[:1].contiguous(), codes[:1].contiguous()
            limit, cross = P.TREE_PARALLEL_MAX_ROWS, []
            for n in (4096, 16_384, 32_768, 65_536):
                xn, cn = xb[:n].contiguous(), codes[:n].contiguous()
                for mode, at in (("trees", BULK_ROWS), ("rows", 0)):
                    P.TREE_PARALLEL_MAX_ROWS = at
                    cross.append("%d rows %s %.4f" % (n, mode, graph_ms(
                        lambda: P.forest_quant_walk(qf, cn, xn), reps=20)))
            P.TREE_PARALLEL_MAX_ROWS = limit
            print("time [%s | %s]: forest_quant_walk device %.4f ms (CUDA "
                  "graph replay), call %.4f ms; 1 row device %.4f ms, call "
                  "%.4f ms; modes (device ms; the plan takes trees mode up "
                  "to %d rows): %s" % (
                      name, card, ms, wrapper_ms, graph_ms(
                          lambda: P.forest_quant_walk(qf, c1, one)),
                      median_ms(lambda: P.forest_quant_walk(qf, c1, one)),
                      limit, ", ".join(cross)))
        if kname == "quant_codes":
            # QC's device time apart from its wrapper's host time, and
            # the library call's measured the same two ways; the JSON
            # row keeps the device times
            wrapper_ms, lib_call_ms = ms, lib_ms
            ms, lib_ms = graph_ms(kernel), graph_ms(library)
            print("time [%s | %s]: quant_codes device %.4f ms (CUDA graph "
                  "replay), call %.4f ms (CUDA events around the wrapper); "
                  "torch.searchsorted device %.4f ms, call %.4f ms"
                  % (name, card, ms, wrapper_ms, lib_ms, lib_call_ms))
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
    # a served row of each layout: QC + QW for int8, K1-f16 for f16
    for mode in ("f32", "f16", "int8"):
        predictor = lgb.Booster(model_str=text, params={
            "tpu_predict_quantize": "none" if mode == "f32" else mode
        }).serving_predictor()
        predictor.warmup()
        lat = []
        for r in bulk[:200]:
            t0 = time.perf_counter()
            predictor.predict_one(r)
            lat.append((time.perf_counter() - t0) * 1e3)
        predictor.close()
        print("time [%s | %s]: Predictor.predict_one %s p50 %.3f ms p99 "
              "%.3f ms (200 requests)" % (name, card, mode,
                                          np.percentile(lat, 50),
                                          np.percentile(lat, 99)))
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
    threshold bitwise, a second launch repeating the bits), GT against the
    replay of its select (`goss_threshold_order`, bitwise) and the
    threshold against np.partition on the host (a NaN mag the smallest,
    as the JAX sort has it)."""
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
    check(same(thr, goss.goss_threshold_order(g, h, top_k)),
          "GT (%s): threshold not bitwise the replay of its select" % label)
    host = mag.cpu().numpy()
    part = np.partition(np.where(np.isnan(host), -np.inf, host),
                        n - top_k)[n - top_k]
    check(np.isnan(thr.item()) if part == -np.inf
          else np.float32(thr.item()) == part,
          "GT (%s): threshold %r, np.partition %r" % (label, thr.item(),
                                                      part))
    top = int((w == 1.0).sum())
    check(np.isnan(thr.item()) or top >= top_k,
          "GW (%s): %d top rows of %d" % (label, top, top_k))
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
            # the last round's last dropped tree, taken off the score
            hold_w_train("a DART drop", gb,
                         gb.models[(gb.drop_index or [0])[-1]], -1.0)
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
    # ties at the k-th value, NaN (and inf x 0), zero and subnormal mags
    # (subnormal products and inputs, which GT reads as zero as XLA does)
    tie_g = torch.round(g19 * 2) / 2
    nan_g, nan_h = g19.clone(), h19.clone()
    nan_g[::7] = float("nan")
    nan_h[::11] = float("inf")
    nan_g[::13] = 0.0
    zero_g = torch.where(torch.arange(n, device=dev) % 10 < 7,
                         torch.zeros_like(g19), g19)
    tiny = float(np.finfo(np.float32).tiny)
    sub_g = torch.where(torch.arange(n, device=dev) % 2 == 0, g19 * 1e-20,
                        g19)
    sub_h = torch.where(torch.arange(n, device=dev) % 3 == 0, h19 * 1e-19,
                        h19)
    sub_h[::5] = tiny / 4
    n_nan = int(torch.isnan(goss.goss_threshold_plain(
        nan_g, nan_h, 1)[0]).sum())
    cases = [
        ("all-equal mags", torch.full_like(g19, -0.5),
         torch.full_like(h19, 0.125), top_k),
        ("all-zero mags", torch.zeros_like(g19), h19, top_k),
        ("ties at the k-th", tie_g, torch.full_like(h19, 0.25), top_k),
        ("ties, top_k at the tie's end", tie_g, torch.full_like(h19, 0.25),
         int((goss.goss_magnitude(tie_g, torch.full_like(h19, 0.25))
              >= goss.goss_threshold_plain(
                  tie_g, torch.full_like(h19, 0.25), top_k)[1]).sum())),
        ("NaN and inf mags", nan_g, nan_h, top_k),
        ("NaN mags, a NaN threshold", nan_g, nan_h, n - n_nan // 2),
        ("70% zero mags", zero_g, h19, top_k),
        ("70% zero mags, a zero threshold", zero_g, h19, n // 2),
        ("subnormal products and inputs", sub_g, sub_h, n // 2),
        ("top_k 1", g19, h19, 1),
        ("top_k n-1", g19, h19, n - 1),
        ("top_k n", g19, h19, n),
        ("%d rows" % ODD_ROWS, odd_g, odd_h, int(ODD_ROWS * 0.2))]
    for label, g, h, k in cases:
        m = g.shape[0]
        goss_case(g, h, k, max(1, int(m * 0.1)), key, label)
    print("GT/GW vs plain: %s: weights and threshold bitwise, the "
          "threshold bitwise the replay of GT's select and = np.partition, "
          "repeats equal" % ", ".join(c[0] for c in cases))

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
    gt_ms = graph_ms(lambda: goss.goss_threshold(g19, h19, top_k),
                     calls=SHORT_CALLS)
    wbuf = torch.empty(n, device=dev)
    key19 = rng.fold_in(rng.prng_key(seed), 19)
    gw_ms = graph_ms(lambda: goss.goss_weights(mag, thr, key19, rest_p,
                                               mult, wbuf), calls=SHORT_CALLS)
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
    hl_ms = graph_ms(lambda: histogram.leaf_histogram(binned, w3, nb,
                                                      bf16=True))
    f32_ms = graph_ms(lambda: histogram.leaf_histogram(binned, w3, nb))
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


# ---------------------------------------------------------------------
# uint16 group bins, data files and the binary cache (phases 30-35)
# bench.py's bosch shape (synth_bosch, max_bin 63) through the phase-5
# split: rows 0-499,999 train, 500,000-599,999 validate
BOSCH_ROWS, BOSCH_VALID_ROWS, BOSCH_FEATURES, BOSCH_SEED = \
    500_000, 100_000, 968, 2
BOSCH_ROUNDS, BOSCH_F32_ROUNDS = 10, 3
BOSCH_PARAMS = dict(TRAIN_PARAMS, metric="auc")
# 10,000 rows: 50,000 rows of 968 columns took 80 s of the command to
# write and parse; the last of the 8,192-row chunks stays ragged
BOSCH_FILE_ROWS, BOSCH_FILE_CHUNK, BOSCH_FILE_ROUNDS = 10_000, 8192, 3
BOSCH_CPU_ROWS, BOSCH_CPU_VALID_ROWS = 65_536, 16_384
BOSCH_CPU_LEAVES, BOSCH_CPU_ROUNDS = 63, 3
# the phase-9 protocol at max_bin 1023: one feature a group, ~1,024 bins
WIDE_MAX_BIN, WIDE_ROUNDS = 1023, 3
# rows of the HIGGS matrix that H's summation order is replayed on
ORDER_ROWS = 262_144
# H's warp-shared checks (phase 35): a seeded matrix of groups on both
# sides of the narrow/wide edge, up to 2,048 bins, and cancelling
# gradients on one 631-bin group
WIDE_H_ROWS = 262_144
WIDE_H_WIDTHS = (2048, 1023, 631, 352, 351, 63, 7)
CANCEL_WIDE_ROWS = 2_000_000


def hold_wide_cases(name, card, dev, bosch, w1, nb, layouts, child,
                    wide_in, ww):
    """Phase 35's checks of H's warp-shared pass and its reduction, each
    in both modes through hold_hist (bitwise its replay, repeats equal,
    within 1e-5 of plain and of the f64 oracle): the Bosch matrix on row
    lists of 0, 1 and 37 rows (the first of the root split's smaller
    child); the max_bin=1023 root (wide_in's matrix, its gradients ww); a
    seeded matrix of WIDE_H_WIDTHS, all rows and a seeded third;
    cancelling gradients on a 631-bin group (four bins of 500,000 rows,
    g ~ N(0, 0.5) less each bin's mean), whose error against the f64 sums
    prints beside that of f32 chains of the same values."""
    from lightgbm_tpu_torch.ops import histogram
    gen = np.random.RandomState(35)
    seeded = torch.from_numpy(np.stack([gen.randint(0, w, WIDE_H_ROWS) for w
                                        in WIDE_H_WIDTHS], 1)
                              .astype(np.uint16)).to(dev)
    keep = (gen.rand(WIDE_H_ROWS) < 0.9).astype(np.float32)
    sw = torch.from_numpy(np.stack([
        gen.randn(WIDE_H_ROWS) * 0.7 * keep,
        (gen.rand(WIDE_H_ROWS) * 0.25 + 1e-3) * keep, keep], 1)
        .astype(np.float32)).to(dev)
    third = torch.from_numpy(gen.permutation(WIDE_H_ROWS)[:WIDE_H_ROWS // 3]
                             .astype(np.int32)).to(dev)
    bins = gen.randint(0, 4, CANCEL_WIDE_ROWS) * 157
    x = gen.randn(CANCEL_WIDE_ROWS) * 0.5
    x -= (np.bincount(bins, x, 631) / np.maximum(
        np.bincount(bins, minlength=631), 1))[bins]
    cw_host = np.stack([x, gen.rand(CANCEL_WIDE_ROWS) * 0.25,
                        np.ones(CANCEL_WIDE_ROWS)], 1).astype(np.float32)
    cb = torch.from_numpy(bins.astype(np.uint16)[:, None]).to(dev)
    cw = torch.from_numpy(cw_host).to(dev)
    wb, wnb = wide_in._binned, wide_in._grower.num_bins
    err, cancel = 0.0, []
    for bf16 in (True, False):
        mode = "hi+lo" if bf16 else "f32"
        for m in (0, 1, 37):
            err = max(err, hold_hist("H u16 %s Bosch %d-row list" % (mode, m),
                                     bosch, w1, nb, bf16, layouts[bf16],
                                     child, m)[1])
        err = max(err, hold_hist(
            "H u16 %s max_bin=%d root" % (mode, WIDE_MAX_BIN), wb, ww, wnb,
            bf16, histogram.hist_layout(wide_in._grower.hist_layout.widths,
                                        bf16, dev))[1])
        lay = histogram.hist_layout(WIDE_H_WIDTHS, bf16, dev)
        for rows, cnt in ((None, None), (third, int(third.shape[0]))):
            err = max(err, hold_hist(
                "H u16 %s seeded %s bins (%s)" % (mode, WIDE_H_WIDTHS, (
                    "all rows" if rows is None else "%d-row list" % cnt)),
                seeded, sw, max(WIDE_H_WIDTHS), bf16, lay, rows, cnt)[1])
        got = hold_hist("H u16 %s cancelling gradients, one 631-bin group"
                        % mode, cb, cw, 631, bf16,
                        histogram.hist_layout([631], bf16, dev))[0]
        if bf16:
            hi, lo = histogram.hi_lo(cw[:, :2].contiguous())
            parts = [hi[:, 0].cpu().numpy(), lo[:, 0].cpu().numpy()]
        else:
            parts = [cw_host[:, 0]]
        got = got[0, :, 0].double().cpu().numpy()
        ref = sum(np.bincount(bins, p.astype(np.float64), 631) for p in parts)
        chain = max(abs(float(np.cumsum(sum(p[bins == b] for p in parts),
                                        dtype=np.float32)[-1]) - ref[b])
                    for b in (0, 157, 314, 471))
        cancel.append("%s %.3g (f32 chains %.3g)" % (mode, float(np.max(
            np.abs(got - ref) / np.maximum(1.0, np.abs(ref)))), chain))
    print("H u16 warp-shared checks [%s]: Bosch row lists of 0, 1 and 37 "
          "rows, the max_bin=%d root, %d seeded rows of groups of %s bins "
          "(all rows and a third), both modes: bitwise the replay of its "
          "summation order, repeats equal, max abs err %.3g against plain; "
          "cancelling gradients on a 631-bin group (%d rows), error "
          "against the f64 sums relative to max(1, |ref|): %s"
          % (card, WIDE_MAX_BIN, WIDE_H_ROWS, WIDE_H_WIDTHS, err,
             CANCEL_WIDE_ROWS, "; ".join(cancel)))
    return err


def uint16_ops(dev):
    """What this torch does with a uint16 tensor on `dev`: an add and an
    index, each "ok" or the first words of the error it raises (the
    plain versions widen uint16 bins through their int16 view)."""
    t = torch.from_numpy(np.arange(4, dtype=np.uint16)).to(dev)
    idx = torch.tensor([1, 0], device=dev)
    out = []
    for label, op in (("add", lambda: t + 1), ("index", lambda: t[idx])):
        try:
            op()
            torch.cuda.synchronize()
            out.append(label + " ok")
        except (RuntimeError, NotImplementedError) as exc:
            out.append("%s raises %r" % (label, str(exc).splitlines()[0][:60]))
    return ", ".join(out)


def write_tsv(path, x, y, block=5000):
    """Label first, then the features, each the shortest decimal that
    reads back as the same float64 (so the file holds the f32 values
    exactly)."""
    with open(path, "w") as fh:
        for lo in range(0, len(x), block):
            m = np.column_stack([y[lo:lo + block], x[lo:lo + block]]).astype(
                np.float64).astype(str)
            fh.write("\n".join("\t".join(r) for r in m))
            fh.write("\n")


def bosch(name, card, dev, ctx):
    """Phases 30-35; returns the JSON rows of the kernels' uint16 modes
    and S past 256 bins a feature."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.dataset import Dataset as Inner
    from lightgbm_tpu_torch.ingest import CacheCorrupt, CacheMismatch
    from lightgbm_tpu_torch.ops import (histogram, linear as lin, predict,
                                        route, split)
    from lightgbm_tpu_torch.ops.histogram import take_bins
    from lightgbm_tpu_torch.testing.synth import synth_bosch

    H = histogram.leaf_histogram
    counted = {"leaf_histogram": H, "split_scan": split.split_scan,
               "route_partition": route.route_partition,
               "score_update": route.score_update,
               "tree_value_walk_binned": predict.tree_value_walk_binned,
               "tree_leaf_walk_binned": predict.tree_leaf_walk_binned,
               "linear_normal_eq": lin.linear_normal_eq,
               "linear_solve": lin.linear_solve,
               "linear_addend": lin.linear_addend}

    def reset():
        for fn in counted.values():
            fn.launches = 0
        for fn in (H, route.route_partition, predict.tree_value_walk_binned,
                   predict.tree_leaf_walk_binned):
            fn.launches_u16 = 0
        H.launches_hilo = 0
        split.split_scan.launches_wide = 0

    def read():
        out = {k: fn.launches for k, fn in counted.items()}
        out.update(H_u16=H.launches_u16, H_hilo=H.launches_hilo,
                   R_u16=route.route_partition.launches_u16,
                   W_u16=predict.tree_value_walk_binned.launches_u16,
                   W_leaf_u16=predict.tree_leaf_walk_binned.launches_u16,
                   S_wide=split.split_scan.launches_wide)
        return out

    t0 = time.perf_counter()
    xa, ya = synth_bosch(BOSCH_ROWS + BOSCH_VALID_ROWS, BOSCH_FEATURES,
                         seed=BOSCH_SEED)
    x, y = xa[:BOSCH_ROWS], ya[:BOSCH_ROWS]
    xv, yv = xa[BOSCH_ROWS:], ya[BOSCH_ROWS:]
    print("bosch data: synth_bosch(%d, %d, seed %d) in %.1f s"
          % (BOSCH_ROWS + BOSCH_VALID_ROWS, BOSCH_FEATURES, BOSCH_SEED,
             time.perf_counter() - t0))
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, y, params=dict(BOSCH_PARAMS))
    ds.construct()
    construct_s = time.perf_counter() - t0
    valid = ds.create_valid(xv, yv)
    valid.construct()
    inner = ds._inner
    widths = inner.groups.group_num_bin
    check(inner.binned.dtype == np.uint16 and inner.num_groups == 338
          and int((widths == 631).sum()) == 70,
          "the Bosch matrix is %s with %d groups, not uint16 with 338 "
          "(70 of 631 bins)" % (inner.binned.dtype, inner.num_groups))
    print("bosch datasets: %d x %d features -> %d groups (%d of %d bins, "
          "the rest at most %d), uint16, %.1f MB of training bins; "
          "Dataset.construct() of the %d training rows %.1f s, valid %d "
          "rows" % (BOSCH_ROWS, BOSCH_FEATURES, inner.num_groups,
                    int((widths == widths.max()).sum()), widths.max(),
                    int(widths[widths < widths.max()].max()),
                    inner.binned.nbytes / 1e6, BOSCH_ROWS, construct_s,
                    BOSCH_VALID_ROWS))

    # --------------------------------------------------------------- 31
    reset()
    booster, evals, update_s = train_run(
        lgb, x, y, xv, yv, BOSCH_PARAMS, BOSCH_ROUNDS,
        data=(ds, valid))[:3]
    launches = read()
    print("bosch main path launches:", launches)
    check(booster.device.type == "cuda"
          and booster._inner._binned.dtype == torch.uint16,
          "the Bosch path did not train on uint16 bins on cuda")
    for k in ("leaf_histogram", "split_scan", "route_partition",
              "tree_value_walk_binned", "score_update"):
        check(launches[k] > 0, "Bosch path: %s never launched" % k)
    check(launches["H_u16"] == launches["H_hilo"] == launches[
        "leaf_histogram"] and launches["R_u16"] == launches[
        "route_partition"] and launches["W_u16"] == launches[
        "tree_value_walk_binned"], "Bosch path: H, R or W launched off "
          "their uint16 (H: hi+lo) modes: %s" % launches)
    auc = evals["valid"]["auc"]
    check(len(auc) == BOSCH_ROUNDS and np.isfinite(auc).all()
          and auc[-1] > auc[0] and auc[-1] > 0.7,
          "Bosch valid AUC %s does not rise" % auc)
    text = booster.model_to_string()
    again = train_run(lgb, x, y, xv, yv, BOSCH_PARAMS, BOSCH_ROUNDS,
                      data=(ds, valid))[0]
    check(again.model_to_string() == text,
          "two Bosch runs gave different model texts")
    del again
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    model_path = str(OUT_DIR / "bosch_model.txt")
    booster.save_model(model_path)
    predict.forest_value_walk.launches = 0
    served = lgb.Booster(model_file=model_path)
    raw = served.predict(xv, raw_score=True)
    check(served.device.type == "cuda" and served.num_feature()
          == BOSCH_FEATURES and predict.forest_value_walk.launches > 0,
          "the served Bosch model: not on cuda, not 968 features or no K1")
    kept = booster._inner.valid_score(0)
    rel = float(np.max(np.abs(raw - kept) / np.maximum(1.0, np.abs(kept))))
    check(rel <= 1e-5, "served Bosch raw scores off W's by %g" % rel)
    # H's f32 mode on uint16 bins: the path with tpu_hist_bf16=false
    reset()
    f32_auc = train_run(lgb, x, y, xv, yv,
                        dict(BOSCH_PARAMS, tpu_hist_bf16=False),
                        BOSCH_F32_ROUNDS, data=(ds, valid))[1]["valid"]["auc"]
    f32_launches = read()
    check(f32_launches["H_u16"] == f32_launches["leaf_histogram"] > 0
          and f32_launches["H_hilo"] == 0 and f32_auc[-1] > 0.7,
          "Bosch tpu_hist_bf16=false: %s, auc %s" % (f32_launches, f32_auc))
    print("bosch main path: %d rounds, %d trees of %s leaves, valid auc "
          "%s; a second run byte-identical (%d bytes); the saved model "
          "served through K1 on %d rows x %d features within %.3g of W's "
          "scores; tpu_hist_bf16=false %d rounds (H f32 mode on uint16 %d "
          "launches), auc %.5f"
          % (BOSCH_ROUNDS, booster.num_trees(),
             sorted({t.num_leaves for t in booster._inner.models}),
             " ".join("%.5f" % a for a in auc), len(text), BOSCH_VALID_ROWS,
             BOSCH_FEATURES, rel, BOSCH_F32_ROUNDS,
             f32_launches["H_u16"], f32_auc[-1]))

    # --------------------------------------------------------------- 30
    errs = {}
    fresh = lgb.Booster(dict(BOSCH_PARAMS), train_set=ds)
    gb = fresh._inner
    grower = gb._grower
    binned = gb._binned
    layouts = {bf16: histogram.hist_layout(
        inner.groups.group_num_bin, bf16, dev) for bf16 in (True, False)}
    nb, fb = grower.num_bins, grower.feature_bins
    fmeta, prm = grower.fmeta_dev, grower.params
    n = binned.shape[0]
    mask = torch.ones(inner.num_features, dtype=torch.uint8, device=dev)
    grad, hess = gb.objective.get_gradients(gb._score[0])
    w1 = torch.stack([grad, hess, torch.ones_like(grad)], 1).contiguous()
    g10, h10 = booster._inner.objective.get_gradients(
        booster._inner._score[0])
    w10 = torch.stack([g10, h10, torch.ones_like(g10)], 1).contiguous()
    del grad, hess, g10, h10

    def hist(w, bf16, rows=None, cnt=None):
        return H(binned, w, nb, rows=rows, n_rows=cnt, bf16=bf16,
                 layout=layouts[bf16])

    def held(w, bf16, rows=None, cnt=None, label=""):
        # every group, lane-private and warp-shared, bit for bit its order
        return hold_hist("H u16 " + label, binned, w, nb, bf16,
                         layouts[bf16], rows, cnt)

    errs["leaf_histogram_u16_f32"] = errs["leaf_histogram_u16_hilo"] = 0.0
    roots = {}
    for wl, w in (("round 1", w1), ("round 10", w10)):
        for bf16 in (True, False):
            key = "leaf_histogram_u16_" + ("hilo" if bf16 else "f32")
            got, err = held(w, bf16, label="%s root, %s" % (key, wl))
            errs[key] = max(errs[key], err)
            roots[(wl, bf16)] = got
    h_root = roots[("round 1", True)]
    acc = leaf_totals(h_root)
    sums = torch.from_numpy(acc[None]).to(dev)
    depth0 = torch.zeros(1, dtype=torch.int32, device=dev)
    s_root = split.split_scan(h_root[None], sums, depth0, fmeta, mask, prm,
                              fb)
    for got in (split.split_scan(h_root[None], sums, depth0, fmeta, mask,
                                 prm, fb),
                split.split_scan_plain(h_root[None], sums, depth0, fmeta,
                                       mask, prm, fb)):
        check(all(torch.equal(a, b) for a, b in zip(s_root, got)),
              "S Bosch root: not bitwise its repeat and plain version")
    out_f = s_root[0][0].cpu().numpy()
    out_i = s_root[1][0].cpu().numpy()
    feat = int(out_i[0])
    fm = grower.fmeta
    rule = route.SplitRule(
        int(fm["group"][feat]), int(fm["offset"][feat]),
        int(fm["num_bin"][feat]), int(fm["default_bin"][feat]),
        int(fm["missing_type"][feat]), bool(fm["is_bundled"][feat]),
        int(out_i[1]), bool(out_i[2]), bool(out_i[3]), 0, 1)
    perm0 = torch.arange(n, dtype=torch.int32, device=dev)
    lid0 = torch.zeros(n, dtype=torch.int32, device=dev)
    res = []
    for fn in (route.route_partition, route.route_partition,
               route.route_partition_plain):
        perm, lid = perm0.clone(), lid0.clone()
        res.append((perm, lid, int(fn(binned, perm, 0, n, rule, lid))))
    check(all(torch.equal(res[0][0], r[0]) and torch.equal(res[0][1], r[1])
              and res[0][2] == r[2] for r in res[1:]),
          "R u16: partition or leaf ids differ between launches or from "
          "plain")
    perm, lid, n_left = res[0]
    check(n_left == int(round(float(out_f[3]))),
          "R u16 sent %d rows left, the scan counted %s" % (n_left, out_f[3]))
    hold_route("Bosch root split, uint16", binned, rule)
    small_left = np.float32(out_f[3]) * np.float32(2.0) <= acc[2]
    b0, cnt = (0, n_left) if small_left else (n_left, n - n_left)
    small = 0 if small_left else 1
    for bf16 in (True, False):
        key = "leaf_histogram_u16_" + ("hilo" if bf16 else "f32")
        errs[key] = max(errs[key], held(
            w1, bf16, perm[b0:], cnt, "%s row list, %d rows" % (key, cnt))[1])
    # a random quarter of the rows, in random order, as the row list
    rnd = torch.from_numpy(np.random.RandomState(3).choice(
        n, n // 4, replace=False).astype(np.int32)).to(dev)
    for bf16 in (True, False):
        key = "leaf_histogram_u16_" + ("hilo" if bf16 else "f32")
        errs[key] = max(errs[key], held(
            w10, bf16, rnd, len(rnd), "%s random row list, %d rows"
            % (key, len(rnd)))[1])
    del rnd
    h_small = hist(w1, True, perm[b0:], cnt)
    pair = torch.empty((2,) + tuple(h_root.shape), device=dev)
    pair[small] = h_small
    pair[1 - small] = histogram.subtract(h_root, h_small)
    left = out_f[1:4].astype(np.float32)
    csums = torch.from_numpy(np.stack([left, acc - left])).to(dev)
    depth1 = torch.ones(2, dtype=torch.int32, device=dev)
    s_kids = split.split_scan(pair, csums, depth1, fmeta, mask, prm, fb)
    for got in (split.split_scan(pair, csums, depth1, fmeta, mask, prm, fb),
                split.split_scan_plain(pair, csums, depth1, fmeta, mask, prm,
                                       fb)):
        check(all(torch.equal(a, b) for a, b in zip(s_kids, got)),
              "S Bosch children: not bitwise its repeat and plain version")
    # the cases S's grid of feature tiles could get wrong, on that pair
    s_case_names = s_cases("Bosch", pair, csums, fmeta, prm, fb, dev)
    print("S Bosch leaf pair (%d features, tiles %s): bitwise its repeat "
          "and plain version in the cases %s"
          % (inner.num_features, tuple(split.split_plan(inner.num_features,
                                                        fb)),
             ", ".join(s_case_names)))
    tree0 = booster._inner.models[0]
    bt = predict.binned_tree(tree0, dev)
    vb = booster._inner._valid_binned[0]
    check(vb.dtype == torch.uint16, "the Bosch valid bins are not uint16")
    check(vb.stride() == (1, BOSCH_VALID_ROWS),
          "the wide Bosch valid bins W walks are not column-major (strides "
          "%s)" % (vb.stride(),))
    walked, leaves = [], []
    # the booster's column-major bins, and the same bins row-major
    for bins in (vb, vb.contiguous()):
        for fn in (predict.tree_value_walk_binned,
                   predict.tree_value_walk_binned,
                   predict.tree_value_walk_binned_plain):
            sc = torch.zeros(BOSCH_VALID_ROWS, dtype=torch.float32,
                             device=dev)
            fn(bt, bins, sc)
            walked.append(sc)
        for fn in (predict.tree_leaf_walk_binned,
                   predict.tree_leaf_walk_binned,
                   predict.tree_leaf_walk_binned_plain):
            leaves.append(fn(bt, bins))
    check(all(bitwise(walked[0], s) for s in walked[1:])
          and all(torch.equal(leaves[0], v) for v in leaves[1:]),
          "W u16 (value or leaf mode) differs between launches or from "
          "plain")
    # H on uint8 matrices: bit for bit its summation order (the replay
    # leaf_histogram_order), all rows and a row list, at B 64 (the HIGGS
    # matrix) and at B 256 (seeded bins of every value)
    hb = ctx["data"][0]._inner.binned[:ORDER_ROWS]
    rng = np.random.RandomState(30)
    w8 = torch.from_numpy(np.stack([
        rng.randn(ORDER_ROWS) * 0.7, rng.rand(ORDER_ROWS) * 0.25 + 1e-3,
        (rng.rand(ORDER_ROWS) < 0.9) * 1.0], 1).astype(np.float32)).to(dev)
    w8[:, :2] *= w8[:, 2:]
    order_rows = torch.from_numpy(rng.permutation(ORDER_ROWS)[
        :ORDER_ROWS // 3].astype(np.int32)).to(dev)
    b256 = torch.from_numpy(rng.randint(
        0, 256, (ORDER_ROWS // 4, hb.shape[1])).astype(np.uint8)).to(dev)
    for b8, nb8 in ((torch.from_numpy(np.ascontiguousarray(hb)).to(dev),
                     int(hb.max()) + 1), (b256, 256)):
        w8b = w8[:b8.shape[0]].contiguous()
        sub = order_rows[order_rows < b8.shape[0]].contiguous()
        for bf16 in (True, False):
            for rows, cnt in ((None, None), (sub, int(sub.shape[0]) - 7)):
                got = H(b8, w8b, nb8, rows=rows, n_rows=cnt, bf16=bf16)
                check(torch.equal(got, histogram.leaf_histogram_order(
                    b8, w8b, nb8, rows, cnt, bf16)),
                      "H on uint8 bins (B %d, %s, %s) is not its summation "
                      "order" % (nb8, "hi+lo" if bf16 else "f32",
                                 "all rows" if rows is None else "row list"))
    del b256
    print("uint16 kernels vs plain [Bosch, %d rows x %d groups, B %d]: H "
          "f32 and hi+lo at the root (round-1 and round-10 gradients) and "
          "on the root split's smaller child (%d rows): counts exact, g/h "
          "within 1e-5 of plain and f64 (max abs err %.3g f32, %.3g hi+lo), "
          "repeats equal, every group bitwise its summation order; S "
          "root and children bitwise; R partition and "
          "leaf ids exact; W value and leaf modes exact on %d valid rows; "
          "H on %d uint8 rows (B 64, and B 256 on a quarter) bitwise its "
          "summation order in both modes, all rows and a row list; torch "
          "%s on uint16: %s" % (
              n, binned.shape[1], nb, cnt, errs["leaf_histogram_u16_f32"],
              errs["leaf_histogram_u16_hilo"], BOSCH_VALID_ROWS, ORDER_ROWS,
              torch.__version__, uint16_ops(dev)))
    del b8, w8, w10, roots

    # --------------------------------------------------------------- 32
    fx, fy = x[:BOSCH_FILE_ROWS], y[:BOSCH_FILE_ROWS]
    tsv = str(OUT_DIR / "bosch.tsv")
    t0 = time.perf_counter()
    write_tsv(tsv, fx, fy)
    write_s = time.perf_counter() - t0
    file_params = dict(BOSCH_PARAMS, tpu_ingest_chunk_rows=BOSCH_FILE_CHUNK)
    t0 = time.perf_counter()
    streamed = lgb.Dataset(tsv, params=dict(file_params)).construct()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = lgb.Dataset(tsv, params=dict(BOSCH_PARAMS,
                                         tpu_ingest=False)).construct()
    whole_s = time.perf_counter() - t0
    arr = lgb.Dataset(fx, fy, params=dict(BOSCH_PARAMS)).construct()
    check(BOSCH_FILE_ROWS % BOSCH_FILE_CHUNK != 0, "the last chunk is whole")
    for label, d in (("streamed", streamed), ("loaded whole", whole)):
        check(np.array_equal(d._inner.binned, arr._inner.binned)
              and d._inner.binned.dtype == np.uint16
              and np.array_equal(d._inner.metadata.label,
                                 arr._inner.metadata.label),
              "the %s file's Dataset differs from the array's" % label)
    texts = [lgb.train(dict(BOSCH_PARAMS), d, BOSCH_FILE_ROUNDS)
             .model_to_string() for d in (arr, streamed)]
    check(texts[0] == texts[1], "the file's model text differs from the "
          "array Dataset's")
    os.remove(tsv)
    cache = str(OUT_DIR / "bosch_train.bin")
    t0 = time.perf_counter()
    ds.save_binary(cache)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = Inner.load_binary(cache)
    load_s = time.perf_counter() - t0
    check(np.array_equal(loaded.binned, inner.binned)
          and np.array_equal(loaded.metadata.label, inner.metadata.label),
          "the loaded cache's matrix or labels differ")
    texts = [lgb.train(dict(BOSCH_PARAMS), d, BOSCH_FILE_ROUNDS)
             .model_to_string() for d in (ds, lgb.Dataset._from_inner(
                 loaded))]
    check(texts[0] == texts[1], "the cache's model text differs")
    del loaded
    os.remove(cache)
    small_cache = str(OUT_DIR / "bosch_file.bin")
    arr._inner.save_binary(small_cache, fingerprint="bosch-a")
    mismatch = corrupt = ""
    try:
        Inner.load_binary(small_cache, expected_fingerprint="bosch-b")
    except CacheMismatch as exc:
        mismatch = type(exc).__name__
    with open(small_cache, "r+b") as fh:
        fh.seek(-16, os.SEEK_END)
        fh.write(b"\xff" * 8)
    try:
        Inner.load_binary(small_cache)
    except CacheCorrupt as exc:
        corrupt = type(exc).__name__
    check(mismatch == "CacheMismatch" and corrupt == "CacheCorrupt"
          and not os.path.exists(small_cache)
          and os.path.exists(small_cache + ".corrupt"),
          "cache refusals: %r %r" % (mismatch, corrupt))
    os.remove(small_cache + ".corrupt")
    print("files [%d Bosch rows as TSV, %.1f s to write]: Dataset(path) "
          "streamed in chunks of %d (last %d rows) %.1f s, loaded whole "
          "%.1f s, both bitwise the array Dataset's uint16 matrix, %d "
          "rounds on the card give its model text" % (
              BOSCH_FILE_ROWS, write_s, BOSCH_FILE_CHUNK,
              BOSCH_FILE_ROWS % BOSCH_FILE_CHUNK, stream_s, whole_s,
              BOSCH_FILE_ROUNDS))
    print("time [%s | %s]: binary cache of the %d training rows: "
          "save_binary %.2f s, load_binary %.2f s (mapped, CRCs checked), "
          "binning skipped %.1f s; matrix equal, %d rounds give the same "
          "model text; a mismatched fingerprint raised %s, a corrupted "
          "byte %s and the file was quarantined"
          % (name, card, BOSCH_ROWS, save_s, load_s, construct_s,
             BOSCH_FILE_ROUNDS, mismatch, corrupt))

    # --------------------------------------------------------------- 33
    cx, cy = x[:BOSCH_CPU_ROWS], y[:BOSCH_CPU_ROWS]
    cxv, cyv = xv[:BOSCH_CPU_VALID_ROWS], yv[:BOSCH_CPU_VALID_ROWS]
    cparams = dict(BOSCH_PARAMS, num_leaves=BOSCH_CPU_LEAVES)
    # the Datasets keep raw values, for the linear run below
    cds = lgb.Dataset(cx, cy, params=dict(cparams, linear_tree=True))
    cvalid = cds.create_valid(cxv, cyv)
    cds.construct()
    cvalid.construct()
    t0 = time.perf_counter()
    on_card, ev_card = train_run(lgb, cx, cy, cxv, cyv, cparams,
                                 BOSCH_CPU_ROUNDS, data=(cds, cvalid))[:2]
    on_cpu, ev_cpu = train_run(lgb, cx, cy, cxv, cyv, cparams,
                               BOSCH_CPU_ROUNDS, device="cpu",
                               data=(cds, cvalid))[:2]
    worst = same_trees(on_card, on_cpu, BOSCH_CPU_ROUNDS)
    d_auc = abs(ev_card["valid"]["auc"][-1] - ev_cpu["valid"]["auc"][-1])
    check(d_auc <= 2e-3, "Bosch card/CPU valid AUC differ by %g" % d_auc)
    print("card vs CPU [Bosch %d rows, %d leaves, %d rounds]: same trees, "
          "leaf values within %.3g relative, valid auc %.5f vs %.5f "
          "(%.1f s)" % (BOSCH_CPU_ROWS, BOSCH_CPU_LEAVES, BOSCH_CPU_ROUNDS,
                        worst, ev_card["valid"]["auc"][-1],
                        ev_cpu["valid"]["auc"][-1],
                        time.perf_counter() - t0))
    # linear trees on uint16 bins: H, S, R, W's leaf mode, LF, LS, LA
    reset()
    lin_auc = train_run(lgb, cx, cy, cxv, cyv,
                        dict(cparams, linear_tree=True, linear_lambda=0.01),
                        BOSCH_CPU_ROUNDS, data=(cds, cvalid))[1]
    lin_launches = read()
    check(all(lin_launches[k] > 0 for k in (
        "linear_normal_eq", "linear_solve", "linear_addend",
        "tree_leaf_walk_binned", "W_leaf_u16", "H_u16", "R_u16"))
          and np.isfinite(lin_auc["valid"]["auc"]).all(),
          "linear trees on uint16 bins: %s" % lin_launches)
    print("linear trees on uint16 bins [Bosch %d rows, %d rounds]: "
          "launches %s, valid auc %.5f" % (
              BOSCH_CPU_ROWS, BOSCH_CPU_ROUNDS, lin_launches,
              lin_auc["valid"]["auc"][-1]))
    del on_card, on_cpu

    # --------------------------------------------------------------- 34
    hx, hy, hxv, hyv = ctx["x"], ctx["y"], ctx["xv"], ctx["yv"]
    wparams = dict(TRAIN_PARAMS, max_bin=WIDE_MAX_BIN)
    t0 = time.perf_counter()
    # the Datasets keep raw values, for phase 40's linear run
    wds = lgb.Dataset(hx, hy, params=dict(wparams, linear_tree=True))
    wvalid = wds.create_valid(hxv, hyv)
    wds.construct()
    wvalid.construct()
    wfb = int(wds._inner.num_bins_per_feature().max())
    check(wds._inner.binned.dtype == np.uint16 and wfb > 256,
          "max_bin %d: %s bins, %d a feature" % (
              WIDE_MAX_BIN, wds._inner.binned.dtype, wfb))
    print("max_bin=%d datasets: %d + %d rows x %d groups of up to %d bins, "
          "uint16, %.1f s" % (WIDE_MAX_BIN, len(hx), len(hxv),
                              wds._inner.num_groups,
                              wds._inner.max_num_bin(),
                              time.perf_counter() - t0))
    reset()
    wide_b, wide_ev = train_run(lgb, hx, hy, hxv, hyv, wparams, WIDE_ROUNDS,
                                data=(wds, wvalid))[:2]
    wide_launches = read()
    check(wide_launches["S_wide"] == wide_launches["split_scan"] > 0
          and wide_launches["H_u16"] == wide_launches["leaf_histogram"] > 0,
          "max_bin=%d path: %s" % (WIDE_MAX_BIN, wide_launches))
    wtext = wide_b.model_to_string()
    check(train_run(lgb, hx, hy, hxv, hyv, wparams, WIDE_ROUNDS,
                    data=(wds, wvalid))[0].model_to_string() == wtext,
          "two max_bin=%d runs gave different model texts" % WIDE_MAX_BIN)
    # S at FB ~1,024 on the root, against its plain version (phase 30)
    wfresh = lgb.Booster(dict(wparams), train_set=wds)._inner
    wg = wfresh._grower
    wgrad, whess = wfresh.objective.get_gradients(wfresh._score[0])
    ww = torch.stack([wgrad, whess, torch.ones_like(wgrad)], 1).contiguous()
    w_root = H(wfresh._binned, ww, wg.num_bins, bf16=True,
               layout=wg.hist_layout)
    wsums = torch.from_numpy(leaf_totals(w_root)[None]).to(dev)
    wmask = torch.ones(wds._inner.num_features, dtype=torch.uint8,
                       device=dev)
    s_wide = split.split_scan(w_root[None], wsums, depth0, wg.fmeta_dev,
                              wmask, wg.params, wg.feature_bins)
    for got in (split.split_scan(w_root[None], wsums, depth0, wg.fmeta_dev,
                                 wmask, wg.params, wg.feature_bins),
                split.split_scan_plain(w_root[None], wsums, depth0,
                                       wg.fmeta_dev, wmask, wg.params,
                                       wg.feature_bins)):
        check(all(torch.equal(a, b) for a, b in zip(s_wide, got)),
              "S at %d bins a feature: not bitwise its repeat and plain "
              "version" % wg.feature_bins)
    # the scan's two levels of blocks at the widest scan width S takes
    s_held("max_bin=%d root at 2,048 bins a feature" % WIDE_MAX_BIN,
           (w_root[None], wsums, depth0, wg.fmeta_dev, wmask, wg.params,
            split.MAX_FEATURE_BINS))
    print("max_bin=%d path: %d rounds, S launched %d times at %d bins a "
          "feature (every launch past 256), a second run byte-identical, "
          "valid auc %.5f; S on the root bitwise its plain version at %d "
          "and %d bins a feature"
          % (WIDE_MAX_BIN, WIDE_ROUNDS, wide_launches["S_wide"],
             wg.feature_bins, wide_ev["valid"]["auc"][-1], wg.feature_bins,
             split.MAX_FEATURE_BINS))
    wcparams = dict(wparams, num_leaves=CPU_LEAVES)
    wc = train_run(lgb, hx[:CPU_ROWS], hy[:CPU_ROWS], hxv[:CPU_VALID_ROWS],
                   hyv[:CPU_VALID_ROWS], wcparams, WIDE_ROUNDS)
    wc_data = (wc[3], wc[4])
    wc_cpu = train_run(lgb, None, None, None, None, wcparams, WIDE_ROUNDS,
                       device="cpu", data=wc_data)
    worst = same_trees(wc[0], wc_cpu[0], WIDE_ROUNDS)
    d_auc = abs(wc[1]["valid"]["auc"][-1] - wc_cpu[1]["valid"]["auc"][-1])
    check(d_auc <= 2e-3, "max_bin=%d card/CPU AUC differ by %g"
          % (WIDE_MAX_BIN, d_auc))
    print("card vs CPU [max_bin=%d, %d rows, %d leaves, %d rounds]: same "
          "trees, leaf values within %.3g relative, valid auc %.5f vs %.5f"
          % (WIDE_MAX_BIN, CPU_ROWS, CPU_LEAVES, WIDE_ROUNDS, worst,
             wc[1]["valid"]["auc"][-1], wc_cpu[1]["valid"]["auc"][-1]))
    del wc, wc_cpu, wc_data

    # --------------------------------------------------------------- 35
    print("clocks [%s]: SM clock, max SM clock: %s (before the timings)"
          % (card, clocks()))
    g_cnt = binned.shape[1]
    times = {}
    wide_err = hold_wide_cases(name, card, dev, binned, w1, nb, layouts,
                               perm[b0:], wfresh, ww)
    for key in ("leaf_histogram_u16_f32", "leaf_histogram_u16_hilo"):
        errs[key] = max(errs[key], wide_err)
    in_bytes = n * (2 * g_cnt + 12) + g_cnt * nb * 12
    flat = ((torch.arange(g_cnt, device=dev) * nb)[None]
            + take_bins(binned)).reshape(-1)
    for bf16 in (False, True):
        key = "leaf_histogram_u16_" + ("hilo" if bf16 else "f32")
        halves = histogram.hi_lo(w1[:, :2].contiguous()) if bf16 else (
            w1[:, :2].contiguous(),)
        chans = [c[:, j].contiguous() for c in halves for j in (0, 1)]
        chans.append((w1[:, 2] > 0).float())

        def library(chans=chans):
            for ch in chans:
                torch.bincount(flat, weights=ch[:, None].expand(
                    n, g_cnt).reshape(-1), minlength=g_cnt * nb)
        # H's device time by CUDA-graph replay: two or three kernels a call
        times[key] = (
            graph_ms(lambda: hist(w1, bf16)),
            median_ms(lambda: histogram.leaf_histogram_plain(
                binned, w1, nb, bf16=bf16), reps=3),
            bound(in_bytes, (5.0 if bf16 else 3.0) * n * g_cnt),
            median_ms(library, reps=3))
        print("time [%s | %s]: %s at the Bosch root (%d rows x %d groups, "
              "B %d) %.4f ms, plain %.2f ms, bound %.5f ms (%s), "
              "torch.bincount x%d %.3f ms; row list (%d rows) %.4f ms"
              % (name, card, key, n, g_cnt, nb, times[key][0],
                 times[key][1], times[key][2][0], times[key][2][1],
                 len(chans), times[key][3], cnt, graph_ms(
                     lambda: hist(w1, bf16, perm[b0:], cnt))))
        lay = layouts[bf16]
        plan = histogram.hist_plan(n, len(lay.narrow), lay.narrow_w)
        wplan = histogram.hist_wide_plan(n, len(lay.wide), lay.wide_w)
        print("plan [%s]: %s at the Bosch root: %d lane-private groups of "
              "at most %d bins in %d slices of %d, %d blocks of %d warps, "
              "runs of %d rows, partials %.1f MB; %d warp-shared groups of "
              "at most %d bins, %d a block in %d slices, %d tiles of %d "
              "rows, %d bytes of shared memory a block, partials %.1f MB "
              "(f64, each written and read once; input %.1f MB)"
              % (card, key, len(lay.narrow), lay.narrow_w, plan.slices,
                 plan.gw, plan.blocks, plan.warps, plan.run,
                 plan.partial_words * 8 / 1e6, len(lay.wide), lay.wide_w,
                 wplan.warps, wplan.slices, wplan.tiles, wplan.tile_rows,
                 wplan.smem, wplan.partial_words * 8 / 1e6,
                 n * (2 * g_cnt + 12) / 1e6))
    del flat
    # H at the max_bin=1023 root: 28 warp-shared groups of ~1,024 bins
    wn, wgc = wfresh._binned.shape
    for bf16 in (True, False):
        w_lay = histogram.hist_layout(wg.hist_layout.widths, bf16, dev)
        w_ms = graph_ms(lambda: H(wfresh._binned, ww, wg.num_bins,
                                  bf16=bf16, layout=w_lay))
        w_bound = bound(wn * (2 * wgc + 12) + wgc * wg.num_bins * 12,
                        (5.0 if bf16 else 3.0) * wn * wgc)
        print("time [%s | %s]: leaf_histogram_u16_%s at the max_bin=%d "
              "root (%d rows x %d groups, B %d) %.4f ms, bound %.5f ms (%s)"
              % (name, card, "hilo" if bf16 else "f32", WIDE_MAX_BIN, wn,
                 wgc, wg.num_bins, w_ms, w_bound[0], w_bound[1]))
    hb_all = ctx["data"][0]._inner.binned
    hb_dev = torch.from_numpy(np.ascontiguousarray(hb_all)).to(dev)
    hw = torch.ones((hb_all.shape[0], 3), dtype=torch.float32, device=dev)
    nb_u8 = int(ctx["data"][0]._inner.max_num_bin())
    u8_ms = graph_ms(lambda: H(hb_dev, hw, nb_u8))
    u8_bytes = hb_dev.numel() + hb_all.shape[0] * 12
    print("time [%s | %s]: H on the uint8 HIGGS root (%d rows x %d groups, "
          "f32) %.4f ms, %.0f GB/s of input; uint16 Bosch root hi+lo "
          "%.0f GB/s" % (name, card, hb_all.shape[0], hb_all.shape[1],
                         u8_ms, u8_bytes / u8_ms / 1e6,
                         in_bytes / times["leaf_histogram_u16_hilo"][0]
                         / 1e6))
    del hb_dev, hw
    s_ops = 2 * fmeta["num_bin"].shape[0] * fb * 50
    times["split_scan_u16"] = (
        graph_ms(lambda: split.split_scan(pair, csums, depth1, fmeta, mask,
                                          prm, fb)),
        median_ms(lambda: split.split_scan_plain(pair, csums, depth1, fmeta,
                                                mask, prm, fb), reps=3),
        bound(pair.numel() * 4 + 64, s_ops), None)
    wfm = wg.fmeta_dev["num_bin"].shape[0]
    times["split_scan_wide"] = (
        graph_ms(lambda: split.split_scan(w_root[None], wsums, depth0,
                                          wg.fmeta_dev, wmask, wg.params,
                                          wg.feature_bins)),
        median_ms(lambda: split.split_scan_plain(
            w_root[None], wsums, depth0, wg.fmeta_dev, wmask, wg.params,
            wg.feature_bins), reps=3),
        bound(w_root.numel() * 4 + 32, wfm * wg.feature_bins * 50), None)
    rperm, rlid = perm0.clone(), lid0.clone()
    times["route_partition_u16"] = (
        route_times("Bosch", binned, rule, name, card),
        median_ms(lambda: route.route_partition_plain(binned, rperm, 0, n,
                                                     rule, rlid), reps=3),
        bound(14 * n), None)
    leaf = leaves[0].long()
    depth = torch.from_numpy(leaf_depths([tree0])[0]).to(dev)
    visits = int(depth[leaf].sum())
    sc = torch.zeros(BOSCH_VALID_ROWS, dtype=torch.float32, device=dev)
    times["tree_value_walk_binned_u16"] = (
        graph_ms(lambda: predict.tree_value_walk_binned(bt, vb, sc),
                 calls=SHORT_CALLS),
        median_ms(lambda: predict.tree_value_walk_binned_plain(bt, vb, sc),
                  reps=3),
        bound(2 * visits + 8 * BOSCH_VALID_ROWS + tree_bytes(bt),
              visits * INSTR_PER_VISIT), None)
    times["tree_leaf_walk_binned_u16"] = (
        graph_ms(lambda: predict.tree_leaf_walk_binned(bt, vb),
                 calls=SHORT_CALLS),
        median_ms(lambda: predict.tree_leaf_walk_binned_plain(bt, vb),
                  reps=3),
        bound(2 * visits + 4 * BOSCH_VALID_ROWS + tree_bytes(bt),
              visits * INSTR_PER_VISIT), None)
    for k in ("split_scan_u16", "split_scan_wide", "route_partition_u16",
              "tree_value_walk_binned_u16", "tree_leaf_walk_binned_u16"):
        ms, plain_ms, (b_ms, b_by), _ = times[k]
        print("time [%s | %s]: %s %.4f ms, plain %.3f ms, bound %.5f ms (%s)"
              % (name, card, k, ms, plain_ms, b_ms, b_by))
    med = float(np.median(update_s[1:BOSCH_ROUNDS]))
    print("time [%s | %s]: Bosch boosting round %.4f s (median of rounds "
          "2-%d), %.3f million row-iterations/s, rounds %s; "
          "Dataset.construct() of %d rows %.1f s"
          % (name, card, med, BOSCH_ROUNDS, BOSCH_ROWS / med / 1e6,
             " ".join("%.4f" % v for v in update_s), BOSCH_ROWS,
             construct_s))
    print("clocks [%s]: SM clock, max SM clock: %s (after the timings)"
          % (card, clocks()))
    print("time [%s | %s]: R in the profiled Bosch round %.4f ms" % (
        name, card, round_r_ms(profile_round(booster, name, card)[2])))
    # phases 39-41 train quantized on these Datasets
    ctx["bosch"] = {"x": x, "y": y, "xv": xv, "yv": yv, "data": (ds, valid),
                    "auc": auc, "round_s": med, "cpu_data": (cds, cvalid),
                    "wide_data": (wds, wvalid)}

    launch_of = {
        "leaf_histogram_u16_f32": f32_launches["H_u16"],
        "leaf_histogram_u16_hilo": launches["H_u16"],
        "split_scan_u16": launches["split_scan"],
        "split_scan_wide": wide_launches["S_wide"],
        "route_partition_u16": launches["R_u16"],
        "tree_value_walk_binned_u16": launches["W_u16"],
        "tree_leaf_walk_binned_u16": lin_launches["W_leaf_u16"]}
    replaces = {
        "leaf_histogram_u16_f32": "lightgbm_tpu/ops/histogram.py:333",
        "leaf_histogram_u16_hilo": "lightgbm_tpu/ops/histogram.py:333",
        "split_scan_u16": "lightgbm_tpu/ops/split.py:80",
        "split_scan_wide": "lightgbm_tpu/ops/split.py:80",
        "route_partition_u16": "lightgbm_tpu/learner/grow.py:1037",
        "tree_value_walk_binned_u16": "lightgbm_tpu/ops/predict.py:182",
        "tree_leaf_walk_binned_u16": "lightgbm_tpu/ops/predict.py:87"}
    sources = {"leaf": "histogram.cu", "spli": "split_scan.cu",
               "rout": "route_partition.cu", "tree": "binned_walk.cu"}
    rows = []
    for k, ms_row in times.items():
        ms, plain_ms, (b_ms, b_by), lib_ms = ms_row
        rows.append({
            "name": k, "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/" + sources[k[:4]],
            "replaces": replaces[k], "launches": launch_of[k],
            "max_abs_err": errs.get(k, 0.0), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    return rows


# ---------------------------------------------------------------------
# categorical features (phases 36-38, 41)
# the protocol behind ACCURACY_r05.json's categorical gate
# (scripts/measure_accuracy.py:30-32, :114-146): synth_expo at 600,000
# rows (seed 13), rows 0-499,999 train and the rest test
EXPO_ROWS, EXPO_TEST_ROWS, EXPO_SEED = 500_000, 100_000, 13
EXPO_ROUNDS, EXPO_GATE_ROUNDS = 10, 500
EXPO_CATS = list(range(8))
EXPO_PARAMS = dict(TRAIN_PARAMS, metric="auc", categorical_feature=EXPO_CATS)
# reference LightGBM's test AUC and the JAX package's, 500 rounds
# (ACCURACY_r05.json "categorical"), and the gate the JAX package met
EXPO_REF_AUC, EXPO_JAX_AUC, EXPO_AUC_GATE = 0.815114, 0.815474, 2e-3
EXPO_FILE_ROWS, EXPO_FILE_ROUNDS = 50_000, 3


def rank_auc(y, p):
    """scripts/measure_accuracy.py _auc: the rank statistic over the
    order np.argsort gives (ties by position)."""
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    pos = y > 0
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def single_bin(tree, node):
    """The one bin of a one-vs-rest categorical node's bin-space bitset."""
    c = int(tree.threshold_in_bin[node])
    lo, hi = tree.cat_boundaries_inner[c], tree.cat_boundaries_inner[c + 1]
    bits = np.flatnonzero(np.unpackbits(np.asarray(
        tree.cat_threshold_inner[lo:hi], "<u4").view(np.uint8),
        bitorder="little"))
    check(len(bits) == 1, "categorical node %d holds %d bins" % (node,
                                                                 len(bits)))
    return int(bits[0])


def categorical(name, card, dev):
    """Phases 37, 36 and 38; returns what phase 41 times (the Datasets,
    the trained booster, the kernels' inputs and errors, the main path's
    counts)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.binning import BIN_CATEGORICAL
    from lightgbm_tpu_torch.ops import histogram, predict, route, split
    from lightgbm_tpu_torch.testing.synth import synth_expo

    H, S, R = histogram.leaf_histogram, split.split_scan, route.route_partition
    W = predict.tree_value_walk_binned
    counted = {"leaf_histogram": H, "split_scan": S, "route_partition": R,
               "score_update": route.score_update, "tree_value_walk_binned": W}

    def reset():
        for fn in counted.values():
            fn.launches = 0
        S.launches_cat = R.launches_cat = W.launches_cat = 0

    def read():
        out = {k: fn.launches for k, fn in counted.items()}
        out.update(S_cat=S.launches_cat, R_cat=R.launches_cat,
                   W_cat=W.launches_cat)
        return out

    # --------------------------------------------------------------- 37
    t0 = time.perf_counter()
    xa, ya, cats = synth_expo(EXPO_ROWS + EXPO_TEST_ROWS, seed=EXPO_SEED)
    check(cats == EXPO_CATS, "synth_expo's categorical columns %s" % cats)
    x, y = xa[:EXPO_ROWS], ya[:EXPO_ROWS]
    xt, yt = xa[EXPO_ROWS:], ya[EXPO_ROWS:]
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, y, params=dict(EXPO_PARAMS))
    ds.construct()
    construct_s = time.perf_counter() - t0
    valid = ds.create_valid(xt, yt)
    valid.construct()
    inner = ds._inner
    flags = [inner.feature_mapper(j).bin_type == BIN_CATEGORICAL
             for j in range(inner.num_features)]
    check([j for j, c in enumerate(flags) if c] == EXPO_CATS
          and inner.binned.dtype == np.uint8,
          "the Expo Dataset: categorical features %s, %s bins"
          % ([j for j, c in enumerate(flags) if c], inner.binned.dtype))
    print("expo datasets: synth_expo(%d, seed %d) in %.1f s; %d x %d "
          "features (%d categorical, %s categories), %d groups, uint8, "
          "%.1f MB of training bins; Dataset.construct() %.1f s; test %d "
          "rows" % (EXPO_ROWS + EXPO_TEST_ROWS, EXPO_SEED, data_s, EXPO_ROWS,
                    inner.num_features, len(EXPO_CATS),
                    [inner.feature_mapper(j).num_bin for j in EXPO_CATS],
                    inner.num_groups, inner.binned.nbytes / 1e6, construct_s,
                    EXPO_TEST_ROWS))
    reset()
    booster, evals, update_s = train_run(
        lgb, x, y, xt, yt, EXPO_PARAMS, EXPO_ROUNDS, data=(ds, valid))[:3]
    launches = read()
    print("categorical main path launches:", launches)
    check(booster.device.type == "cuda", "the categorical path ran on %s"
          % booster.device)
    for k in counted:
        check(launches[k] > 0, "categorical path: %s never launched" % k)
    check(launches["S_cat"] == launches["split_scan"]
          and launches["R_cat"] > 0 and launches["W_cat"] > 0,
          "categorical path: S, R or W never ran a categorical variant: %s"
          % launches)
    auc = evals["valid"]["auc"]
    check(len(auc) == EXPO_ROUNDS and np.isfinite(auc).all()
          and auc[-1] > auc[0], "categorical valid AUC %s does not rise"
          % auc)
    text = booster.model_to_string()
    again = train_run(lgb, x, y, xt, yt, EXPO_PARAMS, EXPO_ROUNDS,
                      data=(ds, valid))[0]
    check(again.model_to_string() == text,
          "two categorical runs gave different model texts")
    del again
    clf = lgb.LGBMClassifier(
        n_estimators=EXPO_ROUNDS, num_leaves=EXPO_PARAMS["num_leaves"],
        learning_rate=EXPO_PARAMS["learning_rate"],
        max_bin=EXPO_PARAMS["max_bin"],
        min_child_samples=EXPO_PARAMS["min_data_in_leaf"],
        min_child_weight=EXPO_PARAMS["min_sum_hessian_in_leaf"])
    clf.fit(x, y, categorical_feature=EXPO_CATS)
    check(clf.booster_.device.type == "cuda", "LGBMClassifier trained on "
          "%s" % clf.booster_.device)
    check(clf.booster_.model_to_string() == text,
          "LGBMClassifier.fit(categorical_feature=) gave another model text "
          "than train")
    del clf
    cat_nodes = sum(t.is_categorical_node(i) for t in booster._inner.models
                    for i in range(t.num_leaves - 1))
    print("categorical main path: %d rounds, %d trees of %s leaves, %d "
          "categorical nodes, valid auc %s; a second run and "
          "LGBMClassifier.fit(categorical_feature=%s) byte-identical (%d "
          "bytes)" % (EXPO_ROUNDS, booster.num_trees(),
                      sorted({t.num_leaves for t in booster._inner.models}),
                      cat_nodes, " ".join("%.5f" % a for a in auc),
                      EXPO_CATS, len(text)))
    t0 = time.perf_counter()
    gate = lgb.train(dict(EXPO_PARAMS), ds, EXPO_GATE_ROUNDS)
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = gate.predict(xt, raw_score=True)
    predict_s = time.perf_counter() - t0
    test_auc = float(rank_auc(yt, raw))
    check(gate.num_trees() == EXPO_GATE_ROUNDS and np.isfinite(raw).all()
          and abs(test_auc - EXPO_REF_AUC) <= EXPO_AUC_GATE,
          "categorical %d rounds: test AUC %.6f, outside %.6f +- %g"
          % (EXPO_GATE_ROUNDS, test_auc, EXPO_REF_AUC, EXPO_AUC_GATE))
    print("categorical gate [%s | %s]: %d rounds in %.1f s, test AUC "
          "%.6f on %d rows (predict %.2f s): reference LightGBM %.6f "
          "(delta %+.6f, gate +-%g), the JAX package %.6f "
          "(ACCURACY_r05.json)" % (name, card, EXPO_GATE_ROUNDS, gate_s,
                                   test_auc, EXPO_TEST_ROWS, predict_s,
                                   EXPO_REF_AUC, test_auc - EXPO_REF_AUC,
                                   EXPO_AUC_GATE, EXPO_JAX_AUC))
    del gate, raw

    # --------------------------------------------------------------- 36
    trees = booster._inner.models
    check(trees[0].num_cat > 0, "no categorical feature won a split in the "
          "first tree")
    fresh = lgb.Booster(dict(EXPO_PARAMS), train_set=ds)
    gb = fresh._inner
    grower = gb._grower
    binned = gb._binned
    nb, fb = grower.num_bins, grower.feature_bins
    fmeta, prm = grower.fmeta_dev, grower.params
    check(fmeta.categorical, "the grower's feature metadata is not "
          "categorical")
    n = binned.shape[0]
    mask = torch.ones(inner.num_features, dtype=torch.uint8, device=dev)
    grad, hess = gb.objective.get_gradients(gb._score[0])
    w1 = torch.stack([grad, hess, torch.ones_like(grad)], 1).contiguous()
    del grad, hess
    h_root = H(binned, w1, nb, bf16=True)
    acc = leaf_totals(h_root)
    sums = torch.from_numpy(acc[None]).to(dev)
    depth0 = torch.zeros(1, dtype=torch.int32, device=dev)
    s_root = S(h_root[None], sums, depth0, fmeta, mask, prm, fb)
    for got in (S(h_root[None], sums, depth0, fmeta, mask, prm, fb),
                split.split_scan_plain(h_root[None], sums, depth0, fmeta,
                                       mask, prm, fb)):
        check(all(torch.equal(a, b) for a, b in zip(s_root, got)),
              "S (categorical) root: not bitwise its repeat and plain "
              "version")
    out_f = s_root[0][0].cpu().numpy()
    out_i = s_root[1][0].cpu().numpy()
    fm = grower.fmeta

    def rule_of(feat, thr, default_left, is_cat):
        return route.SplitRule(
            int(fm["group"][feat]), int(fm["offset"][feat]),
            int(fm["num_bin"][feat]), int(fm["default_bin"][feat]),
            int(fm["missing_type"][feat]), bool(fm["is_bundled"][feat]),
            int(thr), bool(default_left), bool(is_cat), 0, 1)

    perm0 = torch.arange(n, dtype=torch.int32, device=dev)
    lid0 = torch.zeros(n, dtype=torch.int32, device=dev)

    def held_route(rule, label):
        res = []
        for fn in (R, R, route.route_partition_plain):
            perm, lid = perm0.clone(), lid0.clone()
            res.append((perm, lid, int(fn(binned, perm, 0, n, rule, lid))))
        check(all(torch.equal(res[0][0], r[0]) and torch.equal(res[0][1], r[1])
                  and res[0][2] == r[2] for r in res[1:]),
              "R (%s): partition or leaf ids differ between launches or "
              "from plain" % label)
        return res[0]

    perm, _, n_left = held_route(
        rule_of(int(out_i[0]), out_i[1], out_i[2], out_i[3]), "root split")
    check(n_left == int(round(float(out_f[3]))),
          "R sent %d rows left at the root, the scan counted %s"
          % (n_left, out_f[3]))
    small_left = np.float32(out_f[3]) * np.float32(2.0) <= acc[2]
    b0, cnt = (0, n_left) if small_left else (n_left, n - n_left)
    small = 0 if small_left else 1
    h_small = H(binned, w1, nb, rows=perm[b0:], n_rows=cnt, bf16=True)
    pair = torch.empty((2,) + tuple(h_root.shape), device=dev)
    pair[small] = h_small
    pair[1 - small] = histogram.subtract(h_root, h_small)
    left = out_f[1:4].astype(np.float32)
    csums = torch.from_numpy(np.stack([left, acc - left])).to(dev)
    depth1 = torch.ones(2, dtype=torch.int32, device=dev)
    s_kids = S(pair, csums, depth1, fmeta, mask, prm, fb)
    for got in (S(pair, csums, depth1, fmeta, mask, prm, fb),
                split.split_scan_plain(pair, csums, depth1, fmeta, mask, prm,
                                       fb)):
        check(all(torch.equal(a, b) for a, b in zip(s_kids, got)),
              "S (categorical) children: not bitwise its repeat and plain "
              "version")
    s_cases("categorical", pair, csums, fmeta, prm, fb, dev)
    # R on the first tree's first categorical split, over every row
    tree0 = trees[0]
    node = next(i for i in range(tree0.num_leaves - 1)
                if tree0.is_categorical_node(i))
    feat = int(tree0.split_feature_inner[node])
    cat_rule = rule_of(feat, single_bin(tree0, node),
                       tree0.default_left_node(node), True)
    cat_perm, cat_lid, cat_left = held_route(cat_rule, "categorical split")
    col = histogram.take_bins(binned[:, cat_rule.group].contiguous())
    check(cat_left == int((col == cat_rule.threshold).sum()),
          "R (categorical split): %d rows left, not the rows of bin %d"
          % (cat_left, cat_rule.threshold))
    del cat_perm, cat_lid, col
    hold_route("Expo categorical split", binned, cat_rule)
    # W on the first tree with its categorical nodes, over the test rows
    bt = predict.binned_tree(tree0, dev)
    vb = booster._inner._valid_binned[0]
    check(bt.categorical, "W's tree has no categorical node")
    walked, leaves = [], []
    for fn in (W, W, predict.tree_value_walk_binned_plain):
        sc = torch.zeros(EXPO_TEST_ROWS, dtype=torch.float32, device=dev)
        fn(bt, vb, sc)
        walked.append(sc)
    for fn in (predict.tree_leaf_walk_binned, predict.tree_leaf_walk_binned,
               predict.tree_leaf_walk_binned_plain):
        leaves.append(fn(bt, vb))
    check(all(bitwise(walked[0], s) for s in walked[1:])
          and all(torch.equal(leaves[0], v) for v in leaves[1:]),
          "W (categorical; value or leaf mode) differs between launches or "
          "from plain")
    # K1 serving the saved model
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    model_path = str(OUT_DIR / "expo_model.txt")
    booster.save_model(model_path)
    predict.forest_value_walk.launches = 0
    served = lgb.Booster(model_file=model_path)
    served_raw = served.predict(xt, raw_score=True)
    kept = booster._inner.valid_score(0)
    rel = float(np.max(np.abs(served_raw - kept)
                       / np.maximum(1.0, np.abs(kept))))
    check(served.device.type == "cuda"
          and predict.forest_value_walk.launches > 0 and rel <= 1e-5,
          "the saved categorical model through K1: off W's scores by %g"
          % rel)
    print("categorical kernels vs plain [Expo, %d rows x %d groups, B %d]: "
          "S bitwise on the root (split on feature %d, %s) and its "
          "children; R exact on the root split and on tree 0's categorical "
          "node %d (feature %d, bin %d: %d rows left); W value and leaf "
          "modes exact on %d test rows (%d categorical nodes in tree 0); K1 "
          "on the saved model within %.3g of W's scores"
          % (n, binned.shape[1], nb, int(out_i[0]),
             "categorical" if out_i[3] else "numeric", node, feat,
             cat_rule.threshold, cat_left, EXPO_TEST_ROWS, tree0.num_cat,
             rel))

    # --------------------------------------------------------------- 38
    cparams = dict(EXPO_PARAMS, num_leaves=CPU_LEAVES)
    t0 = time.perf_counter()
    cx, cy = x[:CPU_ROWS], y[:CPU_ROWS]
    cxt, cyt = xt[:CPU_VALID_ROWS], yt[:CPU_VALID_ROWS]
    on_card, ev_card, _, cds, cvalid = train_run(lgb, cx, cy, cxt, cyt,
                                                 cparams, CPU_ROUNDS)
    on_cpu, ev_cpu = train_run(lgb, cx, cy, cxt, cyt, cparams, CPU_ROUNDS,
                               device="cpu", data=(cds, cvalid))[:2]
    worst = same_trees(on_card, on_cpu, CPU_ROUNDS)
    d_auc = abs(ev_card["valid"]["auc"][-1] - ev_cpu["valid"]["auc"][-1])
    check(d_auc <= 2e-3, "categorical card/CPU AUC differ by %g" % d_auc)
    print("card vs CPU [categorical, %d rows, %d leaves, %d rounds]: same "
          "trees (%d categorical nodes), leaf values within %.3g relative, "
          "valid auc %.5f vs %.5f (%.1f s)"
          % (CPU_ROWS, CPU_LEAVES, CPU_ROUNDS,
             sum(t.num_cat for t in on_card._inner.models), worst,
             ev_card["valid"]["auc"][-1], ev_cpu["valid"]["auc"][-1],
             time.perf_counter() - t0))
    del on_card, on_cpu, cds, cvalid
    fx, fy = x[:EXPO_FILE_ROWS], y[:EXPO_FILE_ROWS]
    tsv = str(OUT_DIR / "expo.tsv")
    write_tsv(tsv, fx, fy)
    file_params = {k: v for k, v in EXPO_PARAMS.items()
                   if k != "categorical_feature"}
    file_params["categorical_column"] = ",".join(map(str, EXPO_CATS))
    t0 = time.perf_counter()
    from_file = lgb.Dataset(tsv, params=dict(file_params)).construct()
    file_s = time.perf_counter() - t0
    arr = lgb.Dataset(fx, fy, params=dict(EXPO_PARAMS)).construct()
    check(np.array_equal(from_file._inner.binned, arr._inner.binned)
          and [j for j in range(from_file._inner.num_features)
               if from_file._inner.feature_mapper(j).bin_type
               == BIN_CATEGORICAL] == EXPO_CATS,
          "Dataset(path, categorical_column=...) differs from the array "
          "Dataset")
    texts = [lgb.train(dict(EXPO_PARAMS), d, EXPO_FILE_ROUNDS)
             .model_to_string() for d in (arr, from_file)]
    check(texts[0] == texts[1] and "num_cat=" in texts[0],
          "the categorical file's model text differs from the array's")
    os.remove(tsv)
    print("files [%d Expo rows as TSV]: Dataset(path, params="
          "{categorical_column: %r}) %.1f s, bitwise the array Dataset's "
          "matrix, %d rounds give its model text"
          % (EXPO_FILE_ROWS, file_params["categorical_column"], file_s,
             EXPO_FILE_ROUNDS))
    return {"booster": booster, "update_s": update_s, "launches": launches,
            "gate_s": gate_s, "binned": binned, "pair": pair,
            "csums": csums, "depth1": depth1, "mask": mask, "fmeta": fmeta,
            "prm": prm, "fb": fb, "cat_rule": cat_rule, "bt": bt, "vb": vb,
            "perm0": perm0, "lid0": lid0, "tree0": tree0,
            "leaves": leaves[0]}


# ---------------------------------------------------------------------
# quantized training and leaf moments on uint16 bins (phases 39-41)
U16Q_ROUNDS, U16Q_WIDE_ROUNDS = 10, 3


def uint16_quant(name, card, dev, ctx):
    """Phases 40 and 39 on phase 31's Bosch Datasets and phase 34's
    max_bin=1023 ones; returns what phase 41 times."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.linear import leaf_feature_moments
    from lightgbm_tpu_torch.ops import histogram, predict, rng, route, split

    HQ, H = histogram.leaf_histogram_i32, histogram.leaf_histogram
    LM = histogram.leaf_moments
    counted = {"bagging_mask": rng.bagging_mask,
               "quantize_gradients": histogram.quantize_gradients,
               "leaf_histogram_i32": HQ, "leaf_histogram": H,
               "split_scan": split.split_scan,
               "route_partition": route.route_partition,
               "score_update": route.score_update,
               "tree_value_walk_binned": predict.tree_value_walk_binned,
               "tree_leaf_walk_binned": predict.tree_leaf_walk_binned,
               "leaf_moments": LM}

    def reset():
        for fn in counted.values():
            fn.launches = 0
        HQ.launches_u16 = H.launches_u16 = LM.launches_u16 = 0

    def read():
        out = {k: fn.launches for k, fn in counted.items()}
        out.update(HQ_u16=HQ.launches_u16, H_u16=H.launches_u16,
                   LM_u16=LM.launches_u16)
        return out

    bo = ctx["bosch"]
    x, y, xv, yv = bo["x"], bo["y"], bo["xv"], bo["yv"]
    leaves = TRAIN_PARAMS["num_leaves"]

    def path(label, params, rounds, data):
        """One run with every count set to 0 before it: HQ on uint16
        bins once a split, H only for the quantize gate's f32 tree, Q
        once a round and once for the gate."""
        reset()
        booster, evals, update_s = train_run(lgb, x, y, xv, yv, params,
                                             rounds, data=data)[:3]
        launches = read()
        gb = booster._inner
        trees = gb.models
        gq, gf = gb.quant_gate_leaves
        print("%s path launches: %s" % (label, launches))
        check(booster.device.type == "cuda" and len(trees) == rounds
              and gb._binned.dtype == torch.uint16,
              label + ": %d trees on %s, %s bins" % (len(trees), booster.device,
                                                     gb._binned.dtype))
        check(launches["quantize_gradients"] == rounds + 1,
              label + ": Q launched %d times" % launches["quantize_gradients"])
        want = hist_launches(trees, leaves) + gq - (gq == 31)
        check(launches["leaf_histogram_i32"] == launches["HQ_u16"] == want,
              label + ": HQ launched %d times (%d on uint16 bins), not once a "
              "split (%d)" % (launches["leaf_histogram_i32"],
                              launches["HQ_u16"], want))
        check(launches["leaf_histogram"] == launches["H_u16"]
              == gf - (gf == 31),
              label + ": H launched %d times beyond the gate's f32 tree"
              % launches["leaf_histogram"])
        for k in ("split_scan", "route_partition", "tree_value_walk_binned"):
            check(launches[k] > 0, label + ": %s never launched" % k)
        check(gb.quant_gate_delta <= 0.5, label + ": gate delta %g"
              % gb.quant_gate_delta)
        auc = evals["valid"]["auc"]
        check(np.isfinite(auc).all() and auc[-1] > auc[0],
              label + ": valid AUC %s did not rise" % auc)
        med = float(np.median(update_s[1:])) if rounds > 1 else update_s[0]
        print("%s path: qmax %d, gate delta %.4g (trees of %d and %d "
              "leaves), valid auc %.5f (round 1) -> %.5f, trees of %s leaves"
              % (label, gb._quant_qmax, gb.quant_gate_delta, gq, gf, auc[0],
                 auc[-1], sorted({t.num_leaves for t in trees})))
        print("time [%s | %s]: %s boosting round %.4f s (median of rounds "
              "2-%d), rounds %s" % (name, card, label, med, rounds,
                                     " ".join("%.4f" % v for v in update_s)))
        return booster, auc, med, launches

    # --------------------------------------------------------------- 40
    bdata = bo["data"]
    int8 = dict(BOSCH_PARAMS, tpu_hist_quantize="int8")
    b8, auc8, med8, l8 = path("bosch int8", int8, U16Q_ROUNDS, bdata)
    check(l8["bagging_mask"] == 0, "bosch int8: M launched without bagging")
    text8 = b8.model_to_string()
    check(train_run(lgb, x, y, xv, yv, int8, U16Q_ROUNDS, data=bdata)[0]
          .model_to_string() == text8,
          "two Bosch int8 runs gave different model texts")
    b16, auc16, med16, l16 = path("bosch int16",
                                  dict(BOSCH_PARAMS, tpu_hist_quantize="int16"),
                                  U16Q_ROUNDS, bdata)
    bb, aucb, medb, lb = path("bosch int8 + bagging",
                              dict(int8, bagging_fraction=0.8, bagging_freq=1),
                              U16Q_ROUNDS, bdata)
    check(lb["bagging_mask"] == U16Q_ROUNDS, "bosch bagging: M launched %d "
          "times" % lb["bagging_mask"])
    del bb
    for label, auc in (("int8", auc8), ("int16", auc16),
                       ("int8 + bagging", aucb)):
        check(abs(auc[-1] - bo["auc"][-1]) <= 0.02,
              "bosch %s: valid AUC %.5f vs %.5f in f32 (phase 31)"
              % (label, auc[-1], bo["auc"][-1]))
    print("bosch quantized paths: a second int8 run byte-identical (%d "
          "bytes); valid auc int8 %.5f, int16 %.5f, int8 + bagging %.5f "
          "against phase 31's %.5f" % (len(text8), auc8[-1], auc16[-1],
                                        aucb[-1], bo["auc"][-1]))
    wds, wvalid = bo["wide_data"]
    hx, hy, hxv, hyv = ctx["x"], ctx["y"], ctx["xv"], ctx["yv"]
    wparams = dict(TRAIN_PARAMS, max_bin=WIDE_MAX_BIN)
    reset()
    bw8, evw = train_run(lgb, hx, hy, hxv, hyv,
                         dict(wparams, tpu_hist_quantize="int8"),
                         U16Q_WIDE_ROUNDS, data=(wds, wvalid))[:2]
    lw = read()
    check(lw["leaf_histogram_i32"] == lw["HQ_u16"] > 0
          and lw["split_scan"] > 0 and np.isfinite(evw["valid"]["auc"]).all(),
          "max_bin=%d int8: %s" % (WIDE_MAX_BIN, lw))
    print("max_bin=%d int8 path: %d rounds, HQ %d launches on uint16 bins, "
          "valid auc %.5f" % (WIDE_MAX_BIN, U16Q_WIDE_ROUNDS, lw["HQ_u16"],
                              evw["valid"]["auc"][-1]))
    reset()
    lin = train_run(lgb, hx, hy, hxv, hyv,
                    dict(wparams, linear_tree=True, linear_lambda=0.01,
                         tpu_linear_max_features=5),
                    U16Q_WIDE_ROUNDS, data=(wds, wvalid))[0]
    gbt = lin._inner
    last = gbt.models[-1]
    check(last.is_linear and gbt._binned.dtype == torch.uint16,
          "max_bin=%d linear trees: not linear on uint16 bins" % WIDE_MAX_BIN)
    leaf_of = predict.tree_leaf_walk_binned(
        predict.binned_tree(last, dev), gbt._binned).to(torch.int32)
    g_l, h_l = gbt.objective.get_gradients(gbt._score[0])
    w_l = torch.stack([g_l, h_l, torch.ones_like(g_l)], 1).contiguous()
    del g_l, h_l
    lm_ids = list(range(last.num_leaves))
    nbw = gbt._grower.num_bins
    moments = leaf_feature_moments(gbt._binned, gbt._raw, w_l, leaf_of,
                                   lm_ids, nbw)
    ll = read()
    check(ll["LM_u16"] == ll["leaf_moments"] > 0
          and bool(torch.isfinite(moments).all())
          and tuple(moments.shape) == (last.num_leaves, FEATURES, 4),
          "leaf_feature_moments on uint16 bins: %s, shape %s"
          % (ll, tuple(moments.shape)))
    total = moments[:, :, 0].sum(0).double()
    check(bool(((total - gbt._raw.double().sum(0)).abs()
                <= 1e-4 * gbt._raw.double().abs().sum(0)).all()),
          "leaf_feature_moments on uint16 bins: the leaves' sum w x is not "
          "the column sum")
    print("max_bin=%d linear trees: %d rounds on uint16 bins (%s); "
          "leaf_feature_moments of the last tree's %d leaves x %d features "
          "at %d bins (LM %d launches on uint16 bins)"
          % (WIDE_MAX_BIN, U16Q_WIDE_ROUNDS,
             {k: ll[k] for k in ("leaf_histogram", "tree_leaf_walk_binned",
                                 "leaf_moments")}, last.num_leaves,
             FEATURES, nbw, ll["LM_u16"]))
    cds, cvalid = bo["cpu_data"]
    cx, cy = x[:BOSCH_CPU_ROWS], y[:BOSCH_CPU_ROWS]
    cxv, cyv = xv[:BOSCH_CPU_VALID_ROWS], yv[:BOSCH_CPU_VALID_ROWS]
    for mode in ("int8", "int16"):
        cparams = dict(BOSCH_PARAMS, num_leaves=BOSCH_CPU_LEAVES,
                       tpu_hist_quantize=mode)
        t0 = time.perf_counter()
        on_card, ev_card = train_run(lgb, cx, cy, cxv, cyv, cparams,
                                     BOSCH_CPU_ROUNDS, data=(cds, cvalid))[:2]
        on_cpu, ev_cpu = train_run(lgb, cx, cy, cxv, cyv, cparams,
                                   BOSCH_CPU_ROUNDS, device="cpu",
                                   data=(cds, cvalid))[:2]
        worst = same_trees(on_card, on_cpu, BOSCH_CPU_ROUNDS)
        d_auc = abs(ev_card["valid"]["auc"][-1] - ev_cpu["valid"]["auc"][-1])
        check(d_auc <= 2e-3, "Bosch %s card/CPU AUC differ by %g"
              % (mode, d_auc))
        print("card vs CPU [Bosch %s, %d rows, %d leaves, %d rounds]: same "
              "trees, leaf values within %.3g relative, valid auc %.5f vs "
              "%.5f (%.1f s)" % (mode, BOSCH_CPU_ROWS, BOSCH_CPU_LEAVES,
                                 BOSCH_CPU_ROUNDS, worst,
                                 ev_card["valid"]["auc"][-1],
                                 ev_cpu["valid"]["auc"][-1],
                                 time.perf_counter() - t0))
    del on_card, on_cpu

    # --------------------------------------------------------------- 39
    ds = bdata[0]
    gb8 = b8._inner
    binned, nb = gb8._binned, gb8._grower.num_bins
    n = binned.shape[0]
    lay = gb8._grower.hq_plan
    fresh = lgb.Booster(dict(int8), train_set=ds)._inner
    g1, h1 = fresh.objective.get_gradients(fresh._score[0])
    g10, h10 = gb8.objective.get_gradients(gb8._score[0])
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    codes = {}
    for mode, gbm in (("int8", gb8), ("int16", b16._inner)):
        qmax = gbm._quant_qmax
        codes[(mode, 1)] = gbm._quantize(g1, h1, ones, 0, n, qmax,
                                         reciprocal_scale=True)
        codes[(mode, 10)] = gbm._quantize(g10, h10, ones, U16Q_ROUNDS - 1, n,
                                          qmax, reciprocal_scale=True)
    del g1, h1, g10, h10, fresh
    # the first tree's root split, routed by R: its smaller child's rows
    t0_ = b8._inner.models[0]
    fm = gb8._grower.fmeta
    f0 = int(t0_.split_feature_inner[0])
    rule = route.SplitRule(
        int(fm["group"][f0]), int(fm["offset"][f0]), int(fm["num_bin"][f0]),
        int(fm["default_bin"][f0]), int(fm["missing_type"][f0]),
        bool(fm["is_bundled"][f0]),
        single_bin(t0_, 0) if t0_.is_categorical_node(0)
        else int(t0_.threshold_in_bin[0]), t0_.default_left_node(0),
        t0_.is_categorical_node(0), 0, 1)
    perm = torch.arange(n, dtype=torch.int32, device=dev)
    n_left = int(route.route_partition(binned, perm, 0, n, rule,
                                       torch.zeros(n, dtype=torch.int32,
                                                   device=dev)))
    b0, cnt = (0, n_left) if 2 * n_left <= n else (n_left, n - n_left)
    rnd = torch.from_numpy(np.random.RandomState(3).choice(
        n, n // 4, replace=False).astype(np.int32)).to(dev)

    def held_hq(b, q, width, plan, rows=None, count=None, label=""):
        got = HQ(b, q.codes, q.w01, width, rows=rows, n_rows=count,
                 plan=plan)
        check(torch.equal(got, HQ(b, q.codes, q.w01, width, rows=rows,
                                  n_rows=count, plan=plan)),
              "HQ %s: a second launch gave other bits" % label)
        check(torch.equal(got, histogram.leaf_histogram_i32_plain(
            b, q.codes, q.w01, width, rows, count)),
              "HQ %s: not equal to its plain version" % label)
        return got

    checked = []
    for (mode, rnd_i), q in codes.items():
        held_hq(binned, q, nb, lay, label="u16 %s round-%d root"
                % (mode, rnd_i))
        checked.append("%s round %d" % (mode, rnd_i))
        if rnd_i == 10:
            held_hq(binned, q, nb, lay, perm[b0:], cnt,
                    "u16 %s smaller child (%d rows)" % (mode, cnt))
            held_hq(binned, q, nb, lay, rnd, len(rnd),
                    "u16 %s random quarter" % mode)
    gw = bw8._inner
    qw = gw._quantize(*gw.objective.get_gradients(gw._score[0]),
                      torch.ones(gw._n, dtype=torch.float32, device=dev), 0,
                      gw._n, gw._quant_qmax, reciprocal_scale=True)
    held_hq(gw._binned, qw, gw._grower.num_bins, gw._grower.hq_plan,
            label="u16 max_bin=%d root" % WIDE_MAX_BIN)
    # the cases HQ's row blocks and skipped bins could get wrong, on the
    # Bosch matrix (round-10 int8 codes)
    empty_u16 = hq_cases("u16 Bosch", binned, codes[("int8", 10)], nb, lay,
                         dev)
    hb = torch.from_numpy(np.ascontiguousarray(
        ctx["data"][0]._inner.binned)).to(dev)
    nb8 = int(ctx["data"][0]._inner.max_num_bin())
    hn = hb.shape[0]
    gen = np.random.RandomState(39)
    q8 = histogram.quantize_gradients(
        torch.from_numpy(gen.randn(hn).astype(np.float32)).to(dev),
        torch.from_numpy((gen.rand(hn) * 0.25 + 1e-3).astype(np.float32)
                         ).to(dev),
        torch.from_numpy((gen.rand(hn) < 0.8).astype(np.float32)).to(dev),
        qmax=histogram.train_qmax("int8", hn), key_g=rng.prng_key(1),
        key_h=rng.prng_key(2), reciprocal_scale=True)
    HQ.launches_u16 = 0
    plan8 = histogram.i32_plan(hb, nb8)
    held_hq(hb, q8, nb8, plan8, label="uint8 HIGGS root")
    empty_u8 = hq_cases("uint8 HIGGS", hb, q8, nb8, plan8, dev)
    check(HQ.launches_u16 == 0, "HQ on the uint8 matrix ran its uint16 mode")
    # LM at max_bin=1023 on the last linear tree's leaves (the main path's
    # call), and on uint8 bins at the HIGGS shape
    lm_err = {}
    ids_w = torch.tensor(lm_ids, dtype=torch.int32, device=dev)
    raw8 = torch.from_numpy(np.ascontiguousarray(ctx["x"])).to(dev)
    inner8 = ctx["data"][0]._inner
    check(inner8.num_features == FEATURES and not inner8.groups.is_bundled.any(),
          "the HIGGS matrix is not one feature a group")
    b9 = lgb.Booster(model_str=ctx["text"])._inner.models[-1]
    lid8 = predict.tree_leaf_walk_binned(predict.binned_tree(b9, dev),
                                         hb).to(torch.int32)
    w8 = torch.from_numpy(np.stack([gen.randn(hn), gen.rand(hn) + 0.1,
                                    (gen.rand(hn) < 0.9) * 1.0], 1).astype(
        np.float32)).to(dev)
    w8[:, :2] *= w8[:, 2:]
    ids8 = torch.arange(b9.num_leaves, dtype=torch.int32, device=dev)
    for label, args in (
            ("u16", (gbt._binned, gbt._raw, w_l, nbw, leaf_of, ids_w)),
            ("u8", (hb, raw8, w8, nb8, lid8, ids8))):
        got, lm_err[label] = hold_lm(label, args)
        if label == "u16":
            check(torch.equal(moments, got.sum(dim=2)),
                  "leaf_feature_moments is not LM u16 summed over bins")
        del got
    LM.launches_u16 = 0
    for label, args in lm_cases(dev, nbw, 40).items():
        case, err = hold_lm("u16 " + label, args)
        lm_err["u16"] = max(lm_err["u16"], err)
        check(args[5].shape[0] == 1 or not bool(case[-1].any()),
              "LM u16 (%s): the id of no rows is not 0" % label)
        del case
    check(LM.launches_u16 > 0, "LM's seeded uint16 cases ran no uint16 LM")
    print("HQ cases: exact and repeating at the root, on a 1,000-row list "
          "and both with a fifth of w01 at 0, and under plans whose skipped "
          "bins hold no row (%d Bosch groups, %d uint8 HIGGS groups on the "
          "list)" % (empty_u16, empty_u8))
    print("uint16 HQ and LM vs plain: HQ exact and repeating at the Bosch "
          "root (%s), on the root split's smaller child (%d rows) and a "
          "random quarter in random order (round-10 codes, int8 and "
          "int16), at the max_bin=%d root, and on the uint8 HIGGS root; LM "
          "u16 (%d ids x %d features x %d bins; %d x 70 seeded rows of 16 "
          "ids, one of no rows, and one id over all rows) and LM uint8 (%d "
          "ids) within 1e-5 of plain and the f64 oracle (max abs err %.3g, "
          "%.3g), bitwise their replays, repeats equal"
          % (", ".join(checked), cnt, WIDE_MAX_BIN, len(lm_ids), FEATURES,
             nbw, WIDE_ROWS, b9.num_leaves, lm_err["u16"], lm_err["u8"]))
    return {"b8": b8, "med8": med8, "med16": med16, "medb": medb,
            "round_s": bo["round_s"], "lm_u8": (raw8, w8, nb8, lid8, ids8),
            "launches": l8, "lm_launches": ll, "binned": binned, "nb": nb,
            "plan": lay, "q10": codes[("int8", 10)], "perm": perm,
            "b0": b0, "cnt": cnt, "wide": (gw._binned, qw,
                                           gw._grower.num_bins,
                                           gw._grower.hq_plan),
            "u8": (hb, q8, nb8, plan8), "lm_u16": (gbt._binned, gbt._raw, w_l, nbw,
                                            leaf_of, ids_w),
            "lm_err": lm_err}


def times_41(name, card, dev, cat, q):
    """Phase 41: HQ u16, LM u16 and the categorical variants of S, R and
    W against their bounds, plain versions and library calls; the round
    times; returns the JSON rows of the five modes."""
    from lightgbm_tpu_torch.ops import histogram, predict, route, split
    HQ, LM = histogram.leaf_histogram_i32, histogram.leaf_moments
    print("clocks [%s]: SM clock, max SM clock: %s (before the timings)"
          % (card, clocks()))
    times = {}

    def hq_library(b, qc, width):
        """torch.bincount x3 over group x B + bin, the codes as weights."""
        g_cnt = b.shape[1]
        flat = ((torch.arange(g_cnt, device=dev) * width)[None]
                + histogram.take_bins(b)).reshape(-1)
        live = (qc.w01 > 0).float()
        chans = [(qc.codes[:, c].float() * live)[:, None].expand(
            -1, g_cnt).reshape(-1) for c in (0, 1)]
        chans.append(live[:, None].expand(-1, g_cnt).reshape(-1))

        def run():
            for ch in chans:
                torch.bincount(flat, weights=ch, minlength=g_cnt * width)
        return median_ms(run, reps=3)

    def hq_bound(rows, g_cnt, width, row_list=False):
        return bound(rows * (2 * g_cnt + 8 + (4 if row_list else 0))
                     + g_cnt * width * 12, 3.0 * rows * g_cnt)

    binned, nb, lay, q10 = q["binned"], q["nb"], q["plan"], q["q10"]
    n, g_cnt = binned.shape
    times["leaf_histogram_i32_u16"] = (
        graph_ms(lambda: HQ(binned, q10.codes, q10.w01, nb, plan=lay)),
        median_ms(lambda: histogram.leaf_histogram_i32_plain(
            binned, q10.codes, q10.w01, nb), reps=3),
        hq_bound(n, g_cnt, nb), hq_library(binned, q10, nb))
    perm, b0, cnt = q["perm"], q["b0"], q["cnt"]
    list_ms = graph_ms(lambda: HQ(binned, q10.codes, q10.w01, nb,
                                  rows=perm[b0:], n_rows=cnt, plan=lay))
    list_bound = hq_bound(cnt, g_cnt, nb, True)
    wb, wq, wnb, wlay = q["wide"]
    wn, wg = wb.shape
    wide_ms = graph_ms(lambda: HQ(wb, wq.codes, wq.w01, wnb, plan=wlay))
    wide_bound = hq_bound(wn, wg, wnb)
    hb, q8, nb8, plan8 = q["u8"]
    u8_ms = graph_ms(lambda: HQ(hb, q8.codes, q8.w01, nb8, plan=plan8))
    u8_bound = hq_bound(hb.shape[0], hb.shape[1], nb8)
    ms, plain_ms, (b_ms, b_by), lib_ms = times["leaf_histogram_i32_u16"]
    print("time [%s | %s]: leaf_histogram_i32_u16 at the Bosch root (%d rows "
          "x %d groups, B %d, %d slices) %.4f ms, plain %.2f ms, bound %.5f "
          "ms (%s), torch.bincount x3 %.3f ms; row list (%d rows) %.4f ms, "
          "bound %.5f; max_bin=%d root (%d x %d, B %d) %.4f ms, bound %.5f; "
          "HQ on the uint8 HIGGS root (%d x %d) %.4f ms, bound %.5f"
          % (name, card, n, g_cnt, nb, len(lay.slices), ms, plain_ms,
             b_ms, b_by, lib_ms, cnt, list_ms, list_bound[0], WIDE_MAX_BIN,
             wn, wg, wnb, wide_ms, wide_bound[0], hb.shape[0], hb.shape[1],
             u8_ms, u8_bound[0]))
    lm16 = lm_timing(q["lm_u16"])
    # the JSON row keeps the one-call yardstick
    times["leaf_moments_u16"] = (lm16["device"], lm16["plain"],
                                 lm16["bound"], lm16["index_add"])
    lm8 = lm_timing((hb,) + q["lm_u8"])
    for label, t in (
            ("leaf_moments_u16 at max_bin=%d (%d ids)" % (
                WIDE_MAX_BIN, q["lm_u16"][5].shape[0]), lm16),
            ("leaf_moments on uint8 HIGGS bins (%d ids)"
             % q["lm_u8"][4].shape[0], lm8)):
        print("time [%s | %s]: %s device %.4f ms (CUDA graph), "
              "leaf_feature_moments %.4f ms (CUDA events; graph %.4f ms), "
              "host %.1f us, plain %.2f ms, bound %.5f ms (%s), "
              "torch.bincount x4 %.3f ms, one index_add_ %.3f ms"
              % (name, card, label, t["device"], t["call"], t["call_graph"],
                 t["host_us"], t["plain"], t["bound"][0], t["bound"][1],
                 t["bincount4"], t["index_add"]))
    # the categorical variants on the Expo main path's inputs
    pair, csums, depth1 = cat["pair"], cat["csums"], cat["depth1"]
    fmeta, mask, prm, fb = cat["fmeta"], cat["mask"], cat["prm"], cat["fb"]
    cb = cat["binned"]
    cn = cb.shape[0]
    f_cnt = fmeta["num_bin"].shape[0]
    times["split_scan_cat"] = (
        graph_ms(lambda: split.split_scan(pair, csums, depth1, fmeta, mask,
                                          prm, fb)),
        median_ms(lambda: split.split_scan_plain(pair, csums, depth1, fmeta,
                                                mask, prm, fb), reps=3),
        bound(pair.numel() * 4 + 64, 2 * f_cnt * fb * 50), None)
    rperm, rlid = cat["perm0"].clone(), cat["lid0"].clone()
    rule = cat["cat_rule"]
    times["route_partition_cat"] = (
        route_times("Expo, a categorical split", cb, rule, name, card),
        median_ms(lambda: route.route_partition_plain(cb, rperm, 0, cn, rule,
                                                     rlid), reps=3),
        bound(13 * cn), None)
    bt, vb = cat["bt"], cat["vb"]
    depth = torch.from_numpy(leaf_depths([cat["tree0"]])[0]).to(dev)
    visits = int(depth[cat["leaves"].long()].sum())
    sc = torch.zeros(vb.shape[0], dtype=torch.float32, device=dev)
    times["tree_value_walk_binned_cat"] = (
        graph_ms(lambda: predict.tree_value_walk_binned(bt, vb, sc),
                 calls=SHORT_CALLS),
        median_ms(lambda: predict.tree_value_walk_binned_plain(bt, vb, sc),
                  reps=3),
        bound(visits + 8 * vb.shape[0] + tree_bytes(bt),
              visits * INSTR_PER_VISIT), None)
    for k in ("split_scan_cat", "route_partition_cat",
              "tree_value_walk_binned_cat"):
        ms, plain_ms, (b_ms, b_by), _ = times[k]
        print("time [%s | %s]: %s %.4f ms, plain %.3f ms, bound %.5f ms (%s)"
              % (name, card, k, ms, plain_ms, b_ms, b_by))
    cat_med = float(np.median(cat["update_s"][1:EXPO_ROUNDS]))
    print("time [%s | %s]: categorical boosting round %.4f s (median of "
          "rounds 2-%d), %.3f million row-iterations/s, rounds %s; %d rounds "
          "%.1f s wall" % (name, card, cat_med, EXPO_ROUNDS,
                           EXPO_ROWS / cat_med / 1e6,
                           " ".join("%.4f" % v for v in cat["update_s"]),
                           EXPO_GATE_ROUNDS, cat["gate_s"]))
    print("time [%s | %s]: Bosch boosting rounds int8 %.4f s, int16 %.4f s, "
          "int8 + bagging %.4f s, phase 31 (f32 sums, hi+lo) %.4f s (medians "
          "of rounds 2-%d)" % (name, card, q["med8"], q["med16"], q["medb"],
                               q["round_s"], U16Q_ROUNDS))
    print("clocks [%s]: SM clock, max SM clock: %s (after the timings)"
          % (card, clocks()))
    print("time [%s | %s]: R in the profiled categorical round %.4f ms"
          % (name, card, round_r_ms(profile_round(cat["booster"], name,
                                                  card)[2])))
    wall_us, busy, by_kind = profile_round(q["b8"], name, card)
    hq_us = sum(v for k, v in by_kind.items() if "hist_i32" in k)
    print("where the time goes [%s | %s]: Bosch int8 round: HQ u16 %.3f ms "
          "(share %.3f of device busy), idle share %.3f"
          % (name, card, hq_us / 1e3, hq_us / busy, 1.0 - busy / wall_us))

    launch_of = {"leaf_histogram_i32_u16": q["launches"]["HQ_u16"],
                 "leaf_moments_u16": q["lm_launches"]["LM_u16"],
                 "split_scan_cat": cat["launches"]["S_cat"],
                 "route_partition_cat": cat["launches"]["R_cat"],
                 "tree_value_walk_binned_cat": cat["launches"]["W_cat"]}
    replaces = {"leaf_histogram_i32_u16": "lightgbm_tpu/ops/histogram.py:291",
                "leaf_moments_u16": "lightgbm_tpu/ops/histogram.py:679",
                "split_scan_cat": "lightgbm_tpu/ops/split.py:176",
                "route_partition_cat": "lightgbm_tpu/learner/grow.py:1052",
                "tree_value_walk_binned_cat":
                    "lightgbm_tpu/ops/predict.py:75"}
    sources = {"leaf_histogram_i32_u16": "histogram.cu",
               "leaf_moments_u16": "moments.cu",
               "split_scan_cat": "split_scan.cu",
               "route_partition_cat": "route_partition.cu",
               "tree_value_walk_binned_cat": "binned_walk.cu"}
    errs = {"leaf_moments_u16": q["lm_err"]["u16"]}
    rows = []
    for k, (ms, plain_ms, (b_ms, b_by), lib_ms) in times.items():
        rows.append({
            "name": k, "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/" + sources[k],
            "replaces": replaces[k], "launches": launch_of[k],
            "max_abs_err": errs.get(k, 0.0), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    return rows


def main():
    # ---------------------------------------------------------------- 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import predict as P
    from lightgbm_tpu_torch.ops.predict import (
        OutputTransform, apply_output_plain, forest_leaf_walk,
        forest_leaf_walk_plain, forest_value_walk, forest_value_walk_f16,
        forest_value_walk_plain, stack_trees, to_f16)
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
    # K1 and its f16 mode at every row count of both modes, on the two
    # forests, on one whose padded trees pass a record buffer (records
    # read from device memory) and on 300-column rows (rows read from
    # device memory), alone and with such trees
    t0 = time.perf_counter()

    def trees_of(text):
        return lgb.Booster(model_str=text, device="cpu")._inner.models
    big = trees_of(synthetic_forest_text(5, 2, BIG_LEAVES, FEATURES,
                                         sample_rows=BIG_SAMPLE_ROWS))
    wide = trees_of(synthetic_forest_text(6, 20, 63, K1_WIDE_FEATURES))
    wide_big = trees_of(synthetic_forest_text(
        7, 2, BIG_LEAVES, K1_WIDE_FEATURES, sample_rows=BIG_SAMPLE_ROWS))
    print("K1 forests of large trees and wide rows: %.1f s"
          % (time.perf_counter() - t0))
    for label, trees, nf, cats, n in (
            ("full", host["full"], FEATURES, 0, BULK_ROWS),
            ("categorical", host["categorical"], FEATURES, 4, BULK_ROWS),
            ("large trees", big + host["full"][:20], FEATURES, 0,
             BULK_ROWS),
            ("wide rows", wide, K1_WIDE_FEATURES, 0, K1_WIDE_ROWS),
            ("wide rows, large trees", wide_big + wide, K1_WIDE_FEATURES, 0,
             K1_WIDE_ROWS)):
        x = torch.from_numpy(held_rows(trees, nf, cats, n)).to(dev)
        forest = stack_trees(trees, dev)
        plan = P.walk_plan(forest.num_trees, forest.split_feature.shape[1],
                           forest.num_features, n)
        print("K1 plan [%s, %d trees of up to %d nodes, %d columns, %d "
              "rows]: %s" % (label, forest.num_trees,
                             forest.split_feature.shape[1], nf, n, plan))
        errs["forest_value_walk"] = max(errs["forest_value_walk"], hold_k1(
            label, forest_value_walk, forest, x,
            forest_value_walk_plain(forest, x), P))
        errs["forest_leaf_walk"] = max(errs["forest_leaf_walk"], hold_k2(
            label, forest, x, P))
        if label == "full":
            f16 = to_f16(forest)
            hold_k1("full, f16 leaves", forest_value_walk_f16, f16, x,
                    forest_value_walk_plain(f16, x), P)
        del x, forest

    # ---------------------------------------------------------------- 3
    bulk = synthetic_rows(4, BULK_ROWS, FEATURES)
    forest_value_walk.launches = 0
    forest_value_walk.launches_rows = 0
    forest_leaf_walk.launches = 0
    forest_leaf_walk.launches_rows = 0
    booster = lgb.Booster(model_str=text)
    check(booster.device.type == "cuda", "default device is not cuda")
    value = booster.predict(bulk)
    raw = booster.predict(bulk, raw_score=True)
    leaf = booster.predict(bulk, pred_leaf=True)
    # a small request walks K2's trees mode
    check(np.array_equal(booster.predict(bulk[:32], pred_leaf=True),
                         leaf[:32]), "pred_leaf on 32 rows != the bulk "
          "call's rows")
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
    k1_rows = forest_value_walk.launches_rows
    k2_rows = forest_leaf_walk.launches_rows
    print("main path launches:", launches, "(K1: %d in trees mode, %d in "
          "rows mode; K2: %d in trees mode, %d in rows mode)" % (
              launches["forest_value_walk"] - k1_rows, k1_rows,
              launches["forest_leaf_walk"] - k2_rows, k2_rows))
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")
    check(0 < k2_rows < launches["forest_leaf_walk"],
          "K2 did not launch both modes on the main path")
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
    # K1 and K1-f16 as device time alone (a CUDA graph of one call,
    # replayed), at the bulk shape, the engine's chunk and one row; the
    # JSON row keeps the bulk device time
    one_row = x[:1].contiguous()
    x_chunk = x[:chunk].contiguous()
    f16 = to_f16(forest)
    graph = {"K1 %d rows" % BULK_ROWS: lambda: forest_value_walk(forest, x),
             "K1 %d rows" % chunk: lambda: forest_value_walk(forest, x_chunk),
             "K1 1 row": lambda: forest_value_walk(forest, one_row),
             "K1-f16 %d rows" % BULK_ROWS:
                 lambda: forest_value_walk_f16(f16, x),
             "K1-f16 1 row": lambda: forest_value_walk_f16(f16, one_row),
             "K2 %d rows" % BULK_ROWS: lambda: forest_leaf_walk(forest, x),
             "K2 %d rows" % chunk: lambda: forest_leaf_walk(forest, x_chunk),
             "K2 1 row": lambda: forest_leaf_walk(forest, one_row)}
    graph = {k: graph_ms(fn) for k, fn in graph.items()}
    times["forest_value_walk"]["ms"] = graph["K1 %d rows" % BULK_ROWS]
    k2_call = times["forest_leaf_walk"]["ms"]
    times["forest_leaf_walk"]["ms"] = graph["K2 %d rows" % BULK_ROWS]
    print("time [%s | %s]: device (CUDA graph replay) %s ms; on 1 row with "
          "CUDA events around the wrapper K1 %.4f ms, K2 %.4f ms; K2 on %d "
          "rows %.4f ms by events, bound %.4f ms (%s)" % (
              name, card, ", ".join("%s %.4f" % kv for kv in graph.items()),
              median_ms(lambda: forest_value_walk(forest, one_row)),
              median_ms(lambda: forest_leaf_walk(forest, one_row)),
              BULK_ROWS, k2_call, times["forest_leaf_walk"]["bound_ms"],
              times["forest_leaf_walk"]["bound_by"]))
    del f16, x_chunk
    # K1's two modes either side of its crossover, each forced by moving
    # TREE_PARALLEL_MAX_ROWS (walk_plan reads it at every call)
    limit, cross = P.TREE_PARALLEL_MAX_ROWS, []
    for n in (4096, 16_384, 32_768, 65_536, 131_072):
        xn = x[:n].contiguous()
        for mode, at in (("trees", BULK_ROWS), ("rows", 0)):
            P.TREE_PARALLEL_MAX_ROWS = at
            cross.append("%d rows %s %.4f" % (n, mode, graph_ms(
                lambda: forest_value_walk(forest, xn), reps=20)))
    P.TREE_PARALLEL_MAX_ROWS = limit
    print("time [%s | %s]: K1 modes (device ms, CUDA graph replay; the "
          "plan takes trees mode up to %d rows): %s"
          % (name, card, limit, ", ".join(cross)))
    booster.predict(bulk)
    e2e = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        booster.predict(bulk)
        e2e.append((time.perf_counter() - t0) * 1e3)
    e2e_ms = float(np.median(e2e))
    print("time [%s | %s]: Booster.predict %d rows %.2f ms, %.0f rows/s"
          % (name, card, BULK_ROWS, e2e_ms, BULK_ROWS / e2e_ms * 1e3))
    booster.predict(bulk, pred_leaf=True)
    e2e = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        booster.predict(bulk, pred_leaf=True)
        e2e.append((time.perf_counter() - t0) * 1e3)
    e2e_ms = float(np.median(e2e))
    print("time [%s | %s]: Booster.predict(pred_leaf=True) %d rows %.2f ms, "
          "%.0f rows/s" % (name, card, BULK_ROWS, e2e_ms,
                           BULK_ROWS / e2e_ms * 1e3))
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
    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print("phase time: %s %.1f s" % (label, time.perf_counter() - t0))
        return out

    rank_row = timed("ranking (5-8)", ranking, name, card, dev)
    train_rows, ctx = timed("training (9-12)", training, name, card, dev)
    rows.extend(train_rows)
    rows.append(rank_row)
    rows.extend(timed("quantized (13-16)", quantized, name, card, dev, ctx))
    rows.extend(timed("linear (17-20)", linear, name, card, dev, ctx))
    rows.extend(timed("serving extras (21-24)", serving_extras, name, card,
                      dev, ctx, text))
    rows.extend(timed("boosting modes (25-29)", boosting_modes, name, card,
                      dev, ctx))
    rows.extend(timed("bosch (30-35)", bosch, name, card, dev, ctx))
    cat = timed("categorical (36-38)", categorical, name, card, dev)
    q = timed("uint16 HQ and LM (39-40)", uint16_quant, name, card, dev, ctx)
    rows.extend(timed("times (41)", times_41, name, card, dev, cat, q))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------
# A/B mode: H, QC and training rounds of several checkouts on one card
AB_LIST_ROWS = 966_119
# the Bosch row list HQ is timed on: the size of the main path's root
# split's smaller child (phase 41)
AB_BOSCH_LIST_ROWS = 39_589
# H u16's row list in the A/B: the size of the Bosch root split's smaller
# child (phase 35)
AB_BOSCH_H_LIST_ROWS = 21_856
# Q's second size in the A/B: the Bosch int8 path's training rows
AB_Q_ROWS = 500_000


def host_us(fn, reps=200):
    """Median host time of one fn() call in microseconds, with no
    synchronisation: a launch returns once queued, so this is the
    wrapper's own time while the device keeps up."""
    spin_up(fn)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def busy_ms(fn, reps=REPS):
    """Device busy time of one fn() call: torch.profiler over `reps`
    calls after a spin-up, the union of the device events' intervals
    (kernels, copies and memsets alike) over reps; and {event name: its
    ms a call}, the names shortened."""
    from torch.profiler import ProfilerActivity, profile
    spin_up(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events, busy = device_busy(prof)
    by_name = {}
    for e in events:
        k = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        by_name[k] = by_name.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
    return busy / 1e3 / reps, {k: v / reps for k, v in by_name.items()}


def kernel_name(name):
    """An H kernel's name in a profiler event's (`hist_lane_kernel`,
    `hist_sum_kernel`), else the event's name."""
    found = re.search(r"hist_\w+", name)
    return found.group(0) if found else name


def ab_texts(seed, trees, leaves, features, **kw):
    """synthetic_forest_text's text, made once for the A/B's children:
    kept under OUT_DIR (the seeded text is the same in every checkout)."""
    from lightgbm_tpu_torch.testing.synth import synthetic_forest_text
    path = OUT_DIR / ("ab_forest_%d_%d_%d_%d_%s.txt" % (
        seed, trees, leaves, features,
        "_".join("%s%s" % kv for kv in sorted(kw.items()))))
    if not path.exists():
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".%d.tmp" % os.getpid())
        tmp.write_text(synthetic_forest_text(seed, trees, leaves, features,
                                             **kw))
        os.replace(tmp, path)
    return path.read_text()


def ab_child(root, rounds, cat_rounds, serving_only=False):
    """One checkout's numbers as one JSON line (see ab_main)."""
    sys.path.insert(0, os.path.abspath(root))
    import lightgbm_tpu_torch as lgb
    from torch.profiler import ProfilerActivity, profile
    import inspect
    from lightgbm_tpu_torch.ops import _build, histogram, split
    from lightgbm_tpu_torch.ops import predict as P
    from lightgbm_tpu_torch.testing.synth import (
        synth_bosch, synth_expo, synth_higgs, synthetic_forest_text,
        synthetic_rows)
    from lightgbm_tpu_torch.tree import Tree
    check(os.path.dirname(os.path.abspath(lgb.__file__)) == os.path.join(
        os.path.abspath(root), "lightgbm_tpu_torch"),
        "imported %s, not %s's package" % (lgb.__file__, root))
    dev = torch.device("cuda", 0)
    out = {"root": root}
    if serving_only:
        for lib_name in ("forest", "quant"):
            _build.build(lib_name)
    else:
        _build.build_all()
    leaf_histogram = histogram.leaf_histogram

    # K1 and K1-f16 on phase 2's forest, and K1 on its first 10 trees
    # with seeded linear leaves (k 5, phase 17's width): device time
    # (CUDA-graph replay) at 262,144 rows and on one row, and one row's
    # call time
    trees = lgb.Booster(model_str=ab_texts(
        0, TREES, LEAVES, FEATURES), device="cpu")._inner.models
    forest = P.stack_trees(trees, dev)
    gen = np.random.RandomState(9)
    linear = [Tree.from_string(t.to_string()) for t in trees[:TRAIN_ROUNDS]]
    for t in linear:
        t.leaf_coeff = gen.normal(0.0, 0.1, (t.num_leaves, 5))
        t.leaf_features = gen.randint(0, FEATURES, (t.num_leaves, 5)).astype(
            np.int32)
    xk = torch.from_numpy(synthetic_rows(4, BULK_ROWS, FEATURES)).to(dev)
    one = xk[:1].contiguous()
    for label, walk, stack in (
            ("K1", P.forest_value_walk, forest),
            ("K1_f16", P.forest_value_walk_f16, P.to_f16(forest)),
            ("K1_linear", P.forest_value_walk, P.stack_trees(linear, dev))):
        out["%s_bulk_device" % label] = graph_ms(lambda: walk(stack, xk))
        out["%s_1row_device" % label] = graph_ms(lambda: walk(stack, one))
        out["%s_1row_call" % label] = median_ms(lambda: walk(stack, one))
    # K2 on the same forest and rows, and its one-row call's host time
    out["K2_bulk_device"] = graph_ms(lambda: P.forest_leaf_walk(forest, xk))
    out["K2_1row_device"] = graph_ms(lambda: P.forest_leaf_walk(forest, one))
    out["K2_1row_call"] = median_ms(lambda: P.forest_leaf_walk(forest, one))
    out["K2_1row_host_us"] = host_us(lambda: P.forest_leaf_walk(forest, one))
    del forest, trees, linear, xk, one
    if serving_only:
        serving_ab(out, lgb, P, dev, synthetic_rows)
        print(json.dumps(out), flush=True)
        return

    # H at the HIGGS root and on a row list, on the first gradients
    x, y = synth_higgs(TRAIN_ROWS, FEATURES, seed=0)
    ds = lgb.Dataset(x, y, params=dict(TRAIN_PARAMS)).construct()
    inner = lgb.Booster(dict(TRAIN_PARAMS), train_set=ds)._inner
    binned, nb = inner._binned, inner._grower.num_bins
    grad, hess = inner.objective.get_gradients(inner._score[0])
    w3 = torch.stack([grad, hess, torch.ones_like(grad)], 1).contiguous()
    rows = torch.from_numpy(np.random.RandomState(1).permutation(
        TRAIN_ROWS)[:AB_LIST_ROWS].astype(np.int32)).to(dev)
    for mode, bf16 in (("f32", False), ("hilo", True)):
        def root_call():
            leaf_histogram(binned, w3, nb, bf16=bf16)

        def list_call():
            leaf_histogram(binned, w3, nb, rows=rows, n_rows=AB_LIST_ROWS,
                           bf16=bf16)
        out["H_%s_root_call" % mode] = median_ms(root_call)
        out["H_%s_root_device" % mode] = graph_ms(root_call)
        out["H_%s_list_call" % mode] = median_ms(list_call)
        out["H_%s_list_device" % mode] = graph_ms(list_call)
        small = rows[:1000].contiguous()
        out["H_%s_host_us" % mode] = host_us(
            lambda: leaf_histogram(binned, w3, nb, rows=small, n_rows=1000,
                                   bf16=bf16))
    # phase 10's cancelling gradients: the error against the f64 sums
    gen = np.random.RandomState(1)
    cb = torch.from_numpy(gen.randint(0, 64, (TRAIN_ROWS, FEATURES))
                          .astype(np.uint8)).to(dev)
    mask_c = (gen.rand(TRAIN_ROWS) < 0.9).astype(np.float32)
    wc = torch.from_numpy(np.stack([
        gen.randn(TRAIN_ROWS).astype(np.float32) * 0.5 * mask_c,
        gen.rand(TRAIN_ROWS).astype(np.float32) * 0.25 * mask_c, mask_c],
        1)).to(dev)
    hi, lo = histogram.hi_lo(wc[:, :2].contiguous())
    exact = {False: hist_oracle(cb, wc, 64)}
    exact[True] = hist_oracle(cb, torch.cat([hi, wc[:, 2:3]], 1), 64)
    exact[True][..., :2] += hist_oracle(
        cb, torch.cat([lo, wc[:, 2:3]], 1), 64)[..., :2]
    for mode, bf16 in (("f32", False), ("hilo", True)):
        got = leaf_histogram(cb, wc, 64, bf16=bf16)[..., :2].double()
        ref = exact[bf16][..., :2]
        out["H_%s_cancel_rel" % mode] = float(
            ((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
    del cb, wc, hi, lo, exact, rows

    # LM as leaf_feature_moments calls it, on the protocol's bins and raw
    # values, its first gradients and 255 seeded leaf ids of a tree's
    # skew: the call (CUDA events), the device busy time of a call
    # (torch.profiler, either checkout), a CUDA graph of the call where
    # it reads nothing back, and the call's host time
    from lightgbm_tpu_torch.linear import leaf_feature_moments
    lm_gen = np.random.RandomState(14)
    lm_p = np.exp(2 * lm_gen.randn(LEAVES))
    lm_lid = torch.from_numpy(lm_gen.choice(
        LEAVES, TRAIN_ROWS, p=lm_p / lm_p.sum()).astype(np.int32)).to(dev)
    lm_x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    def lm_ab(label, lb, lw, width):
        def call():
            return leaf_feature_moments(lb, lm_x, lw, lm_lid,
                                        list(range(LEAVES)), width)
        out["LM_%s_call" % label] = median_ms(call)
        out["LM_%s_busy" % label], out["LM_%s_kernels" % label] = \
            busy_ms(call)
        if hasattr(histogram, "leaf_moments_ids"):
            out["LM_%s_graph" % label] = graph_ms(call)
        small = [t[:LM_HOST_ROWS].contiguous() for t in (lb, lm_x, lw,
                                                         lm_lid)]
        out["LM_%s_host_us" % label] = host_us(lambda: leaf_feature_moments(
            *small, list(range(LEAVES)), width))
    lm_ab("u8", binned, w3, nb)
    linear_ab(out, dev, lm_x, grad, hess, lm_lid)
    rank_ab(out, lgb, dev)

    serving_ab(out, lgb, P, dev, synthetic_rows)

    # R at a root (a split on the first feature at half its bins) and on
    # a late small segment, as the checkout's grower calls it: device time
    # (torch.profiler, either checkout's kernels) and a call's host time
    from lightgbm_tpu_torch.ops import route
    one_launch = hasattr(route, "route_scratch")
    r_names = (("partition_kernel",) if one_launch else
               ("route_kernel", "scan_tiles_kernel", "scatter_kernel",
                "Memcpy DtoD"))

    def r_times(label, booster):
        binned, fm = booster._binned, booster._grower.fmeta
        n = binned.shape[0]
        rule = route.SplitRule(
            int(fm["group"][0]), int(fm["offset"][0]), int(fm["num_bin"][0]),
            int(fm["default_bin"][0]), int(fm["missing_type"][0]),
            bool(fm["is_bundled"][0]), int(fm["num_bin"][0]) // 2, False,
            False, 0, 1)
        lid = torch.zeros(n, dtype=torch.int32, device=dev)
        root = torch.arange(n, dtype=torch.int32, device=dev)
        late = late_segment(n, dev)
        # the bins as the checkout's grower hands them to R
        bins = getattr(booster._grower, "_route_bins", binned)
        calls = {}
        for key, src, m in (("root", root, n), ("late", late,
                                                ROUTE_LATE_ROWS)):
            if one_launch:
                calls[key] = route_call(route, bins, src, m, rule, lid,
                                        route.route_scratch(n, dev))
            else:
                calls[key] = (lambda src=src, m=m: route.route_partition(
                    bins, src, 0, m, rule, lid))
        for key, fn in calls.items():
            out["R_%s_%s_graph" % (label, key)] = graph_ms(fn)
            out["R_%s_%s_device" % (label, key)] = device_ms(fn, r_names)
        out["R_%s_host_us" % label] = host_us(calls["late"])

    def rounds_of(booster, k, label):
        """k rounds' seconds, their median from round 2, and one more
        round under torch.profiler: wall, device busy, idle share, H."""
        secs = []
        for _ in range(k):
            t0 = time.perf_counter()
            booster.update()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            booster.update()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events, busy = device_busy(prof)

        def in_round(match):
            return sum(e.time_range.elapsed_us() for e in events
                       if match(e.name)) / 1e3
        out.update({
            label + "_round_s": secs,
            label + "_round_s_median": float(np.median(secs[1:])),
            label + "_profiled_round_s": wall,
            label + "_device_busy_ms": busy / 1e3,
            label + "_idle_share": 1.0 - busy / 1e6 / wall,
            label + "_H_in_round_ms": in_round(
                lambda k: "hist_" in k and "i32" not in k),
            label + "_H_kernels": {
                k: in_round(lambda e, k=k: kernel_name(e) == k)
                for k in sorted({kernel_name(e.name) for e in events
                                 if "hist_" in e.name
                                 and "i32" not in e.name})},
            label + "_S_in_round_ms": in_round(lambda k: "split_scan" in k),
            label + "_HQ_in_round_ms": in_round(lambda k: "hist_i32" in k),
            label + "_R_in_round_ms": in_round(lambda k: any(
                r in k for r in ("partition_kernel", "route_kernel",
                                 "scan_tiles_kernel", "scatter_kernel"))),
            label + "_DtoD_in_round_ms": in_round(
                lambda k: "Memcpy DtoD" in k),
            label + "_memset_in_round_ms": in_round(
                lambda k: "Memset" in k),
            label + "_text_sha": text_sha(booster.model_to_string())})

    # S on a leaf pair (a seeded third of the rows and the rest) and on
    # the root, and HQ at the root and on a seeded row list, each by
    # CUDA-graph replay; either checkout's HQ: its plan or, before it, the
    # hist_layout of a uint16 matrix
    takes_plan = "plan" in inspect.signature(
        histogram.leaf_histogram_i32).parameters

    def s_device(label, booster, pair=True):
        g = booster._grower
        n = booster._binned.shape[0]
        gr, he = booster.objective.get_gradients(booster._score[0])
        ww = torch.stack([gr, he, torch.ones_like(gr)], 1).contiguous()
        perm = torch.from_numpy(np.random.RandomState(2).permutation(n)
                                .astype(np.int32)).to(dev)

        def hist(rows=None, cnt=None):
            return leaf_histogram(booster._binned, ww, g.num_bins, rows=rows,
                                  n_rows=cnt, bf16=True,
                                  layout=g.hist_layout)
        k = n // 3
        hs = [hist(perm, k), hist(perm[k:], n - k)] if pair else [hist()]
        hists = torch.stack(hs).contiguous()
        sums = torch.from_numpy(np.stack([leaf_totals(h) for h in hs])).to(
            dev)
        depth = torch.ones(len(hs), dtype=torch.int32, device=dev)
        mask = torch.ones(g.fmeta_dev["num_bin"].shape[0], dtype=torch.uint8,
                          device=dev)
        out["S_%s_%s_device" % (label, "pair" if pair else "root")] = \
            graph_ms(lambda: split.split_scan(hists, sums, depth, g.fmeta_dev,
                                              mask, g.params,
                                              g.feature_bins))

    def hq_device(label, booster, list_rows):
        g = booster._grower
        n = booster._binned.shape[0]
        gr, he = booster.objective.get_gradients(booster._score[0])
        q = histogram.quantize_gradients(
            gr, he, torch.ones_like(gr), qmax=booster._quant_qmax,
            key_g=(0, 1), key_h=(0, 2), reciprocal_scale=True)
        kw = ({"plan": g.hq_plan} if takes_plan else
              {"layout": g.hist_layout} if g.hist_layout is not None else {})
        rows = torch.from_numpy(np.random.RandomState(3).permutation(n)[
            :list_rows].astype(np.int32)).to(dev)
        out["HQ_%s_root_device" % label] = graph_ms(
            lambda: histogram.leaf_histogram_i32(
                booster._binned, q.codes, q.w01, g.num_bins, **kw))
        if list_rows:
            out["HQ_%s_list_device" % label] = graph_ms(
                lambda: histogram.leaf_histogram_i32(
                    booster._binned, q.codes, q.w01, g.num_bins, rows=rows,
                    n_rows=list_rows, **kw))

    def h_u16(label, booster, list_rows):
        """H on a uint16 matrix at the root and on a seeded row list,
        both modes, by CUDA-graph replay, and a 1,000-row call's host
        time."""
        g = booster._grower
        gr, he = booster.objective.get_gradients(booster._score[0])
        ww = torch.stack([gr, he, torch.ones_like(gr)], 1).contiguous()
        n = booster._binned.shape[0]
        rows = torch.from_numpy(np.random.RandomState(4).permutation(n)[
            :max(list_rows, 1000)].astype(np.int32)).to(dev)
        for mode, bf16 in (("f32", False), ("hilo", True)):
            lay = histogram.hist_layout(g.hist_layout.widths, bf16, dev)
            out["H_u16_%s_%s_root_device" % (label, mode)] = graph_ms(
                lambda: leaf_histogram(booster._binned, ww, g.num_bins,
                                       bf16=bf16, layout=lay))
            if list_rows:
                out["H_u16_%s_%s_list_device" % (label, mode)] = graph_ms(
                    lambda: leaf_histogram(booster._binned, ww, g.num_bins,
                                           rows=rows, n_rows=list_rows,
                                           bf16=bf16, layout=lay))
        small = rows[:1000].contiguous()
        out["H_u16_%s_host_us" % label] = host_us(
            lambda: leaf_histogram(booster._binned, ww, g.num_bins,
                                   rows=small, n_rows=1000, bf16=True,
                                   layout=g.hist_layout))

    s_device("higgs", inner)
    r_times("higgs", inner)
    queue_ab(out, lgb, dev, ds, x, y, grad, hess, lm_x, lm_lid)
    int8 = dict(TRAIN_PARAMS, tpu_hist_quantize="int8")
    hq_device("higgs_u8", lgb.Booster(int8, train_set=ds)._inner, 0)
    rounds_of(lgb.Booster(dict(TRAIN_PARAMS), train_set=ds), rounds, "higgs")
    rounds_of(lgb.Booster(int8, train_set=ds), rounds, "higgs_int8")
    del ds, binned, w3, inner, grad, hess
    wparams = dict(TRAIN_PARAMS, max_bin=WIDE_MAX_BIN)
    wds = lgb.Dataset(x, y, params=wparams).construct()
    s_device("wide", lgb.Booster(wparams, train_set=wds)._inner, pair=False)
    wide_in = lgb.Booster(wparams, train_set=wds)._inner
    h_u16("wide", wide_in, 0)
    gr, he = wide_in.objective.get_gradients(wide_in._score[0])
    lm_ab("u16", wide_in._binned, torch.stack(
        [gr, he, torch.ones_like(gr)], 1).contiguous(),
        wide_in._grower.num_bins)
    del wds, x, y, wide_in, gr, he, lm_x
    xb, yb = synth_bosch(BOSCH_ROWS + BOSCH_VALID_ROWS, BOSCH_FEATURES,
                         seed=BOSCH_SEED)
    bds = lgb.Dataset(xb[:BOSCH_ROWS], yb[:BOSCH_ROWS],
                      params=dict(BOSCH_PARAMS)).construct()
    # W u16 (PR 18): the first tree on the Bosch valid set, both modes
    wb = lgb.train(dict(BOSCH_PARAMS), bds, 1, valid_sets=[lgb.Dataset(
        xb[BOSCH_ROWS:], yb[BOSCH_ROWS:], reference=bds)],
        verbose_eval=False)
    # phase 33's linear run on uint16 bins: its model text hash
    lparams = dict(BOSCH_PARAMS, num_leaves=BOSCH_CPU_LEAVES,
                   linear_tree=True, linear_lambda=0.01)
    out["bosch_linear_text_sha"] = text_sha(lgb.train(
        dict(lparams), lgb.Dataset(xb[:BOSCH_CPU_ROWS], yb[:BOSCH_CPU_ROWS],
                                   params=dict(lparams)),
        BOSCH_CPU_ROUNDS, verbose_eval=False).model_to_string())
    del xb, yb
    w_ab(out, "u16", P, wb._inner.models[0], wb._inner._valid_binned[0])
    w_ab(out, "u16_leaf", P, wb._inner.models[0],
         wb._inner._valid_binned[0], leaf_mode=True)
    del wb
    s_device("bosch", lgb.Booster(dict(BOSCH_PARAMS), train_set=bds)._inner)
    h_u16("bosch", lgb.Booster(dict(BOSCH_PARAMS), train_set=bds)._inner,
          AB_BOSCH_H_LIST_ROWS)
    r_times("bosch", lgb.Booster(dict(BOSCH_PARAMS), train_set=bds)._inner)
    qparams = dict(BOSCH_PARAMS, tpu_hist_quantize="int8")
    hq_device("bosch", lgb.Booster(qparams, train_set=bds)._inner,
              AB_BOSCH_LIST_ROWS)
    rounds_of(lgb.Booster(dict(BOSCH_PARAMS), train_set=bds), rounds,
              "bosch")
    rounds_of(lgb.Booster(qparams, train_set=bds), rounds, "bosch_int8")
    del bds
    # the categorical protocol (phase 36): its rounds, then its 500-round
    # train as phase 36 times it
    xa, ya, _ = synth_expo(EXPO_ROWS + EXPO_TEST_ROWS, seed=EXPO_SEED)
    cds = lgb.Dataset(xa[:EXPO_ROWS], ya[:EXPO_ROWS],
                      params=dict(EXPO_PARAMS)).construct()
    # W categorical (PR 18): the first tree on the protocol's test rows
    wc = lgb.train(dict(EXPO_PARAMS), cds, 1, valid_sets=[lgb.Dataset(
        xa[EXPO_ROWS:], ya[EXPO_ROWS:], reference=cds)], verbose_eval=False)
    w_ab(out, "cat", P, wc._inner.models[0], wc._inner._valid_binned[0])
    del wc
    s_device("cat", lgb.Booster(dict(EXPO_PARAMS), train_set=cds)._inner)
    rounds_of(lgb.Booster(dict(EXPO_PARAMS), train_set=cds), rounds, "cat")
    if cat_rounds:
        t0 = time.perf_counter()
        lgb.train(dict(EXPO_PARAMS), cds, cat_rounds)
        torch.cuda.synchronize()
        out["cat_train_%d_s" % cat_rounds] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def text_sha(text):
    import hashlib
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def w_ab(out, label, P, tree, bins, leaf_mode=False, sign=1.0):
    """The A/B's W (PR 18): one tree on `bins` as the checkout's main path
    hands them (its valid set's, or the train matrix W walks), by CUDA-
    graph replay, and the hash of one call's output bits."""
    bt = P.binned_tree(tree, bins.device, tree.leaf_value * sign)
    if leaf_mode:
        def call():
            return P.tree_leaf_walk_binned(bt, bins)
        bits = call()
    else:
        sc = torch.zeros(bins.shape[0], dtype=torch.float32,
                         device=bins.device)

        def call():
            P.tree_value_walk_binned(bt, bins, sc)
        call()
        bits = sc.view(torch.int32).clone()
    out["W_%s_sha" % label] = text_sha(
        bits.cpu().numpy().tobytes().hex())
    out["W_%s_graph" % label] = graph_ms(call, calls=SHORT_CALLS)
    out["W_%s_strides" % label] = list(bins.stride())


def queue_ab(out, lgb, dev, ds, x, y, grad, hess, lm_x, lm_lid):
    """The A/B's GT and W on the HIGGS protocol (PR 18), and the kernels
    no PR has redesigned (LA, R average, Q, GW, M), each by CUDA-graph
    replay at the main path's shapes; GOSS, DART and linear runs' model
    text hashes."""
    from lightgbm_tpu_torch.ops import goss, histogram, route, rng
    from lightgbm_tpu_torch.ops import linear as lin
    from lightgbm_tpu_torch.ops import predict as P
    from lightgbm_tpu_torch.testing.synth import synth_higgs
    n = grad.shape[0]
    top_k, other_k = int(n * 0.2), int(n * 0.1)
    mag, thr = goss.goss_threshold(grad, hess, top_k)
    out["GT_bits"] = int(thr.view(torch.int32).item())
    out["GT_graph"] = graph_ms(lambda: goss.goss_threshold(grad, hess,
                                                           top_k),
                               calls=SHORT_CALLS)
    rest_p, mult = goss.goss_rates(n, top_k, other_k)
    key = rng.fold_in(rng.prng_key(3), 11)
    wbuf = torch.empty(n, device=dev)
    out["GW_graph"] = graph_ms(lambda: goss.goss_weights(
        mag, thr, key, rest_p, mult, wbuf), calls=SHORT_CALLS)
    out["M_graph"] = graph_ms(lambda: rng.bagging_mask(key, 0.8, wbuf),
                              calls=SHORT_CALLS)
    ones = torch.ones_like(grad)
    out["Q_graph"] = graph_ms(lambda: histogram.quantize_gradients(
        grad, hess, ones, qmax=127, key_g=(0, 1), key_h=(0, 2),
        reciprocal_scale=True), calls=SHORT_CALLS)
    # Q's bits at 2,000,000 rows (codes, w01, scales, both modes), and Q
    # at the Bosch int8 path's 500,000 rows
    q_bits = [histogram.quantize_gradients(
        grad, hess, wt, qmax=127, key_g=(0, 1), key_h=(0, 2),
        reciprocal_scale=recip) for wt in (ones, wbuf) for recip in (True,
                                                                 False)]
    out["Q_sha"] = text_sha(b"".join(
        t.cpu().numpy().tobytes() for q in q_bits for t in q).hex())
    del q_bits
    g5, h5, o5 = (t[:AB_Q_ROWS].contiguous() for t in (grad, hess, ones))
    out["Q_500k_graph"] = graph_ms(lambda: histogram.quantize_gradients(
        g5, h5, o5, qmax=127, key_g=(0, 1), key_h=(0, 2),
        reciprocal_scale=True), calls=SHORT_CALLS)
    del g5, h5, o5
    xv, yv = synth_higgs(VALID_ROWS, FEATURES, seed=1)
    gen = torch.Generator(device=dev).manual_seed(18)
    values = torch.randn(LEAVES, device=dev, generator=gen)
    sc = torch.zeros(n, device=dev)
    out["R_average_train_graph"] = graph_ms(
        lambda: route.score_average(sc, lm_lid, values, 3),
        calls=SHORT_CALLS)
    vadd = torch.randn(VALID_ROWS, device=dev, generator=gen)
    vsc = torch.zeros(VALID_ROWS, device=dev)
    out["R_average_valid_graph"] = graph_ms(
        lambda: route.score_average(vsc, None, vadd, 3), calls=SHORT_CALLS)
    coeff = torch.randn((LEAVES, 5), device=dev, generator=gen) * 0.1
    feats = torch.randint(0, FEATURES, (LEAVES, 5), device=dev,
                          generator=gen, dtype=torch.int32)
    out["LA_train_graph"] = graph_ms(lambda: lin.linear_addend(
        lm_x, lm_lid, values, coeff, feats, sc, 1.0), calls=SHORT_CALLS)
    sc.zero_()
    lin.linear_addend(lm_x, lm_lid, values, coeff, feats, sc, 1.0)
    out["LA_train_sha"] = text_sha(sc.cpu().numpy().tobytes().hex())
    # the bytes LA's row-major gather must move: the distinct 32-byte
    # sectors of each row's k values, its leaf id, its score read and
    # written (the leaves' coefficients stay in cache)
    row_bytes = lm_x.shape[1] * 4
    addr = (torch.arange(n, device=dev)[:, None] * row_bytes
            + feats[lm_lid.long()].long() * 4) // 32
    addr = addr.sort(1).values
    sectors = int(n + (addr[:, 1:] != addr[:, :-1]).sum())
    out["LA_train_gather_bytes"] = 32 * sectors + 12 * n
    xvd = torch.from_numpy(np.ascontiguousarray(xv, np.float32)).to(dev)
    vlid = torch.randint(0, LEAVES, (VALID_ROWS,), device=dev,
                         generator=gen, dtype=torch.int32)
    out["LA_valid_graph"] = graph_ms(lambda: lin.linear_addend(
        xvd, vlid, values, coeff, feats, vsc, 1.0), calls=SHORT_CALLS)
    vsc.zero_()
    lin.linear_addend(xvd, vlid, values, coeff, feats, vsc, 1.0)
    out["LA_valid_sha"] = text_sha(vsc.cpu().numpy().tobytes().hex())
    # W: the first tree of the protocol on its valid set (value and leaf
    # mode) and on the train matrix as DART's drops walk it (sign -1)
    hb = lgb.train(dict(TRAIN_PARAMS), ds, 1, valid_sets=[
        lgb.Dataset(xv, yv, reference=ds)], verbose_eval=False)
    tree = hb._inner.models[0]
    vb = hb._inner._valid_binned[0]
    w_ab(out, "u8", P, tree, vb)
    w_ab(out, "u8_leaf", P, tree, vb, leaf_mode=True)
    w_ab(out, "u8_train", P, tree,
         getattr(hb._inner, "_walk_binned", hb._inner._binned), sign=-1.0)
    del hb, vb, xvd
    for mode in ("goss", "dart"):
        b = lgb.train(dict(MODE_PARAMS[mode]), ds, MODE_ROUNDS[mode],
                      verbose_eval=False)
        out["%s_text_sha" % mode] = text_sha(b.model_to_string())
    lds = lgb.Dataset(x, y, params=dict(LINEAR_PARAMS)).construct()
    int8 = dict(LINEAR_PARAMS, tpu_hist_quantize="int8")
    for label, params in (("linear", LINEAR_PARAMS), ("linear_int8", int8),
                          ("linear_int8_bag", dict(
                              int8, bagging_fraction=0.8, bagging_freq=1))):
        out["%s_text_sha" % label] = text_sha(lgb.train(
            dict(params), lds, TRAIN_ROUNDS,
            verbose_eval=False).model_to_string())


def rank_ab(out, lgb, dev):
    """The A/B's L: through the objective (either checkout's plan), on
    the ranking protocol's layout (rank_data's labels, 5,000 queries of
    100 docs) and the MSLR-shaped one at seeded scores: the hash of its
    grad and hess bits, device time (CUDA-graph replay), a call's CUDA
    events and device busy time; then the ranking protocol's 10 rounds
    (phase 5), the hash of its model text and of L's bits at its trained
    scores."""
    import hashlib
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.objectives import LambdarankNDCG
    from lightgbm_tpu_torch.testing.synth import mslr_like_groups, rank_data

    def digest(*tensors):
        return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                       for t in tensors)).hexdigest()[:16]
    x, y = rank_data(RANK_ROWS + RANK_VALID_ROWS, qlen=RANK_QLEN,
                     seed=RANK_SEED)[:2]
    layouts = {"protocol": (np.full(RANK_ROWS // RANK_QLEN, RANK_QLEN),
                            y[:RANK_ROWS].astype(np.int32)),
               "mslr": mslr_like_groups(0)}
    for label, (sizes, labels) in layouts.items():
        md = Metadata(int(sizes.sum()))
        md.set_label(labels.astype(np.float32))
        md.set_group(sizes)
        obj = LambdarankNDCG(Config.from_params({"objective": "lambdarank"}))
        obj.init(md, int(sizes.sum()), dev)
        score = torch.randn(int(sizes.sum()), device=dev,
                            generator=torch.Generator(dev).manual_seed(3))
        out["L_%s_hash" % label] = digest(*obj.get_gradients(score))
        out["L_%s_graph" % label] = graph_ms(lambda: obj.get_gradients(
            score))
        out["L_%s_call" % label] = median_ms(lambda: obj.get_gradients(score))
        out["L_%s_busy" % label], out["L_%s_kernels" % label] = busy_ms(
            lambda: obj.get_gradients(score))
    gt = [RANK_QLEN] * (RANK_ROWS // RANK_QLEN)
    gv = [RANK_QLEN] * (RANK_VALID_ROWS // RANK_QLEN)
    booster = train_run(lgb, x[:RANK_ROWS], y[:RANK_ROWS], x[RANK_ROWS:],
                        y[RANK_ROWS:], RANK_PARAMS, TRAIN_ROUNDS, group=gt,
                        group_v=gv)[0]
    out["rank_model_text_hash"] = hashlib.sha256(
        booster.model_to_string().encode()).hexdigest()[:16]
    inner = booster._inner
    out["L_protocol_trained_hash"] = digest(*inner.objective.get_gradients(
        inner._score[0]))


def linear_ab(out, dev, x, grad, hess, lid):
    """The A/B's LF and LS: LF at phase 20's shape (the HIGGS protocol's
    raw values, its first gradients, `lid`'s 255 seeded leaf segments of
    a tree's skew, 5 seeded features a leaf) and at phase 18's k = 64
    design: device busy time of a call whose segments are new (the
    profiler, either checkout), a CUDA-graph replay where the
    checkout's call copies nothing up once its segments are cached, a
    call's CUDA events and host time; LS on the k = 5 systems by
    CUDA-graph replay and CUDA events."""
    from lightgbm_tpu_torch.ops import linear as lin
    cached = hasattr(lin, "_segment_cache")
    rs = np.random.RandomState(5)
    feats = torch.from_numpy(np.stack([
        rs.choice(FEATURES, 5, replace=False) for _ in range(LEAVES)])
        .astype(np.int32)).to(dev)
    lf5 = (x, grad, hess, torch.ones_like(grad)) + lin.segments_of(
        lid, LEAVES) + (feats,)
    gen = torch.Generator(device=dev).manual_seed(64)
    x64 = torch.randn((WIDE_ROWS, 70), device=dev, generator=gen)
    x64[::53, 3] = float("nan")
    lid64 = torch.randint(0, 16, (WIDE_ROWS,), device=dev, generator=gen,
                          dtype=torch.int32)
    feats64 = torch.stack([torch.randperm(70, device=dev, generator=gen)[:64]
                           for _ in range(16)]).to(torch.int32)
    feats64[5, 60:] = -1
    g64 = x64[:, 0].nan_to_num() - x64[:, 1]
    h64 = torch.rand(WIDE_ROWS, device=dev, generator=gen) + 0.5
    lf64 = (x64, g64, h64, torch.ones_like(h64)) + lin.segments_of(
        lid64, 16) + (feats64,)
    for label, args in (("k5", lf5), ("k64", lf64)):
        def fresh(args=args):
            if cached:
                lin._segment_cache.clear()
            lin.linear_normal_eq(*args)
        out["LF_%s_busy" % label], out["LF_%s_kernels" % label] = busy_ms(
            fresh)
        out["LF_%s_call" % label] = median_ms(fresh)
        out["LF_%s_host_us" % label] = host_us(fresh)
        if cached:
            out["LF_%s_graph" % label] = graph_ms(
                lambda args=args: lin.linear_normal_eq(*args))
    a5, b5, c5 = lin.linear_normal_eq(*lf5)
    # LF + LA for a tree: LF at k 5 then LA's train update on the
    # same rows and leaves, as one CUDA graph, as the trainer runs them;
    # the bits of LF's sums and of LA's update
    gen = torch.Generator(device=dev).manual_seed(19)
    value = torch.randn(LEAVES, device=dev, generator=gen)
    coeff = torch.randn((LEAVES, 5), device=dev, generator=gen) * 0.1
    sc = torch.zeros(x.shape[0], device=dev)

    def pair():
        lin.linear_normal_eq(*lf5)
        lin.linear_addend(x, lid, value, coeff, feats, sc, 1.0)
    out["LF_k5_sha"] = text_sha(b"".join(
        t.cpu().numpy().tobytes() for t in (a5, b5, c5)).hex())
    lin.linear_addend(x, lid, value, coeff, feats, sc, 1.0)
    out["LA_pair_sha"] = text_sha(sc.cpu().numpy().tobytes().hex())
    out["LFLA_pair_graph"] = graph_ms(pair)
    const = torch.zeros(LEAVES, device=dev)
    out["LS_graph"] = graph_ms(lambda: lin.linear_solve(
        a5, b5, c5, feats, const, 0.01), calls=SHORT_CALLS)
    out["LS_call"] = median_ms(lambda: lin.linear_solve(a5, b5, c5, feats,
                                                        const, 0.01))
    a64, b64, c64 = lin.linear_normal_eq(*lf64)
    const16 = torch.zeros(16, device=dev)
    out["LS_k64_graph"] = graph_ms(lambda: lin.linear_solve(
        a64, b64, c64, feats64, const16, 0.01), calls=SHORT_CALLS)
    # LS at k 64 and torch.linalg.solve_ex on the same systems (ridge and
    # identity applied), both by CUDA events around the call; LS at the
    # register mode's last k and the block mode's first, at k 16 and
    # k 120 on seeded systems; the hash of LS's outputs at each width;
    # the floor: a one-thread kernel that does no work, a graph of 20
    out["LS_k64_call"] = median_ms(lambda: lin.linear_solve(
        a64, b64, c64, feats64, const16, 0.01))
    eye = torch.eye(65, device=dev)
    a_lib = torch.where((c64 >= 130.0)[:, None, None], a64 + eye * 0.01, eye)
    out["LS_k64_solve_ex_call"] = median_ms(
        lambda: torch.linalg.solve_ex(a_lib, -b64))

    def ls_sha(*args):
        return text_sha(b"".join(t.cpu().numpy().tobytes() for t in
                                 lin.linear_solve(*args, 0.01)).hex())
    out["LS_k5_sha"] = ls_sha(a5, b5, c5, feats, const)
    out["LS_k64_sha"] = ls_sha(a64, b64, c64, feats64, const16)
    for k, leaves in LS_AB_WIDTHS:
        args = ls_systems(k, leaves, k, dev, edges=leaves > 8)
        out["LS_k%d_graph" % k] = graph_ms(
            lambda: lin.linear_solve(*args, 0.01), calls=SHORT_CALLS)
        out["LS_k%d_sha" % k] = ls_sha(*args)
    out["empty_kernel_graph"] = graph_ms(lambda: torch.cuda._sleep(0),
                                         calls=SHORT_CALLS)


def serving_ab(out, lgb, P, dev, synthetic_rows):
    """The A/B's serving kernels on phase 24's binned forest and rows:
    QC and torch.searchsorted over the same grid, QW on the rows' codes,
    a served int8 row, and ES at phase 24's kind of margin (the median
    2|raw| of the first 250 trees on these rows) and at 1e30."""
    text = ab_texts(0, TREES, LEAVES, FEATURES, max_bin=255)
    trees = lgb.Booster(model_str=text, device="cpu")._inner.models
    qf = P.stack_trees_quant(trees, dev)
    xb = torch.from_numpy(synthetic_rows(4, BULK_ROWS, FEATURES)).to(dev)
    xt = xb[:, :qf.grid.shape[0]].t().contiguous()
    out["QC_call"] = median_ms(lambda: P.quant_codes(qf, xb))
    out["QC_device"] = graph_ms(lambda: P.quant_codes(qf, xb))
    out["QC_host_us"] = host_us(lambda: P.quant_codes(qf, xb))
    out["searchsorted_call"] = median_ms(
        lambda: torch.searchsorted(qf.grid, xt))
    out["searchsorted_device"] = graph_ms(
        lambda: torch.searchsorted(qf.grid, xt))
    # QW on the same rows' codes, at 262,144 rows and on one row, and a
    # served int8 row (QC + QW + the host path)
    codes = P.quant_codes(qf, xb)
    one, c1 = xb[:1].contiguous(), codes[:1].contiguous()
    out["QW_bulk_device"] = graph_ms(lambda: P.forest_quant_walk(qf, codes,
                                                                 xb))
    out["QW_1row_device"] = graph_ms(lambda: P.forest_quant_walk(qf, c1, one))
    out["QW_1row_call"] = median_ms(lambda: P.forest_quant_walk(qf, c1, one))
    predictor = lgb.Booster(model_str=text, params={
        "tpu_predict_quantize": "int8"}).serving_predictor()
    predictor.warmup()
    lat = []
    for r in xb[:200].cpu().numpy():
        t0 = time.perf_counter()
        predictor.predict_one(r)
        lat.append((time.perf_counter() - t0) * 1e3)
    predictor.close()
    out["predict_one_int8_p50_ms"] = float(np.percentile(lat, 50))
    out["predict_one_int8_p99_ms"] = float(np.percentile(lat, 99))
    del codes, xt
    # ES: device at 262,144 rows (the median margin, freq 10, and a margin
    # no row reaches), on one row (both margins) and a one-row call
    stack = P.stack_trees_early_stop(trees, 1, TREES, dev)
    half = P.forest_value_walk(P.stack_trees(trees[:TREES // 2], dev), xb)
    margin = margin_median(half[None], 1)
    out["ES_margin"] = margin
    _, iters = P.forest_early_stop_walk(stack, xb, margin, ES_FREQ,
                                        return_iters=True)
    out["ES_mean_iters"] = float(iters.float().mean())
    for label, m in (("", margin), ("_never", 1e30)):
        out["ES_bulk%s_device" % label] = graph_ms(
            lambda: P.forest_early_stop_walk(stack, xb, m, ES_FREQ))
        out["ES_1row%s_device" % label] = graph_ms(
            lambda: P.forest_early_stop_walk(stack, one, m, ES_FREQ))
    out["ES_1row_call"] = median_ms(
        lambda: P.forest_early_stop_walk(stack, one, 1e30, ES_FREQ))
    out["ES_1row_host_us"] = host_us(
        lambda: P.forest_early_stop_walk(stack, one, 1e30, ES_FREQ))
    if hasattr(P, "ES_ROUND_ITERS"):
        # rows mode's variants: (iterations a round, tail rows), device
        # ms at 262,144 rows and at the engine's 131,072-row chunk, each
        # bitwise the checkout's own plan
        ref = P.forest_early_stop_walk(stack, xb, margin, ES_FREQ, True)
        chunk = xb[:131_072].contiguous()
        keep = (P.ES_ROUND_ITERS, P.ES_TAIL_ROWS)
        variants = {}
        for rounds, tail in ES_VARIANTS:
            P.ES_ROUND_ITERS, P.ES_TAIL_ROWS = rounds, tail
            got = P.forest_early_stop_walk(stack, xb, margin, ES_FREQ, True)
            check(bitwise(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  "ES variant %d/%d not bitwise the plan's" % (rounds, tail))
            variants["%d/%d" % (rounds, tail)] = [
                graph_ms(lambda: P.forest_early_stop_walk(
                    stack, xb, margin, ES_FREQ)),
                graph_ms(lambda: P.forest_early_stop_walk(
                    stack, chunk, margin, ES_FREQ))]
        P.ES_ROUND_ITERS, P.ES_TAIL_ROWS = keep
        out["ES_variants_ms"] = variants
    del xb, one, stack, half


def ab_main(argv):
    """python3 chip_smoke.py --ab OLD --ab NEW --ab NEW --ab OLD

    Compares checkouts on one card in one run. Each --ab is a directory
    holding a lightgbm_tpu_torch package, run in a process of its own in
    the order given. The card's name and power limit come first; then
    per checkout one JSON line: K1 and K1-f16 (forest_value_walk and its
    f16 mode) on phase 2's 500 x 255 x 28 forest and K1 on its first 10
    trees with seeded linear leaves (k 5), `*_device` at 262,144 rows
    and on one row, `*_1row_call` the median of CUDA events around a
    one-row call; K2 (forest_leaf_walk) on the same forest and rows the
    same three ways and `K2_1row_host_us`; ES (forest_early_stop_walk) on
    phase 24's binned forest and rows at the median 2|raw| of its first
    250 trees (`ES_margin`, `ES_mean_iters`) and at 1e30 (`*_never`),
    freq 10: `ES_bulk*_device`, `ES_1row*_device`, and a never-frozen
    row's `ES_1row_call` and `ES_1row_host_us`; H (leaf_histogram) at the HIGGS root (the
    phase-9 protocol's data and first gradients) in f32 and hi+lo mode
    and on a 966,119-row list, `*_call` the median of CUDA events around
    a call (the wrapper's host time included) and `*_device` the mean of
    replays of a CUDA graph that captured one call; `*_host_us` the
    median host time of a call that returns once queued (H on a
    1,000-row list; QC at full size); H's error on phase 10's cancelling gradients
    against the f64 sums, relative to max(1, |ref|); QC and
    torch.searchsorted over the same grid on 262,144 rows (phase 24's
    inputs), the same two ways; QW (forest_quant_walk) on those rows'
    codes, device at 262,144 rows and one row and a one-row call, and
    int8 Predictor.predict_one p50/p99 over 200 requests; R
    (route_partition) at the HIGGS and Bosch roots (a split on the first
    feature) and on a late 3,000-row segment, on the bins the checkout's
    grower hands it, `*_graph` by CUDA-graph replay and `*_device` by
    torch.profiler (either checkout's kernels), and a call's host time;
    S (split_scan) on a leaf pair (a seeded
    third of the rows and the rest) of the HIGGS, Bosch (phase 31) and
    categorical (phase 37) protocols and on the max_bin=1023 root (phase
    34), and HQ (leaf_histogram_i32) at the int8 HIGGS and Bosch roots
    and on a seeded 39,589-row Bosch list, each `*_device` as above; H
    on uint16 bins (`H_u16_*`) at the Bosch root and on a seeded
    21,856-row list and at the max_bin=1023 root, in both modes, each
    `*_device` as above, and a 1,000-row call's `*_host_us`;
    LM (leaf_feature_moments) on the HIGGS protocol's bins and raw
    values and on its max_bin=1023 (uint16) bins, with 255 seeded leaf
    ids of a tree's skew: `LM_*_call` (CUDA events), `LM_*_busy` (a
    call's device busy time, torch.profiler) and `LM_*_kernels` (its
    device events' ms a call by name), `LM_*_graph` (a CUDA
    graph of the call, where it reads nothing back) and `LM_*_host_us`
    (a call's host time on the first 1,000 rows);
    L (lambdarank_grads, through the objective) on the ranking
    protocol's layout and the MSLR-shaped one at seeded scores:
    `L_*_hash` (its grad and hess bits), `L_*_graph`, `L_*_call`,
    `L_*_busy` and `L_*_kernels`, then the ranking protocol's 10 rounds:
    `rank_model_text_hash` and `L_protocol_trained_hash` (L at the
    trained scores); LF (linear_normal_eq) at phase 20's shape (k 5, the
    HIGGS raw values, 255 seeded leaf segments) and phase 18's k = 64
    design: `LF_*_busy` and `LF_*_kernels` (a call whose segments are
    new), `LF_*_call`, `LF_*_host_us` and, where the checkout caches
    the segments, `LF_*_graph`; LS on the k 5 systems (`LS_graph`,
    `LS_call`) and at k 64 (`LS_k64_graph`, `LS_k64_call`) beside
    `torch.linalg.solve_ex` on the same systems (`LS_k64_solve_ex_call`,
    CUDA events), on seeded systems with the edge cases at
    `LS_AB_WIDTHS` (`LS_k*_graph`: the register mode's last k, the block
    mode's first, k 16 and k 120), the hash of its outputs at each width
    (`LS_k*_sha`), and an empty kernel's graph of 20 calls
    (`empty_kernel_graph`, `torch.cuda._sleep(0)`: the launch floor);
    W (the binned tree walk, PR 18) with the first tree of the HIGGS,
    Bosch and categorical protocols on each one's valid set as the
    checkout's booster keeps it (`W_u8`, `W_u8_leaf`, `W_u16`,
    `W_u16_leaf`, `W_cat`) and on the HIGGS train matrix as DART's drops
    walk it (`W_u8_train`, sign -1): `W_*_graph`, `W_*_sha` (a call's
    output bits) and `W_*_strides`; GT (`GT_graph`, `GT_bits`), GW, M,
    Q (int8), R's average mode on the train rows (255 seeded leaf ids)
    and the valid rows, and LA on the train and valid rows (k 5), all by
    CUDA-graph replay at the HIGGS protocol's shapes (`*_graph`: these,
    W's and LS's a graph of 20 calls, the mean a call), and the
    bytes LA's row-major gather must move (`LA_train_gather_bytes`: the
    distinct 32-byte sectors of each row's k values, 12 bytes more a
    row); Q at the Bosch int8 path's 500,000 rows
    (`Q_500k_graph`) and the hash of Q's bits at 2,000,000 rows in both
    scale modes, all rows and a bag mask (`Q_sha`), the hashes of LA's
    train and valid updates (`LA_train_sha`, `LA_valid_sha`), LF + LA
    for a tree (LF at k 5 on the 255 seeded segments, then LA's train
    update on them) as one CUDA graph (`LFLA_pair_graph`) with the
    hashes of LF's sums and LA's update (`LF_k5_sha`, `LA_pair_sha`);
    the
    model text hashes of GOSS (20 rounds), DART (10) and linear trees
    (10; f32, int8 and int8 + bagging) on the HIGGS protocol, of phase
    33's linear run on the Bosch uint16 bins (`bosch_linear_text_sha`)
    and of each run below (`*_text_sha`);
    `--rounds` rounds of the HIGGS and the Bosch protocols in hi+lo and
    in int8 and of the categorical protocol, each
    round's seconds and their median from round 2, and one more round
    under torch.profiler: wall, device busy time (the union of the device
    events' intervals), idle share and H's, S's, HQ's and R's device
    time (and the device-to-device copies', the parent's R copy among
    them), H's device time by kernel (`*_H_kernels`) and the device
    memsets' (`*_memset_in_round_ms`: H zeroes a uint16 output with one);
    and
    the categorical protocol's `--cat-rounds` rounds through lgb.train,
    as phase 36 times its 500 (0: none). `--serving-only` keeps the
    serving kernels (K1, K1-f16, K1 linear, K2, QC, searchsorted, QW, the
    int8 predict_one, ES) and builds only their libraries. The forests'
    texts are made once, under build/chip_smoke, for all the children."""
    import argparse
    ap = argparse.ArgumentParser(usage=ab_main.__doc__.splitlines()[0])
    ap.add_argument("--ab", action="append", required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--cat-rounds", type=int, default=EXPO_GATE_ROUNDS)
    ap.add_argument("--serving-only", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    if args.child:
        ab_child(args.ab[0], args.rounds, args.cat_rounds,
                 args.serving_only)
        return
    print(card_line(), flush=True)
    for root in args.ab:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        "--ab", root, "--rounds", str(args.rounds),
                        "--cat-rounds", str(args.cat_rounds)]
                       + (["--serving-only"] if args.serving_only else []),
                       check=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        ab_main(sys.argv[1:])
    else:
        main()
