"""Unified parameter pipeline.

A verbatim copy of `lightgbm_tpu/config.py` (the port imports nothing of
the JAX package), so the same params dicts parse identically in both:
alias transform -> closed whitelist (fatal on unknown key) -> typed
nested config structs -> conflict checks deriving `is_parallel` etc.
(reference: `include/LightGBM/config.h:273-483`, `src/io/config.cpp`).
Knobs of features the port has not reached yet parse and validate the
same way; the code that would act on them raises a named error instead.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import log

# ---------------------------------------------------------------------------
# Alias table (reference: ParameterAlias::KeyAliasTransform, config.h:351-483)
# ---------------------------------------------------------------------------
ALIAS_TABLE: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "num_thread": "num_threads",
    "random_seed": "seed",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "loss": "objective",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "pre_partition": "is_pre_partition",
    "training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "eval_at": "ndcg_eval_at",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "linear_trees": "linear_tree",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "mlist": "machine_list_file",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "categorical_feature": "categorical_column",
    "cat_column": "categorical_column",
    "cat_feature": "categorical_column",
    "predict_raw_score": "is_predict_raw_score",
    "predict_leaf_index": "is_predict_leaf_index",
    "raw_score": "is_predict_raw_score",
    "leaf_index": "is_predict_leaf_index",
    "contrib": "is_predict_contrib",
    "predict_contrib": "is_predict_contrib",
    "min_split_gain": "min_gain_to_split",
    "topk": "top_k",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "num_classes": "num_class",
    "unbalanced_sets": "is_unbalance",
    "bagging_fraction_seed": "bagging_seed",
}


@dataclass
class IOConfig:
    """Reference: IOConfig, config.h:101-160."""
    max_bin: int = 255
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    output_model: str = "LightGBM_model.txt"
    output_result: str = "LightGBM_predict_result.txt"
    convert_model: str = "gbdt_prediction.cpp"
    input_model: str = ""
    verbosity: int = 1
    num_iteration_predict: int = -1
    is_pre_partition: bool = False
    is_enable_sparse: bool = True
    enable_load_from_binary_file: bool = True
    use_two_round_loading: bool = False
    is_save_binary_file: bool = False
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    has_header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_column: str = ""
    data_filename: str = ""
    valid_data_filenames: List[str] = field(default_factory=list)
    snapshot_freq: int = -1
    # preemption-tolerant training (lightgbm_tpu/checkpoint.py): when a
    # directory is set, engine.train writes a crash-consistent full-state
    # snapshot (model + RNG states + DART ledger + scores + early-stop
    # history) every tpu_checkpoint_interval iterations and resumes
    # BIT-IDENTICALLY from the newest valid one on restart. Each
    # snapshot drains the async tree pipeline and fetches the score
    # arrays off device, so very small intervals tax the hot loop
    tpu_checkpoint_dir: str = ""
    tpu_checkpoint_interval: int = 10
    tpu_checkpoint_keep: int = 3
    # storage-fault tolerance (lightgbm_tpu/durable.py): every durable
    # write (checkpoint snapshots, exported artifacts, dataset caches)
    # retries transient IO errors — tpu_io_retries extra attempts with
    # exponential backoff starting at tpu_io_backoff_s, the whole write
    # bounded by tpu_io_deadline_s seconds (0 disables the deadline).
    # Critical streams raise a structured DurableWriteError on
    # exhaustion; best-effort telemetry/heartbeat streams drop with a
    # counter instead. Fingerprint-excluded: IO policy never changes a
    # model's trajectory
    tpu_io_retries: int = 2
    tpu_io_backoff_s: float = 0.05
    tpu_io_deadline_s: float = 30.0
    # world-size-elastic resume (lightgbm_tpu/checkpoint.py +
    # boosting/gbdt.py): accept a snapshot taken at a different world
    # size (device count and/or process count) — scores are re-sharded
    # onto the new row layout and the scatter-reduce owned-group tables
    # rebuild for the new device count. Since trees are bit-identical
    # across DEVICE counts, a device-count-elastic resume stays
    # byte-identical to an uninterrupted run; across PROCESS counts the
    # exact per-row f32 state is restored but bitwise equality is not
    # guaranteed (cross-process row assembly permutes the f32 summation
    # order). false restores the strict same-shape-only refusal
    tpu_elastic_resume: bool = True
    # unified telemetry (lightgbm_tpu/telemetry/): when a directory is
    # set, training opens a structured JSONL run log there (header +
    # one record per iteration + events + summary, appended so a
    # preempted run's trail survives) and dumps the metrics registry as
    # Prometheus text exposition at end of run (one file per rank,
    # cross-rank aggregate on rank 0)
    tpu_telemetry_dir: str = ""
    # collect span timers / counters / compile events WITHOUT a run log
    # (exit dump only — the LGBM_TPU_TIMETAG behavior, config-exposed)
    tpu_telemetry: bool = False
    # write the end-of-run Prometheus exposition files (disable to keep
    # only the JSONL run log in tpu_telemetry_dir)
    tpu_telemetry_prometheus: bool = True
    # streaming ingest subsystem (lightgbm_tpu/ingest): file/array
    # construction runs as a chunked two-pass pipeline (pass 1 sketches
    # bin bounds from a streamed row sample, pass 2 re-streams and bins
    # against the frozen bounds), bit-identical to in-memory
    # construction at any chunk size; false restores the
    # load-everything-then-bin path
    tpu_ingest: bool = True
    # rows per streamed ingest chunk (pass 1 and pass 2)
    tpu_ingest_chunk_rows: int = 65536
    # land pass-2 output directly as per-device row shards under a
    # single-process data/voting-parallel mesh (host blocks are freed as
    # they ship, so the binned matrix can exceed one device's HBM)
    tpu_ingest_device_shards: bool = False
    # many-model sweep training (engine.train_sweep): declared sweep
    # width — 0 accepts whatever length of param-dict list is given;
    # > 0 must equal it (a supervisor can pin the fleet size it
    # provisioned for and have a drifted config list refused loudly)
    tpu_sweep_size: int = 0
    # registry name prefix for sweep models published without explicit
    # names: model k lands as "<prefix>/<k>" (serving.ModelRegistry)
    tpu_sweep_name_prefix: str = "sweep"
    is_predict_raw_score: bool = False
    is_predict_leaf_index: bool = False
    is_predict_contrib: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    # serving-grade prediction engine (lightgbm_tpu/serving/ +
    # boosting/gbdt.py): device-resident compiled forest cache with
    # model-version invalidation — trees are stacked/transferred once
    # per model version instead of per predict call
    tpu_predict_cache: bool = True
    # smallest row bucket of the power-of-two dispatch ladder; batch
    # sizes pad up the ladder so arbitrary sizes hit a handful of
    # compiled programs (<= 0 disables bucketing: every distinct batch
    # size compiles its own program, the seed behavior)
    tpu_predict_bucket_min: int = 16
    # rows per predict dispatch chunk (0 = auto: 512k matmul / 128k walk
    # — large forests over >=500k-row walk dispatches fault the
    # relay-attached TPU worker, see boosting/gbdt.py)
    tpu_predict_chunk: int = 0
    # double-buffered chunk loop: dispatch chunk k+1 before fetching
    # chunk k so H2D/compute/D2H overlap instead of serializing
    tpu_predict_pipeline: bool = True
    # quantized device-resident forest layouts (serving/forest.py +
    # ops/predict.py): "none" serves the bit-exact f32 stacks; "f16"
    # stores leaf values f16 and the ±1 path/category tables bf16
    # (split decisions stay bit-exact); "int8" additionally codes split
    # thresholds fixed-point against the per-feature bound grids frozen
    # at dataset build (8-bit code space) and evaluates with a single
    # default-precision selection einsum. Applies to raw-score/value
    # prediction; pred_leaf and prediction early stop keep exact f32
    tpu_predict_quantize: str = "none"
    # build-time accuracy gate for quantized layouts: max |raw-score
    # delta| vs the f32 stack on a calibration batch, relative to the
    # batch's score scale (floored at 1); a lossier layout raises
    # instead of silently serving
    tpu_predict_quantize_tol: float = 0.01
    # serving.ModelRegistry device-memory budget for compiled stacks
    # across all resident models, in MiB (0 = unlimited); the registry
    # LRU-evicts idle models' stacks past it
    tpu_serving_budget_mb: float = 0.0
    # admission control (serving/admission.py; all 0 = off, the
    # pre-admission unbounded behavior): max queued submit() requests
    # per predictor — past it new requests are refused with a
    # structured retriable ServingOverload instead of queueing late
    tpu_serving_max_queue: int = 0
    # max concurrent synchronous predict() calls per predictor
    tpu_serving_max_inflight: int = 0
    # default per-request deadline: a request whose estimated queue
    # wait (EWMA) exceeds it is shed at admission, and one that expires
    # while queued is failed with DeadlineExceeded before any device
    # work; per-call deadline_ms= overrides this
    tpu_serving_deadline_ms: float = 0.0
    # per-model QPS isolation in serving.ModelRegistry: token-bucket
    # rate per published model (tokens/s, burst = one second's worth;
    # 0 = unlimited) — a hot model sheds with "rate_limited" instead of
    # starving the other resident models
    tpu_serving_model_qps: float = 0.0
    # per-model circuit breaker: consecutive predict failures before
    # the breaker opens (overload rejections never count); 0 = off,
    # the default — like every other admission knob, pre-admission
    # behavior is exactly reproduced unless explicitly armed
    tpu_serving_breaker_failures: int = 0
    # seconds the breaker stays open before half-opening for a single
    # probe; failed probes re-open with exponential backoff
    tpu_serving_breaker_reset_s: float = 5.0
    # persistent XLA compilation cache directory: the shape-bucket
    # ladder's compiled programs are written here, so a restarted
    # trainer or serving replica warms from disk instead of re-tracing
    # (overrides the package-level LIGHTGBM_TPU_COMPILE_CACHE_DIR
    # default; empty = leave the package default in place)
    tpu_compile_cache_dir: str = ""
    # Predictor.warmup() compiles bucket programs up to this many rows
    tpu_predict_warmup_rows: int = 4096
    # Predictor.submit() coalesces up to this many concurrent single-row
    # requests into one device dispatch (0 = no micro-batching)
    tpu_predict_micro_batch: int = 32
    # how long submit() waits for co-arriving rows before dispatching
    tpu_predict_micro_batch_window_ms: float = 0.5
    # exported-forest artifacts (lightgbm_tpu/export): directory to write
    # a self-contained StableHLO artifact after training (empty = no
    # export); serving replicas load it without the training stack
    tpu_export_dir: str = ""
    # comma-separated quantized layouts to export alongside f32
    # ("none" always included): e.g. "f16,int8"; "none" = f32 only
    tpu_export_layouts: str = "none"
    # number of power-of-two row buckets to export, starting at
    # tpu_predict_bucket_min (4 -> buckets of 16/32/64/128 rows)
    tpu_export_buckets: int = 4
    use_missing: bool = True
    zero_as_missing: bool = False
    sparse_threshold: float = 0.8
    init_score_file: str = ""
    valid_init_score_file: List[str] = field(default_factory=list)


@dataclass
class TreeConfig:
    """Reference: TreeConfig, config.h:162-230."""
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    num_leaves: int = 31
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    max_depth: int = -1
    top_k: int = 20
    max_cat_threshold: int = 256
    histogram_pool_size: float = -1.0
    # piecewise-linear leaves (reference: linear_tree, config.h +
    # linear_tree_learner.cpp): fit a ridge regression per leaf over the
    # features split on along the leaf's root path, replacing the
    # constant output with intercept + coeff . x (lightgbm_tpu/linear/)
    linear_tree: bool = False
    # L2 on the fitted SLOPES only (the intercept is never penalized);
    # the reference's linear_lambda
    linear_lambda: float = 0.0
    # per-leaf design width cap: the first tpu_linear_max_features
    # DISTINCT root-path split features, nearest the leaf first — the
    # static [L, k] shape every linear kernel is compiled against
    tpu_linear_max_features: int = 5
    # TPU-specific knobs (no reference analogue; gpu_* kept for API compat)
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    # rows per histogram chunk step; 64k measured ~25% faster than 32k
    # on narrow shapes (r4, the group-block plan bounds the working set
    # so the chunk no longer needs to)
    tpu_hist_chunk: int = 65536
    tpu_double_precision: bool = False
    # speculative-expansion width (learner/grow.py): nodes expanded per
    # histogram pass; 1 = one data pass per split. 12 fills the 128-lane
    # MXU output tile (2*12*(3+2) channels) and measured fastest on-chip
    tpu_batch_k: int = 12
    # bf16 hi+lo MXU histogram contraction (ops/histogram.py)
    tpu_hist_bf16: bool = True
    # sibling subtraction via a per-node histogram cache (the reference
    # HistogramPool + FeatureHistogram::Subtract economics,
    # feature_histogram.hpp:64-70,380-548): build only the smaller
    # child's histogram per expansion. Auto-disabled when the cache
    # would exceed its device-memory budget (boosting/gbdt.py).
    tpu_hist_subtract: bool = True
    # gather-compacted small-node contraction (learner/grow.py): when
    # one expansion pass's selected nodes jointly hold at most
    # tpu_compact_threshold * N in-bag rows, compact their row indices
    # and contract only the gathered subset — late-tree passes then cost
    # O(rows-in-selected-nodes) instead of O(N) (the reference's
    # DataPartition economics, data_partition.hpp:94-170). On for the
    # serial and data/voting-parallel learners; the feature-parallel
    # learner ignores it (routing reads the replicated matrix through a
    # traced shard offset)
    tpu_hist_compact: bool = True
    # switch threshold and compaction-buffer capacity as a row fraction
    # (rounded up to a chunk multiple; >= 1.0 forces compaction,
    # <= 0 disables it)
    tpu_compact_threshold: float = 0.25
    # data-parallel histogram merge collective (parallel/learners.py +
    # learner/grow.py): "scatter" (default) ReduceScatters the per-pass
    # histograms over the stored-group axis — each device owns
    # groups/num_devices of the reduced tensor and finds splits only on
    # its owned feature slice, with the global best merged by an
    # allreduce-argmax (the reference data-parallel design,
    # data_parallel_tree_learner.cpp:148-163) — cutting per-device
    # collective bytes AND split-scan FLOPs ~num_devices x. "allreduce"
    # restores the full-psum schedule (every device scores every feature
    # redundantly). Trees are bit-identical either way; voting keeps its
    # elected-slice exchange and ignores this
    tpu_hist_reduce: str = "scatter"
    # quantized-gradient training (ops/histogram.py + learner/grow.py):
    # per-iteration grad/hess vectors scaled and stochastically rounded
    # to narrow integers (deterministic per-(seed, iteration) rounding
    # keys; the draw rides the serial (n,) shape so results are
    # world-size-invariant), histograms accumulated in exact int32 off
    # bf16 integer contractions — int8 contracts 3 channels instead of
    # the f32 path's 5 (hi+lo), int16 keeps 5 but stays exact via
    # base-256 digits. Split structure is guarded by the train-time
    # accuracy gate below; under the data-parallel scatter schedule a
    # constant-hessian objective additionally ships 2/3 the collective
    # bytes per pass. "none" is bit-identical to the f32 path.
    tpu_hist_quantize: str = "none"
    # train-time accuracy gate for tpu_hist_quantize (the serving-side
    # tpu_predict_quantize_tol pattern): at init, one calibration tree
    # is grown quantized AND f32 on a leading row slice; if the max
    # per-row leaf-value delta (relative to the f32 trees' value scale)
    # exceeds this tolerance the config is REFUSED with a named error
    # instead of silently training lossy
    tpu_hist_quantize_tol: float = 0.5
    # RETIRED (accepted for compat, warns): the hand-written pallas
    # histogram kernel measured slower than XLA's own fusion of the
    # one-hot compare into the dot (14.4 vs 11.1 ms/pass at 2M x 28 x 64)
    # and was removed; see profiles/README.md for the postmortem
    tpu_hist_pallas: bool = False


@dataclass
class ObjectiveConfig:
    """Reference: ObjectiveConfig, config.h:232-252."""
    is_unbalance: bool = False
    sigmoid: float = 1.0
    huber_delta: float = 1.0
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    gaussian_eta: float = 1.0
    scale_pos_weight: float = 1.0
    boost_from_average: bool = True
    label_gain: List[float] = field(default_factory=list)
    max_position: int = 20
    num_class: int = 1


@dataclass
class MetricConfig:
    """Reference: MetricConfig, config.h:254-264."""
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    ndcg_eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    metric_types: List[str] = field(default_factory=list)


@dataclass
class NetworkConfig:
    """Reference: NetworkConfig, config.h:266-276. On TPU the 'machines' are
    mesh devices/hosts; socket options are accepted for compat but unused."""
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    # collective watchdog (lightgbm_tpu/parallel/watchdog.py): deadline,
    # in seconds, for every host-level collective dispatch (grower
    # per-pass dispatch, multihost allgather/agree, telemetry
    # aggregation). On expiry the rank dumps per-thread stacks + a
    # structured rank_failure event and exits with rc 113
    # (watchdog.RC_RANK_FAILURE) instead of hanging on a dead peer.
    # 0 disables. Must exceed worst-case XLA compile time: the first
    # dispatch of a new shape compiles under the guard
    tpu_collective_timeout_s: float = 0.0
    # per-rank heartbeat/failure evidence directory: each rank writes
    # heartbeat_r<rank>.json on every grower dispatch and training
    # iteration, and rank_failure_r<rank>.json on watchdog expiry — the
    # lease view an external supervisor (scripts/elastic_smoke.py)
    # reads to tell WHICH rank died and why
    tpu_heartbeat_dir: str = ""
    # heartbeat lease duration: a supervisor declares a rank dead when
    # its heartbeat is older than this (stamped into the heartbeat file
    # so readers need no config)
    tpu_heartbeat_lease_s: float = 60.0


@dataclass
class BoostingConfig:
    """Reference: BoostingConfig, config.h:278-330."""
    output_freq: int = 1
    num_iterations: int = 100
    bagging_seed: int = 3
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    learning_rate: float = 0.1
    early_stopping_round: int = 0
    # DART
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    # GOSS
    top_rate: float = 0.2
    other_rate: float = 0.1
    # raise a descriptive error when an objective emits NaN/Inf
    # gradients/hessians or a metric evaluates non-finite, instead of
    # silently growing garbage trees for the rest of the run
    tpu_guard_nonfinite: bool = True


# ---------------------------------------------------------------------------
# tpu_* validation spec — machine-checked by graftlint's config-hygiene
# rule: EVERY tpu_* dataclass field above must have exactly one entry
# here (and appear in docs/Parameters.md and in checkpoint.py's
# fingerprint classification). check_param_conflict applies the table
# generically, so no tpu_* knob can ship without a validation decision.
# Forms:
#   "bool" / "path" / "str"        — type-validated by the parse pipeline
#   ("int"|"float", lo, hi)        — inclusive bounds, None = unbounded
#   ("float>", lo)                 — exclusive lower bound
#   ("choice", opt, ...)           — lowercased membership
# ---------------------------------------------------------------------------
TPU_PARAM_SPEC = {
    # checkpointing / elasticity
    "tpu_checkpoint_dir": "path",
    "tpu_checkpoint_interval": ("int", 1, None),
    "tpu_checkpoint_keep": ("int", 1, None),
    "tpu_elastic_resume": "bool",
    # durable-IO retry policy
    "tpu_io_retries": ("int", 0, None),
    "tpu_io_backoff_s": ("float", 0.0, None),
    "tpu_io_deadline_s": ("float", 0.0, None),
    # telemetry
    "tpu_telemetry_dir": "path",
    "tpu_telemetry": "bool",
    "tpu_telemetry_prometheus": "bool",
    # ingest
    "tpu_ingest": "bool",
    "tpu_ingest_chunk_rows": ("int", 1, None),
    "tpu_ingest_device_shards": "bool",

    "tpu_sweep_size": ("int", 0, None),
    "tpu_sweep_name_prefix": "str",
    # predict / serving tier
    "tpu_predict_cache": "bool",
    "tpu_predict_bucket_min": ("int", None, None),   # <= 0 disables
    "tpu_predict_chunk": ("int", 0, None),
    "tpu_predict_pipeline": "bool",
    # must mirror serving/forest.QUANTIZE_MODES (kept literal so the
    # table stays import-free and AST-readable)
    "tpu_predict_quantize": ("choice", "none", "f16", "int8"),
    "tpu_predict_quantize_tol": ("float>", 0.0),
    "tpu_predict_warmup_rows": ("int", 0, None),
    "tpu_predict_micro_batch": ("int", 0, None),
    "tpu_predict_micro_batch_window_ms": ("float", 0.0, None),
    "tpu_serving_budget_mb": ("float", 0.0, None),
    "tpu_serving_max_queue": ("int", 0, None),
    "tpu_serving_max_inflight": ("int", 0, None),
    "tpu_serving_deadline_ms": ("float", 0.0, None),
    "tpu_serving_model_qps": ("float", 0.0, None),
    "tpu_serving_breaker_failures": ("int", 0, None),
    "tpu_serving_breaker_reset_s": ("float", 0.0, None),
    "tpu_compile_cache_dir": "path",
    # exported-forest artifacts
    "tpu_export_dir": "path",
    "tpu_export_layouts": "str",
    "tpu_export_buckets": ("int", 1, None),
    # tree / histogram schedule
    "tpu_hist_chunk": ("int", 1, None),
    "tpu_double_precision": "bool",
    "tpu_batch_k": ("int", 1, None),
    "tpu_hist_bf16": "bool",
    "tpu_hist_subtract": "bool",
    "tpu_hist_compact": "bool",
    "tpu_compact_threshold": ("float", None, None),  # <= 0 disables
    "tpu_hist_reduce": ("choice", "scatter", "allreduce"),
    # must mirror ops/histogram.TRAIN_QUANTIZE_MODES (kept literal so the
    # table stays import-free and AST-readable)
    "tpu_hist_quantize": ("choice", "none", "int16", "int8"),
    "tpu_hist_quantize_tol": ("float>", 0.0),
    "tpu_hist_pallas": "bool",                       # retired, warns
    # piecewise-linear leaves
    "tpu_linear_max_features": ("int", 1, None),
    # boosting
    "tpu_guard_nonfinite": "bool",
    # network / watchdog
    "tpu_collective_timeout_s": ("float", 0.0, None),
    "tpu_heartbeat_dir": "path",
    "tpu_heartbeat_lease_s": ("float", 0.0, None),
}


_BOOL_TRUE = {"true", "1", "yes", "y", "t", "+"}
_BOOL_FALSE = {"false", "0", "no", "n", "f", "-"}


def _parse_value(value: Any, target_type: type):
    if target_type is bool:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in _BOOL_TRUE:
            return True
        if s in _BOOL_FALSE:
            return False
        log.fatal("Cannot parse '%s' as bool" % value)
    if target_type is int:
        return int(float(value)) if not isinstance(value, int) else value
    if target_type is float:
        return float(value)
    if target_type is str:
        return str(value)
    return value


def _parse_list(value: Any, elem_type: type) -> list:
    if isinstance(value, (list, tuple)):
        return [_parse_value(v, elem_type) for v in value]
    s = str(value).strip()
    if not s:
        return []
    return [_parse_value(v, elem_type) for v in s.replace(",", " ").split()]


@dataclass
class Config:
    """Overall config (reference: OverallConfig, config.h:332-349)."""
    task: str = "train"
    device: str = "tpu"
    seed: Optional[int] = None
    num_threads: int = 0
    boosting_type: str = "gbdt"
    objective: str = "regression"
    tree_learner: str = "serial"
    data: str = ""
    valid_data: List[str] = field(default_factory=list)
    io: IOConfig = field(default_factory=IOConfig)
    tree: TreeConfig = field(default_factory=TreeConfig)
    boosting: BoostingConfig = field(default_factory=BoostingConfig)
    objective_config: ObjectiveConfig = field(default_factory=ObjectiveConfig)
    metric: MetricConfig = field(default_factory=MetricConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    is_parallel: bool = False
    is_parallel_find_bin: bool = False
    raw_params: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    @classmethod
    def from_params(cls, params: Dict[str, Any]) -> "Config":
        params = key_alias_transform(params)
        cfg = cls()
        cfg.raw_params = dict(params)
        sections = [cfg.io, cfg.tree, cfg.boosting, cfg.objective_config,
                    cfg.metric, cfg.network]
        list_fields = {
            "valid_data": str, "valid_data_filenames": str,
            "ndcg_eval_at": int, "metric_types": str, "label_gain": float,
            "valid_init_score_file": str,
        }
        top_fields = {f.name: f.type for f in dataclasses.fields(cls)
                      if f.name not in ("io", "tree", "boosting", "objective_config",
                                        "metric", "network", "raw_params")}
        for key, value in params.items():
            if key in ("config_file",):
                continue
            if key == "metric":
                cfg.metric.metric_types = [m for m in _parse_list(value, str)]
                continue
            if key == "verbose":
                cfg.io.verbosity = _parse_value(value, int)
                continue
            if key == "machine_list_file":
                cfg.network.machine_list_filename = str(value)
                continue
            if key == "valid_data":
                cfg.valid_data = _parse_list(value, str)
                cfg.io.valid_data_filenames = cfg.valid_data
                continue
            if key == "data":
                cfg.data = str(value)
                cfg.io.data_filename = str(value)
                continue
            if key == "poission_max_delta_step":  # reference typo kept as alias
                cfg.objective_config.poisson_max_delta_step = _parse_value(value, float)
                continue
            placed = False
            if key in top_fields and key != "seed":
                setattr(cfg, key, _parse_value(value, type(getattr(cfg, key))))
                placed = True
            elif key == "seed":
                cfg.seed = _parse_value(value, int)
                placed = True
            else:
                for sec in sections:
                    if hasattr(sec, key):
                        cur = getattr(sec, key)
                        if isinstance(cur, list):
                            setattr(sec, key, _parse_list(value, list_fields.get(key, str)))
                        else:
                            setattr(sec, key, _parse_value(value, type(cur)))
                        placed = True
                        break
            if not placed:
                log.fatal("Unknown parameter: %s" % key)
        cfg._apply_seed()
        cfg.check_param_conflict()
        return cfg

    def _apply_seed(self) -> None:
        """A single `seed` fans out to all sub-seeds (reference: config.cpp)."""
        if self.seed is not None:
            s = self.seed
            self.io.data_random_seed = s + 1
            self.tree.feature_fraction_seed = s + 2
            self.boosting.bagging_seed = s + 3
            self.boosting.drop_seed = s + 4

    def check_param_conflict(self) -> None:
        """Reference: OverallConfig::CheckParamConflict, config.cpp:188-230."""
        if self.network.num_machines > 1:
            self.is_parallel = True
        if self.tree_learner == "serial":
            if self.network.num_machines > 1:
                log.warning("num_machines>1 with tree_learner=serial; "
                            "forcing num_machines=1")
            self.network.num_machines = 1
            self.is_parallel = False
        if self.is_parallel and self.tree_learner in ("data", "voting"):
            self.is_parallel_find_bin = True
        self._validate_tpu_params()
        if self.tree.histogram_pool_size >= 0 and self.tree_learner != "serial":
            log.warning("histogram_pool_size is only supported by serial "
                        "tree learner; ignoring")
            self.tree.histogram_pool_size = -1
        if self.objective in ("lambdarank",) and not self.objective_config.label_gain:
            # default label gain = 2^i - 1 (reference: config.cpp)
            self.objective_config.label_gain = [float((1 << i) - 1) for i in range(31)]
        if self.tree.num_leaves < 2:
            log.fatal("num_leaves must be >= 2")

    def _validate_tpu_params(self) -> None:
        """Apply TPU_PARAM_SPEC to every tpu_* field generically (the
        config-hygiene static-analysis rule keeps the table complete;
        an unspecced field is fatal here too, so the invariant holds
        even when the lint does not run)."""
        for sec in (self.io, self.tree, self.boosting,
                    self.objective_config, self.metric, self.network):
            for f in dataclasses.fields(sec):
                if not f.name.startswith("tpu_"):
                    continue
                spec = TPU_PARAM_SPEC.get(f.name)
                if spec is None:
                    log.fatal("%s has no TPU_PARAM_SPEC entry (declare "
                              "its validation in config.py)" % f.name)
                if isinstance(spec, str):
                    continue  # bool/path/str: typed by the parse pipeline
                value = getattr(sec, f.name)
                kind = spec[0]
                if kind == "choice":
                    v = str(value).lower()
                    setattr(sec, f.name, v)
                    if v not in spec[1:]:
                        log.fatal("%s must be one of %s (got %r)"
                                  % (f.name, "/".join(spec[1:]), value))
                elif kind == "float>":
                    if value <= spec[1]:
                        log.fatal("%s must be > %s (got %r)"
                                  % (f.name, spec[1], value))
                else:  # ("int"|"float", lo, hi)
                    lo, hi = spec[1], spec[2]
                    if lo is not None and value < lo:
                        log.fatal("%s must be >= %s (got %r)"
                                  % (f.name, lo, value))
                    if hi is not None and value > hi:
                        log.fatal("%s must be <= %s (got %r)"
                                  % (f.name, hi, value))


def key_alias_transform(params: Dict[str, Any]) -> Dict[str, Any]:
    """Apply aliases; explicit (non-alias) keys win on conflict
    (reference: config.h:470-482)."""
    out: Dict[str, Any] = {}
    aliased: Dict[str, Any] = {}
    for key, value in params.items():
        k = str(key)
        if k in ALIAS_TABLE:
            aliased[ALIAS_TABLE[k]] = value
        else:
            out[k] = value
    for key, value in aliased.items():
        if key not in out:
            out[key] = value
    return out


def params_str2map(text: str) -> Dict[str, str]:
    """Parse 'k1=v1 k2=v2' strings (reference: Common::Str2Map usage in c_api)."""
    out: Dict[str, str] = {}
    for token in text.replace("\n", " ").split():
        if "=" in token:
            k, v = token.split("=", 1)
            out[k.strip()] = v.strip()
    return out
