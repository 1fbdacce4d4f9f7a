"""Smoke run of lightgbm_tpu_torch on one CUDA card (an H100 for this repo).

    python3 chip_smoke.py

Phases, any failure raises and the script exits non-zero:

0. device: requires CUDA; prints the card and its power limit;
1. build: compiles the kernels from lightgbm_tpu_torch/csrc with nvcc;
2. kernels vs plain: K1 forest_value_walk and K2 forest_leaf_walk against
   their plain PyTorch versions on the card, on a full-width synthetic
   HIGGS forest (500 trees x 255 leaves x 28 features, seed 0) and a
   50 x 63 forest with categorical nodes, over 16,384 rows half of which
   are edge cases: K2 must equal its plain version, K1 must equal it
   bitwise and its epilogue within 2e-7, a second run must repeat the
   bits, and 64 rows must match the f64 host oracle Tree.predict_row
   within 1e-4 relative;
3. main path: Booster(model_str=...) on the default device, predict on
   262,144 rows (value, raw_score, pred_leaf), the serving Predictor
   (warmup, 32 predict_one, 256 submit from 8 threads, stats), the model
   text round trip, and every kernel's launch count over that run; the
   whole bulk raw_score and pred_leaf output (launched in the engine's
   row chunks) must equal the plain versions on the same rows, and the
   value output must be within 2e-7 of the plain epilogue;
4. times: K1 and K2 on all 262,144 rows, in one launch and in the
   engine's row chunks, must equal their plain versions (K1 bitwise);
   then CUDA events around each kernel and its plain version at
   262,144 rows (median of 12 after warm-up), Booster.predict end to end,
   a torch.profiler breakdown of one Booster.predict (device busy time
   by kind against host wall time), Predictor latency percentiles.

The line before the last is the kernels' JSON summary, the last line
`{"ok": true, "device": {...}}`.
"""
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

TREES, LEAVES, FEATURES = 500, 255, 28
BULK_ROWS = 262_144
CHECK_ROWS = 16_384
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


def check(ok, what):
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=REPS):
    """Median of `reps` CUDA-event timings of fn() after two warm-ups."""
    for _ in range(2):
        fn()
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    booster.predict(rows)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        booster.predict(rows)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
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
    record = _build.build("forest")
    print("build: libforest.so %s in %.1f s (nvcc %.1f s)" % (
        "compiled" if record.compiled else "up to date",
        time.perf_counter() - t0, record.seconds))
    for line in record.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    _build.load_library("forest")

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
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/forest_walk.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": times[k]["ms"],
         "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
         "bound_by": times[k]["bound_by"], "library_ms": None}
        for k in ("forest_value_walk", "forest_leaf_walk")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
