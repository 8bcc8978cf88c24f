"""Batch scoring over an image DataFrame: one zoo transformer's
``transform`` called back to back over the same seeded DataFrame.

Parameters (the mix's file, then the cell's): ``rows`` image structs,
``nulls`` of them null (positions drawn from the seed), ``batch_size``,
``warmup_calls`` transforms in set-up, ``transformer``
(``DeepImageFeaturizer`` or ``DeepImagePredictor``), ``output``
(``features`` or ``probabilities``) and, for traced runs,
``trace_seconds``.

``images_per_s`` counts every image of every transform started in the
window, over the time from the window's start to the last one's finish;
``images_per_device_s`` the same images over the seconds in which the
card ran a kernel, copy or memset in that window (a device-timed run).
"""

from __future__ import annotations

import gc
import resource
import time

import numpy as np

from bench_port.lib.harness import Outcome, Run, Window, counter_deltas
from bench_port.lib.images import smooth_images, struct_column
from bench_port.lib.yardstick import rate


def images_bgr(r: Run) -> np.ndarray:
    """The frame's images, as the structs' BGR bytes."""
    h, w = r.config["input_size"]
    return smooth_images(int(r.params["rows"]), h, w, r.generator("images"),
                         r.device).cpu().numpy()


def reference_inputs(r: Run) -> np.ndarray:
    """Every image of the frame in RGB, as the reference reads it."""
    return np.ascontiguousarray(images_bgr(r)[..., ::-1])


def run(r: Run) -> Outcome:
    import pyarrow as pa
    from torch.profiler import record_function

    from sparkdl_tpu_torch.frame import DataFrame
    from sparkdl_tpu_torch.transformers import named_image

    p = r.params
    name = r.config["model"]
    rows, batch = int(p["rows"]), int(p["batch_size"])
    featurize = p["output"] == "features"
    r.mark("imports")
    bgr = images_bgr(r)
    valid = np.ones(rows, bool)
    valid[r.numpy_rng("nulls").choice(rows, int(p["nulls"]),
                                      replace=False)] = False
    df = DataFrame(pa.table({"image": struct_column(bgr, valid)}))
    r.mark("inputs")
    _, module, _ = named_image.zoo_serving_bundle(name, featurize)
    r.load_into(module)
    r.mark("model and weights")
    cls = getattr(named_image, p["transformer"])
    tr = cls(inputCol="image", outputCol="out", modelName=name,
             batchSize=batch)
    for _ in range(int(p["warmup_calls"])):
        tr.transform(df)
    engine = named_image._zoo_engine(name, featurize, batch)
    metrics = engine.metrics
    r.mark("warm-up transforms")
    setup_s = time.monotonic() - r.t0

    seconds = r.window_seconds()
    outs = []
    calls = []
    full_gcs = []
    host = []
    with r.traced(lambda: tr.transform(df)) as box, r.watch_host():
        before = dict(metrics.counters)
        metrics.reset_series()
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            g2 = gc.get_stats()[2]["collections"]
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            with record_function("bench.transform"):
                outs.append(tr.transform(df).table.column("out"))
            calls.append(time.perf_counter() - t_end)
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            full_gcs.append(gc.get_stats()[2]["collections"] - g2)
            host.append((ru1.ru_utime - ru0.ru_utime,
                         ru1.ru_stime - ru0.ru_stime,
                         ru1.ru_minflt - ru0.ru_minflt,
                         ru1.ru_nivcsw - ru0.ru_nivcsw))
            t_end = time.perf_counter()
        raw = metrics.snapshot_raw()
    r.notes.append("transform s: " + " ".join(f"{c:.3f}" for c in calls))
    r.notes.append("generation-2 collections a transform: "
                   + " ".join(str(n) for n in full_gcs))
    r.notes.append("process CPU s a transform, user/system, minor faults, "
                   "involuntary switches: " + " ".join(
                       f"{u:.3f}/{s:.3f},{f},{c}" for u, s, f, c in host))
    elapsed = t_end - t0
    peak = r.memory_peak()
    del tr, engine, module
    n_valid = int(valid.sum())
    images = n_valid * len(outs)
    end_to_end = {"images_per_s": rate(images, t0, t_end)}
    busy = box.get("busy")
    if busy is not None:
        r.notes.append(
            f"card busy {busy.busy_s:.6f} s of a {busy.window_s:.6f} s "
            f"window; device records {busy.records / images:.3f} an image "
            f"in it, {busy.records_before / n_valid:.3f} in the warm "
            f"transform")
        if busy.records:
            # Kineto drops what passes its buffers: fewer records an
            # image than the warm transform left would hide device time
            if busy.records / images < 0.98 * busy.records_before / n_valid:
                raise RuntimeError("the profiler lost device records in "
                                   "the window")
            end_to_end["images_per_device_s"] = images / busy.busy_s
    window = Window(seconds=elapsed, images=images,
                    counters=counter_deltas(before, raw["counters"]),
                    series={**raw["timings_s"], **raw["histograms"]},
                    trace=box.get("trace"))

    idx = np.nonzero(valid)[0]
    answers, misplaced, missing = [], 0, 0
    for col in outs:
        col = col.combine_chunks()
        got = np.asarray(col.is_valid())
        if len(got) != rows:
            misplaced += rows
            missing += n_valid
            continue
        misplaced += int((got != valid).sum())
        missing += int((~got[idx]).sum())
        if not got[idx].all():
            continue
        vals = col.filter(pa.array(valid)).flatten().to_numpy(
            zero_copy_only=False)
        answers.append((idx, vals.reshape(len(idx), -1)))
    return Outcome(setup_s=setup_s,
                   end_to_end=end_to_end,
                   attempted=images, failed=missing, window=window,
                   memory_peak_bytes=peak,
                   inputs=np.ascontiguousarray(bgr[..., ::-1]),
                   answers=answers, exact={"misplaced_rows": misplaced})
