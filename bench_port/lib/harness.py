"""One run of one cell: find its pieces by name, set the environment, run
its traffic driver, judge the outputs against the plain reference, read
the metrics, print the result line.

Everything a cell needs is found from ``BENCHMARK.json`` by name: the
configuration file named there, ``workloads/<cell>.json`` (the cell's own
parameters), ``traffic/<traffic>.json`` (the mix's parameters, naming its
driver ``traffic/<driver>.py``), ``reference/<arch>.py`` and, for each
per-layer metric, ``metrics/<metric>.py``.  Adding a cell, a
configuration, a mix or a metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sparkdl_tpu")
# Caches of the program's builds, at fixed paths inside the checkout so
# that only a cell's first run in a checkout compiles.
CACHE_DIRS = {"SPARKDL_COMPILE_CACHE": "compile",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton"}


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as module ``name`` (metric files carry
    dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws of run ``seed``."""
    words = np.random.SeedSequence(
        [int(seed) & (2**64 - 1), zlib.crc32(stream.encode())]
    ).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    params: dict
    reference: Any
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``."""
    bench = load_json(root / "BENCHMARK.json")
    wl = by_name(bench["workloads"], workload, "workload")
    cfg_entry = by_name(bench["configs"], wl["config"], "config")
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{wl['traffic']}.json")
    own = load_json(BENCH_DIR / "workloads" / f"{workload}.json")
    reference = importlib.import_module(
        f"bench_port.reference.{config['arch']}")

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(name=workload, chips=int(wl["chips"]), config=config,
                params={**traffic, **own}, reference=reference,
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


@dataclass
class Window:
    """What a per-layer metric's reader reads: the measured (in a traced
    run, the traced) window's length, the work finished in it, the
    program's counter deltas and timing series over it, and the trace."""

    seconds: float
    images: int = 0
    counters: Dict[str, float] = field(default_factory=dict)
    series: Dict[str, List[float]] = field(default_factory=dict)
    trace: Any = None
    config: dict = field(default_factory=dict)
    params: dict = field(default_factory=dict)


@dataclass
class Outcome:
    """A driver's report.  ``inputs`` are the distinct uint8 RGB images
    the window's requests carried; ``answers`` pairs, for each output the
    window produced, the index of its input with the row (as arrays);
    ``exact`` are counts that must be 0 (rows misplaced, requests never
    answered)."""

    setup_s: float
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    window: Window
    memory_peak_bytes: int
    inputs: np.ndarray
    answers: List[Tuple[np.ndarray, np.ndarray]]
    exact: Dict[str, int]


class Run:
    """One run's settings and the services a driver uses."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t0: float):
        self.cell = cell
        self.config = cell.config
        self.params = cell.params
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t0 = t0
        self.notes: List[str] = []
        self.marks: List[Tuple[str, float]] = [("start", t0)]
        self._weights = None

    def mark(self, phase: str) -> None:
        """End set-up phase ``phase`` now (reported on standard error)."""
        self.marks.append((phase, time.monotonic()))

    def setup_note(self) -> str:
        parts = [f"{name} {b - a:.3f}" for (_, a), (name, b)
                 in zip(self.marks, self.marks[1:])]
        return "set-up s: " + ", ".join(parts)

    def generator(self, stream: str):
        import torch

        return torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, stream))

    def numpy_rng(self, stream: str) -> np.random.Generator:
        return np.random.default_rng(sub_seed(self.seed, stream))

    def weights(self) -> Dict[str, Any]:
        """The seeded parameters, made once on the run's device."""
        if self._weights is None:
            from bench_port.lib.weights import make_weights

            self._weights = make_weights(self.cell.reference.param_specs(),
                                         self.generator("weights"),
                                         self.device)
        return self._weights

    def load_into(self, module) -> None:
        """Load the seeded parameters into the program's module through
        ``load_state_dict``; every name must match, and only BatchNorm's
        ``num_batches_tracked`` counters may be left as they are."""
        res = module.load_state_dict(self.weights(), strict=False)
        missing = [k for k in res.missing_keys
                   if not k.endswith("num_batches_tracked")]
        if missing or res.unexpected_keys:
            raise RuntimeError(f"parameter names differ from the "
                               f"reference's: missing {missing[:5]}, "
                               f"unexpected {res.unexpected_keys[:5]}")

    def window_seconds(self) -> float:
        """The measured window: ``--seconds``, or in a traced run the
        mix's shorter ``trace_seconds``."""
        if self.trace:
            return min(self.seconds, float(self.params["trace_seconds"]))
        return self.seconds

    def device_timed(self) -> bool:
        """Whether an untraced run measures the card's busy time over its
        window: the cell reports an end-to-end metric taken from the
        device's trace."""
        return not self.trace and any(m["source"] == "device_trace"
                                      for m in self.cell.end_to_end)

    @contextlib.contextmanager
    def traced(self, warm: Callable[[], None]) -> Iterator[dict]:
        """In a traced run: start the profiler, run ``warm()`` outside the
        window, then yield inside the window's range; the yielded dict
        holds the :class:`~bench_port.lib.trace.Trace` under ``"trace"``
        once the profiler has stopped.  In a device-timed run
        (:meth:`device_timed`) the same, with the window's
        :class:`~bench_port.lib.trace.Busy` under ``"busy"``.  Else just
        yield."""
        from bench_port.lib.trace import busy_profiled, profiled, window_range

        if self.trace:
            ctx = profiled()
        elif self.device_timed():
            ctx = busy_profiled()
        else:
            yield {"trace": None, "busy": None}
            return
        with ctx as box:
            warm()
            with window_range():
                yield box

    @contextlib.contextmanager
    def watch_host(self) -> Iterator[None]:
        """Note on standard error what the host did over the window: the
        interpreter's garbage-collection pauses, the process's CPU seconds
        and the machine's load."""
        import resource

        pauses: List[float] = []
        start: List[float] = []
        full: List[float] = []

        def on_gc(phase, info):
            if phase == "start":
                start.append(time.perf_counter())
            elif start:
                pauses.append(time.perf_counter() - start.pop())
                if info.get("generation") == 2:
                    full.append(pauses[-1])

        gc.callbacks.append(on_gc)
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            gc.callbacks.remove(on_gc)
            wall = time.perf_counter() - t0
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
            self.notes.append(
                f"host over the window: {len(pauses)} gc pauses, "
                f"{sum(pauses) * 1e3:.1f} ms in all, longest "
                f"{max(pauses, default=0) * 1e3:.1f} ms ({len(full)} of "
                f"generation 2, {sum(full) * 1e3:.1f} ms); process CPU "
                f"{cpu / wall:.2f} cores; load {os.getloadavg()[0]:.2f} "
                f"on {os.cpu_count()} cores")

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def counter_deltas(before: Dict[str, float],
                   after: Dict[str, float]) -> Dict[str, float]:
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def free_program() -> None:
    """Drop the program's cached models and engines and return their
    memory, before the reference runs."""
    from sparkdl_tpu_torch.transformers.named_image import clear_model_caches
    import torch

    clear_model_caches()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_rows(run: Run, images: np.ndarray, quant=None,
                   block: int = 64) -> np.ndarray:
    """The plain reference at the cell's cut over ``images`` (uint8 RGB),
    ``block`` rows at a time on the run's device; ``quant`` computes it in
    a lower precision (the control)."""
    import torch

    featurize = run.params["output"] == "features"
    out = []
    w = run.weights()
    with torch.no_grad():
        for lo in range(0, len(images), block):
            x = torch.from_numpy(images[lo:lo + block]).to(run.device)
            out.append(run.cell.reference.forward(w, x, featurize, quant)
                       .float().cpu().numpy())
    return np.concatenate(out)


def row_gaps(rows: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each row's distance from its reference row over the reference
    row's norm."""
    rows = np.asarray(rows, np.float64)
    ref = np.asarray(ref, np.float64)
    return (np.linalg.norm(rows - ref, axis=1)
            / np.maximum(np.linalg.norm(ref, axis=1), 1e-30))


def judge(run: Run, out: Outcome) -> Tuple[Dict[str, Dict[str, float]], int]:
    """Every output of the window against the reference: the widest
    relative gap of a row (a non-finite row reads 1e9), and the exact
    counts, each with its limit; and the number of rows compared."""
    ref = reference_rows(run, out.inputs)
    worst = 0.0
    compared = 0
    for idx, rows in out.answers:
        if len(idx):
            g = row_gaps(rows, ref[idx])
            worst = max(worst, float(np.where(np.isfinite(g), g, 1e9).max()))
            compared += len(idx)
    checks = {"worst_rel_gap": {
        "value": worst, "limit": float(run.params["limits"]["worst_rel_gap"])}}
    for name, n in out.exact.items():
        checks[name] = {"value": int(n), "limit": 0}
    return checks, compared


def verdict(checks: Dict[str, Dict[str, float]], compared: int) -> bool:
    """``correct``: some rows compared, and every number within its
    limit."""
    return compared > 0 and all(c["value"] <= c["limit"]
                                for c in checks.values())


def power_limit() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return proc.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_environment(root: Path, config: dict) -> None:
    """Clear the program's knobs and set what the configuration states;
    point every build cache at its fixed directory in the checkout."""
    for k in [k for k in os.environ if k.startswith("SPARKDL_")]:
        del os.environ[k]
    cache = BENCH_DIR / ".cache"
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.update(config.get("env", {}))


def set_precision(config: dict) -> None:
    import torch

    tf32 = config["precision"]["tf32"]
    torch.backends.cudnn.allow_tf32 = bool(tf32["cudnn"])
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32["matmul"])


def prepare(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, t0: float, device: Optional[str] = None,
            overrides: Optional[dict] = None) -> Run:
    """The :class:`Run` of ``workload``, with the environment and the
    precision flags set and the program importable.  ``device`` None looks
    for the cards the cell asks for and raises :class:`NoDevice` without
    them; a device name skips that look (tests).  ``overrides`` replace
    parameters of the cell (tests)."""
    cell = load_cell(root, workload)
    if overrides:
        cell.params.update(overrides)
    set_environment(root, cell.config)
    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            raise NoDevice(
                f"cell {workload} needs {cell.chips} CUDA device(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    set_precision(cell.config)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import sparkdl_tpu_torch

    sparkdl_tpu_torch.set_default_device(dev)
    return Run(cell, seed, seconds, trace, dev, t0)


def driver_of(run: Run):
    return importlib.import_module(
        f"bench_port.traffic.{run.params['driver']}")


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, t0: float, device: Optional[str] = None,
            overrides: Optional[dict] = None) -> Tuple[dict, List[str]]:
    """Run ``workload`` once (:func:`prepare` says what ``device`` and
    ``overrides`` do); returns the result line's object and the lines for
    standard error."""
    run = prepare(root, workload, seed, seconds, trace, t0, device,
                  overrides)
    cell = run.cell
    dev = run.device
    import torch

    out: Outcome = driver_of(run).run(run)
    free_program()
    checks, compared = judge(run, out)
    correct = verdict(checks, compared)
    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": int(out.attempted),
                            "failed": int(out.failed)}
    err = [run.setup_note()] + run.notes
    err.append(f"rows compared with the reference: {compared}")
    err.append(f"card: {power_limit() if dev.type == 'cuda' else 'cpu'}")
    if trace:
        w = out.window
        w.config, w.params = cell.config, cell.params
        metrics = {}
        for i, m in enumerate(cell.per_layer):
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                 f"bench_port_metric_{i}")
            v = reader.read(w)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        line["metrics"] = metrics
        tr = w.trace
        device_info["busy_s"] = tr.busy_s() if tr is not None else 0.0
        device_info["window_s"] = (tr.window_s if tr is not None
                                   else w.seconds)
        line["device"] = device_info
        if tr is not None:
            line["breakdown"] = {"device_ops": tr.top_device_ops(),
                                 "idle_gaps": tr.idle_gaps()}
    else:
        values = {**out.end_to_end, "setup_s": out.setup_s}
        missing = [m["name"] for m in cell.end_to_end
                   if values.get(m["name"]) is None]
        if missing and dev.type == "cuda":
            raise RuntimeError(f"end-to-end metrics not measured: {missing}")
        # off the card (tests) a device-timed metric has no device to read
        line["metrics"] = {
            m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] not in missing}
        line["device"] = device_info
    line["check"] = checks
    for name, c in checks.items():
        err.append(f"check {name}: {c['value']} limit {c['limit']}")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded in the run's process: {bad}")
    return line, err
