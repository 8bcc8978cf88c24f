"""Per-tenant / per-program hardware cost attribution and the
perf-regression sentinel (port of ``sparkdl_tpu/obs/cost.py``).

:class:`CostLedger` attributes every settled micro-batch to a bounded
per-``(tenant, model, program, bucket)`` line set, where

* **device seconds** are the server's metered seconds for the engine call
  (summed over retry attempts), split across the batch's tenants in
  proportion to their REAL rows over the PADDED device rows, so the pad
  tax is the exact residual, charged to a shared ``__pad__`` line, never
  to a tenant (per batch, ``sum(tenant shares) + pad residual ==
  device_s`` by construction);
* **queue seconds** are the batcher's per-request time in queue, summed
  per tenant by the server at dispatch;
* **FLOPs** are analytic: rows x ``flops_per_row`` of the (model, bucket)
  dispatch program in the port's program lockfile
  (``PROGRAMS_TORCH.lock.json``, or ``lockfile_path``); a missing or
  unreadable lockfile degrades to rows-only attribution, as the JAX
  ledger does;
* **HBM byte-seconds** multiply each attributed second by the bucket
  engine's parameter bytes on the card;
* **cache / feature / coalesced hits** charge zero device seconds but are
  itemized per tenant.

Cardinality is BOUNDED: at most ``max_tenants`` tenants are tracked
individually (ranked by attributed device seconds); the rest fold into one
``__overflow__`` tenant.  Folding merges lines: conservation sums are
unaffected.

**Regression sentinel.**  Per program, a rolling window of the last
``window`` batches yields measured device-seconds/row, compared against a
pinned baseline (:meth:`CostLedger.pin_baseline`, or auto-pinned from the
first full window) and, where FLOPs are known, against the analytic
expectation.  A crossing emits ``cost.regression`` and notes a
:class:`CostRegression` failure into the bound
:class:`~sparkdl_tpu_torch.utils.health.HealthTracker`; dropping back under
``recover_factor`` emits ``cost.recovered`` and clears the degradation,
only while ``last_error`` is still the sentinel's own.

Fault site: ``cost.attr`` fires at the top of :meth:`CostLedger.
record_batch` and :meth:`CostLedger.record_hit`: attribution is
observability, so callers wrap the charge and a failure degrades to an
error counter, never a failed request.

Gate: ``SPARKDL_COST`` (consulted once, on first use)::

    unset / "0" / "off"           -> no process-default ledger (default)
    "1" / "on"                    -> process-default ledger, default knobs
    "tenants=K,window=N,factor=F" -> custom bounds

:func:`resolve_cost` is the constructor-side rule: ``cost=None`` resolves
the process default, ``cost=False`` forces unmetered, a
:class:`CostLedger` passes through.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.utils.logging import get_logger

_inject = None


def inject(site: str) -> None:
    """``faults.inject``, bound on first use: ``obs`` is imported by
    ``faults.plan`` (flight events), so a module-level import here would
    close an import cycle whenever ``faults`` loads first."""
    global _inject
    if _inject is None:
        from sparkdl_tpu_torch.faults import inject as _bound
        _inject = _bound
    _inject(site)


logger = get_logger(__name__)

__all__ = [
    "CostLedger",
    "CostRegression",
    "OVERFLOW_TENANT",
    "PAD_TENANT",
    "configure",
    "configure_from_env",
    "cost_from_env",
    "get_default",
    "resolve_cost",
    "cost_rider",
]

#: the fold target for tenants beyond the top-``max_tenants`` by spend
OVERFLOW_TENANT = "__overflow__"
#: the shared line pad tax is charged to (never a tenant)
PAD_TENANT = "__pad__"

_OFF = ("", "0", "false", "off", "no")
_ON = ("1", "true", "on", "yes")

#: default knobs (env-configured ledgers and bare ``CostLedger()``)
DEFAULT_MAX_TENANTS = 32
DEFAULT_WINDOW = 16


class CostRegression(RuntimeError):
    """What an open per-program cost regression records into
    ``health()["last_error"]`` (never raised by the ledger — the policy
    is degrade + keep serving, the SLOViolation pattern)."""


class _Line:
    """One ``(tenant, model, program, bucket)`` accumulator."""

    __slots__ = ("rows", "device_s", "queue_s", "flops", "hbm_bytes_s",
                 "hits", "coalesced", "feature_hits")

    def __init__(self):
        self.rows = 0
        self.device_s = 0.0
        self.queue_s = 0.0
        self.flops = 0.0
        self.hbm_bytes_s = 0.0
        self.hits = 0
        self.coalesced = 0
        self.feature_hits = 0

    def merge(self, other: "_Line") -> None:
        self.rows += other.rows
        self.device_s += other.device_s
        self.queue_s += other.queue_s
        self.flops += other.flops
        self.hbm_bytes_s += other.hbm_bytes_s
        self.hits += other.hits
        self.coalesced += other.coalesced
        self.feature_hits += other.feature_hits

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rows": self.rows,
            "device_s": self.device_s,
            "queue_s": self.queue_s,
            "flops": self.flops,
            "hbm_bytes_s": self.hbm_bytes_s,
            "hits": self.hits,
            "coalesced": self.coalesced,
            "feature_hits": self.feature_hits,
        }


def _load_program_index(path: Optional[str]
                        ) -> Dict[Tuple[str, int], Dict[str, Any]]:
    """``(model, bucket_rows) -> {program, fingerprint, flops_per_row,
    bytes_accessed}`` over the lockfile's ``kind == "dispatch"`` records
    that carry a model name (``path`` default: the port's
    ``PROGRAMS_TORCH.lock.json``).  Read-only consumer: a missing or
    unreadable lockfile degrades to rows-only attribution (logged), it
    never fails a charge."""
    from sparkdl_tpu_torch.analysis.program.lockfile import (
        DEFAULT_LOCKFILE, read_lockfile)

    path = path if path is not None else DEFAULT_LOCKFILE
    try:
        doc = read_lockfile(path)
    except Exception as e:  # noqa: BLE001 — observability must degrade, not fail
        logger.info("cost ledger: no usable lockfile at %s (%s: %s); "
                    "FLOPs attribution disabled", path, type(e).__name__, e)
        return {}
    idx: Dict[Tuple[str, int], Dict[str, Any]] = {}
    for name, rec in (doc.get("programs") or {}).items():
        if rec.get("kind") != "dispatch" or not rec.get("model"):
            continue
        try:
            key = (str(rec["model"]), int(rec.get("rows") or 0))
        except (TypeError, ValueError):
            continue
        idx[key] = {
            "program": name,
            "fingerprint": rec.get("fingerprint"),
            "flops_per_row": float(rec.get("flops_per_row") or 0.0),
            "bytes_accessed": float(rec.get("bytes_accessed") or 0.0),
        }
    return idx


class CostLedger:
    """Bounded per-(tenant, model, program, bucket) hardware cost
    attribution + the per-program perf-regression sentinel (module
    docstring).  Thread-safe; one instance is shared across a fleet's
    servers.  All mutation is under one named lock (``obs.cost``);
    flight events and health transitions are emitted OUTSIDE it."""

    def __init__(self, *,
                 max_tenants: int = DEFAULT_MAX_TENANTS,
                 window: int = DEFAULT_WINDOW,
                 min_batches: int = 4,
                 regress_factor: float = 2.0,
                 recover_factor: float = 1.5,
                 analytic_slack: float = 64.0,
                 lockfile_path: Optional[str] = None,
                 health: Any = None,
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self.max_tenants = max(1, int(max_tenants))
        self.window = max(1, int(window))
        self.min_batches = max(1, min(int(min_batches), self.window))
        self.regress_factor = float(regress_factor)
        self.recover_factor = min(float(recover_factor),
                                  self.regress_factor)
        self.analytic_slack = float(analytic_slack)
        self._lockfile_path = lockfile_path
        self._lock = named_lock("obs.cost")
        self._health = health
        #: lazily-loaded lockfile dispatch-program index
        self._programs: Optional[Dict[Tuple[str, int],
                                      Dict[str, Any]]] = None
        self._lines: Dict[Tuple[str, str, str, int], _Line] = {}
        #: tenant -> attributed device seconds (the top-K ranking axis);
        #: excludes the pad line, includes ``__overflow__``
        self._tenant_spend: Dict[str, float] = {}
        self._batches = 0
        self._total_device_s = 0.0
        self._total_queue_s = 0.0
        self._total_rows = 0
        self._total_pad_rows = 0
        self._errors = 0
        # -- sentinel state, per program name --
        self._windows: Dict[str, deque] = {}
        self._baseline: Dict[str, float] = {}
        self._open: Dict[str, Dict[str, Any]] = {}
        self._s_per_flop: Optional[float] = None

    # -- health binding ----------------------------------------------------
    def bind_health(self, tracker: Any) -> None:
        """Bind the :class:`~sparkdl_tpu_torch.utils.health.HealthTracker`
        sentinel transitions feed.  First binder wins (the fleet binds
        its fleet-wide tracker before handing the shared ledger to its
        servers; a standalone server binds its own)."""
        if self._health is None and tracker is not None:
            self._health = tracker

    # -- program resolution ------------------------------------------------
    def _program_info(self, model: str, bucket: int) -> Dict[str, Any]:
        if self._programs is None:
            self._programs = _load_program_index(self._lockfile_path)
        info = self._programs.get((model, bucket))
        if info is not None:
            return info
        return {"program": f"{model}/b{bucket}", "fingerprint": None,
                "flops_per_row": 0.0, "bytes_accessed": 0.0}

    # -- charges -----------------------------------------------------------
    def record_batch(self, *, model: str, bucket: int,
                     tenant_rows: Dict[str, int],
                     device_s: float,
                     queue_s_by_tenant: Optional[Dict[str, float]] = None,
                     pad_rows: int = 0,
                     hbm_bytes: Optional[float] = None) -> None:
        """Attribute one settled micro-batch.

        ``tenant_rows`` maps tenant -> REAL rows dispatched for it this
        batch; ``device_s`` is the engine's metered call seconds
        (summed over retry attempts); ``pad_rows`` is the engine's pad
        ledger delta for the dispatch; ``hbm_bytes`` the bucket
        engine's per-chip parameter bytes.  Tenant shares are
        ``device_s * rows / (rows + pad_rows)`` and the pad line gets
        the exact float residual — per-batch conservation by
        construction.  Raises only what the ``cost.attr`` fault site
        injects (callers wrap the charge; see module docstring)."""
        if not self.enabled:
            return
        inject("cost.attr")
        model = str(model)
        bucket = int(bucket)
        total_rows = sum(int(n) for n in tenant_rows.values())
        if total_rows <= 0:
            return
        pad_rows = max(0, int(pad_rows))
        padded = total_rows + pad_rows
        device_s = float(device_s)
        queue_by = queue_s_by_tenant or {}
        info = self._program_info(model, bucket)
        program = info["program"]
        fpr = info["flops_per_row"]
        hbm = float(hbm_bytes) if hbm_bytes else 0.0
        opened: List[Dict[str, Any]] = []
        closed: List[str] = []
        with self._lock:
            attributed = 0.0
            for tenant in sorted(tenant_rows):
                rows = int(tenant_rows[tenant])
                if rows <= 0:
                    continue
                share = device_s * (rows / padded)
                attributed += share
                key_tenant = self._tenant_key(str(tenant))
                line = self._line(key_tenant, model, program, bucket)
                line.rows += rows
                line.device_s += share
                line.queue_s += float(queue_by.get(tenant, 0.0))
                line.flops += rows * fpr
                line.hbm_bytes_s += hbm * share
                self._tenant_spend[key_tenant] = (
                    self._tenant_spend.get(key_tenant, 0.0) + share)
            # pad tax: the exact residual, so per-batch conservation
            # (sum of tenant shares + pad == device_s) holds in floats
            residual = device_s - attributed
            pad_line = self._line(PAD_TENANT, model, program, bucket)
            pad_line.rows += pad_rows
            pad_line.device_s += residual
            pad_line.flops += pad_rows * fpr
            pad_line.hbm_bytes_s += hbm * residual
            self._batches += 1
            self._total_device_s += device_s
            self._total_queue_s += sum(
                float(queue_by.get(t, 0.0)) for t in tenant_rows)
            self._total_rows += total_rows
            self._total_pad_rows += pad_rows
            self._compact()
            opened, closed = self._sentinel_update(
                program, device_s, padded, fpr)
            still_open = bool(self._open)
        self._emit_transitions(opened, closed, still_open)

    def record_hit(self, *, tenant: str, model: str,
                   kind: str = "hit") -> None:
        """Charge a near-zero line for a request the cache absorbed:
        ``kind`` is ``"hit"`` (result cache), ``"coalesced"``
        (single-flight follower), or ``"feature_hit"`` (feature-cut
        short-circuit).  Zero device seconds — that is the cache's
        point — but itemized per tenant so showback sees who rode the
        warm entries."""
        if not self.enabled:
            return
        inject("cost.attr")
        field = {"hit": "hits", "coalesced": "coalesced",
                 "feature_hit": "feature_hits"}.get(kind)
        if field is None:
            raise ValueError(f"unknown cost hit kind {kind!r}")
        with self._lock:
            key_tenant = self._tenant_key(str(tenant))
            line = self._line(key_tenant, str(model), "__cache__", 0)
            setattr(line, field, getattr(line, field) + 1)
            self._tenant_spend.setdefault(key_tenant, 0.0)
            self._compact()

    def record_error(self) -> None:
        """Count a swallowed attribution failure (the caller's
        degrade-not-fail handler)."""
        with self._lock:
            self._errors += 1

    # -- internals (caller holds the lock) ---------------------------------
    def _line(self, tenant: str, model: str, program: str,
              bucket: int) -> _Line:
        key = (tenant, model, program, bucket)
        line = self._lines.get(key)
        if line is None:
            line = self._lines[key] = _Line()
        return line

    def _tenant_key(self, tenant: str) -> str:
        """Every tenant is admitted provisionally — :meth:`_compact`
        runs after the charge and folds whoever then ranks below the
        top-``max_tenants`` by spend, so a late big spender earns its
        own line while a storm tenant's one tiny charge folds straight
        back into ``__overflow__``."""
        return tenant

    def _compact(self) -> None:
        """Fold everything but the top-``max_tenants`` tenants (by
        attributed device seconds, ties broken by name — deterministic)
        into ``__overflow__``.  Conservation sums are unaffected: lines
        merge, nothing is dropped."""
        ranked = [t for t in self._tenant_spend if t != OVERFLOW_TENANT]
        if len(ranked) <= self.max_tenants:
            return
        ranked.sort(key=lambda t: (-self._tenant_spend[t], t))
        for tenant in ranked[self.max_tenants:]:
            spend = self._tenant_spend.pop(tenant)
            self._tenant_spend[OVERFLOW_TENANT] = (
                self._tenant_spend.get(OVERFLOW_TENANT, 0.0) + spend)
            for key in [k for k in self._lines if k[0] == tenant]:
                line = self._lines.pop(key)
                self._line(OVERFLOW_TENANT, key[1], key[2],
                           key[3]).merge(line)

    def _sentinel_update(self, program: str, device_s: float,
                         device_rows: int, flops_per_row: float
                         ) -> Tuple[List[Dict[str, Any]], List[str]]:
        """Roll the program's window and compute open/close transitions
        (returned for emission OUTSIDE the lock)."""
        win = self._windows.get(program)
        if win is None:
            win = self._windows[program] = deque(maxlen=self.window)
        win.append((device_s, device_rows))
        if len(win) < self.min_batches:
            return [], []
        measured = (sum(d for d, _ in win)
                    / max(1, sum(r for _, r in win)))
        baseline = self._baseline.get(program)
        if baseline is None:
            # auto-pin: the first full-enough window IS the baseline
            # (explicit pin_baseline overrides); also calibrate the
            # fleet-wide best seconds-per-FLOP rate for the analytic
            # cross-check
            self._baseline[program] = baseline = measured
            self._calibrate(baseline, flops_per_row)
            return [], []
        factor = measured / baseline if baseline > 0 else 1.0
        expected = (flops_per_row * self._s_per_flop
                    if flops_per_row > 0 and self._s_per_flop else None)
        analytic_breach = (expected is not None
                           and measured >= self.analytic_slack * expected)
        breach = factor >= self.regress_factor or analytic_breach
        opened: List[Dict[str, Any]] = []
        closed: List[str] = []
        if breach and program not in self._open:
            rec = {
                "program": program,
                "measured_s_per_row": measured,
                "baseline_s_per_row": baseline,
                "factor": round(factor, 4),
                "analytic_expected_s_per_row": expected,
                "reason": ("analytic" if analytic_breach
                           and factor < self.regress_factor
                           else "baseline"),
                "opened_batch": self._batches,
            }
            self._open[program] = rec
            opened.append(dict(rec))
        elif program in self._open:
            recovered = (factor < self.recover_factor
                         and (expected is None
                              or measured <
                              self.analytic_slack * expected))
            if recovered:
                del self._open[program]
                closed.append(program)
            else:
                self._open[program]["measured_s_per_row"] = measured
                self._open[program]["factor"] = round(factor, 4)
        return opened, closed

    def _calibrate(self, baseline_s_per_row: float,
                   flops_per_row: float) -> None:
        if flops_per_row > 0 and baseline_s_per_row > 0:
            rate = baseline_s_per_row / flops_per_row
            if self._s_per_flop is None or rate < self._s_per_flop:
                self._s_per_flop = rate

    def _emit_transitions(self, opened: List[Dict[str, Any]],
                          closed: List[str], still_open: bool) -> None:
        """Flight events + health transitions, OUTSIDE the ledger lock
        (the SLOEngine emission pattern, including its recovery guard:
        only clear a degradation the sentinel itself caused)."""
        for rec in opened:
            flight_emit("cost.regression", program=rec["program"],
                        factor=rec["factor"],
                        measured_us_per_row=round(
                            rec["measured_s_per_row"] * 1e6, 3),
                        baseline_us_per_row=round(
                            rec["baseline_s_per_row"] * 1e6, 3),
                        reason=rec["reason"])
            if self._health is not None:
                self._health.note_failure(CostRegression(
                    f"program {rec['program']!r} device-time/row "
                    f"{rec['measured_s_per_row']:.3e}s is "
                    f"{rec['factor']}x its baseline "
                    f"{rec['baseline_s_per_row']:.3e}s "
                    f"({rec['reason']} check)"))
        for program in closed:
            flight_emit("cost.recovered", program=program)
        if closed and not still_open and self._health is not None:
            last = self._health.snapshot().get("last_error")
            if last is not None and last.get("type") == "CostRegression":
                self._health.note_success()

    # -- sentinel control / queries ----------------------------------------
    def pin_baseline(self, program: Optional[str] = None,
                     s_per_row: Optional[float] = None) -> Dict[str, float]:
        """Pin the sentinel baseline: for one ``program`` (explicit
        ``s_per_row``, or its current rolling window), or for EVERY
        program with a window when ``program`` is None.  Returns the
        pinned ``{program: s_per_row}`` map."""
        pinned: Dict[str, float] = {}
        with self._lock:
            if program is not None:
                if s_per_row is None:
                    win = self._windows.get(program)
                    if not win:
                        raise ValueError(
                            f"no batches recorded for program "
                            f"{program!r}; pass s_per_row explicitly")
                    s_per_row = (sum(d for d, _ in win)
                                 / max(1, sum(r for _, r in win)))
                self._baseline[program] = float(s_per_row)
                pinned[program] = float(s_per_row)
            else:
                for name, win in sorted(self._windows.items()):
                    if not win:
                        continue
                    m = (sum(d for d, _ in win)
                         / max(1, sum(r for _, r in win)))
                    self._baseline[name] = m
                    pinned[name] = m
        return pinned

    def regressions(self) -> Dict[str, Dict[str, Any]]:
        """The OPEN per-program regressions (empty when healthy)."""
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._open.items())}

    def tenant_costs(self) -> Dict[str, float]:
        """Deterministic per-tenant cost units (the JAX twin's fairness
        axis): attributed lockfile FLOPs where the program is covered,
        attributed ROWS otherwise, never wall-measured seconds.  Excludes
        the shared pad line."""
        out: Dict[str, float] = {}
        with self._lock:
            for (tenant, _m, _p, _b), line in self._lines.items():
                if tenant == PAD_TENANT:
                    continue
                units = line.flops if line.flops > 0 else float(line.rows)
                out[tenant] = out.get(tenant, 0.0) + units
        return dict(sorted(out.items()))

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable ledger + sentinel state (the ``cost``
        section of ``varz()`` and :func:`cost_rider`'s source).  Device/
        queue seconds are NOT rounded — the conservation proof sums
        them."""
        with self._lock:
            lines = []
            tenants: Dict[str, Dict[str, Any]] = {}
            pad = _Line()
            for key in sorted(self._lines):
                tenant, model, program, bucket = key
                line = self._lines[key]
                lines.append(dict(tenant=tenant, model=model,
                                  program=program, bucket=bucket,
                                  **line.as_dict()))
                if tenant == PAD_TENANT:
                    pad.merge(line)
                    continue
                agg = tenants.get(tenant)
                if agg is None:
                    agg = tenants[tenant] = {
                        "rows": 0, "device_s": 0.0, "queue_s": 0.0,
                        "flops": 0.0, "hbm_bytes_s": 0.0, "hits": 0,
                        "coalesced": 0, "feature_hits": 0}
                for k, v in line.as_dict().items():
                    agg[k] += v
            programs: Dict[str, Dict[str, Any]] = {}
            for name in sorted(self._windows):
                win = self._windows[name]
                measured = (sum(d for d, _ in win)
                            / max(1, sum(r for _, r in win))
                            if win else None)
                programs[name] = {
                    "window_batches": len(win),
                    "measured_s_per_row": measured,
                    "baseline_s_per_row": self._baseline.get(name),
                    "regressed": name in self._open,
                }
            return {
                "totals": {
                    "batches": self._batches,
                    "rows": self._total_rows,
                    "pad_rows": self._total_pad_rows,
                    "device_s": self._total_device_s,
                    "queue_s": self._total_queue_s,
                    "pad_device_s": pad.device_s,
                    "attributed_device_s": sum(
                        l.device_s for l in self._lines.values()),
                    "hits": sum(t["hits"] for t in tenants.values()),
                    "coalesced": sum(t["coalesced"]
                                     for t in tenants.values()),
                    "feature_hits": sum(t["feature_hits"]
                                        for t in tenants.values()),
                    "attr_errors": self._errors,
                },
                "tenants": tenants,
                "pad": pad.as_dict(),
                "programs": programs,
                "sentinel": {
                    "open": {k: dict(v)
                             for k, v in sorted(self._open.items())},
                    "window": self.window,
                    "min_batches": self.min_batches,
                    "regress_factor": self.regress_factor,
                    "recover_factor": self.recover_factor,
                    "analytic_slack": self.analytic_slack,
                    "s_per_flop": self._s_per_flop,
                },
                "tracked_tenants": len([t for t in self._tenant_spend
                                        if t != OVERFLOW_TENANT]),
                "max_tenants": self.max_tenants,
                "overflow": OVERFLOW_TENANT in self._tenant_spend,
            }

    def prometheus_text(self, prefix: str = "sparkdl") -> str:
        """Labeled Prometheus text exposition of the ledger (the
        companion of ``obs.export.prometheus_text``, which cannot carry
        labels).  Deterministic line order; label cardinality is the
        ledger's own bound."""
        def esc(v: Any) -> str:
            return (str(v).replace("\\", r"\\").replace('"', r'\"')
                    .replace("\n", r"\n"))

        base = f"{prefix}_cost"
        out: List[str] = []
        metric_fields = (
            ("device_seconds_total", "device_s",
             "attributed device seconds"),
            ("rows_total", "rows", "attributed real rows"),
            ("queue_seconds_total", "queue_s", "attributed queue wait"),
            ("flops_total", "flops", "lockfile-analytic FLOPs"),
            ("hbm_byte_seconds_total", "hbm_bytes_s",
             "per-chip HBM byte-seconds"),
            ("cache_hits_total", "hits", "result-cache hits"),
            ("coalesced_total", "coalesced", "single-flight followers"),
            ("feature_hits_total", "feature_hits",
             "feature-cut short-circuits"),
        )
        with self._lock:
            keys = sorted(self._lines)
            rows = [(k, self._lines[k].as_dict()) for k in keys]
            open_programs = sorted(self._open)
        for suffix, field, help_text in metric_fields:
            name = f"{base}_{suffix}"
            out.append(f"# HELP {name} {help_text}")
            out.append(f"# TYPE {name} counter")
            for (tenant, model, program, bucket), vals in rows:
                v = vals[field]
                if not v:
                    continue
                out.append(
                    f'{name}{{tenant="{esc(tenant)}",'
                    f'model="{esc(model)}",program="{esc(program)}",'
                    f'bucket="{bucket}"}} {float(v)}')
        name = f"{base}_regression_open"
        out.append(f"# HELP {name} 1 while the program's cost "
                   f"regression is open")
        out.append(f"# TYPE {name} gauge")
        for program in open_programs:
            out.append(f'{name}{{program="{esc(program)}"}} 1')
        return "\n".join(out) + "\n"


def cost_rider(ledger: Optional[CostLedger]) -> Optional[Dict[str, Any]]:
    """The compact run rider: per-tenant spend breakdown + the
    sentinel verdict (``None`` when no ledger is live — the rider is
    omitted, not empty)."""
    if ledger is None:
        return None
    snap = ledger.snapshot()
    return {
        "tenants": {t: {"device_s": round(v["device_s"], 6),
                        "rows": v["rows"],
                        "hits": (v["hits"] + v["coalesced"]
                                 + v["feature_hits"])}
                    for t, v in snap["tenants"].items()},
        "pad_device_s": round(snap["totals"]["pad_device_s"], 6),
        "sentinel": ("regressed" if snap["sentinel"]["open"] else "ok"),
        "open_regressions": sorted(snap["sentinel"]["open"]),
    }


# -- module default (the faults.inject / SPARKDL_CACHE pattern) ------------
_UNSET = object()   # before the first ask consults SPARKDL_COST
_default: Any = _UNSET
_default_lock = named_lock("obs.cost.configure")


def cost_from_env() -> Optional[CostLedger]:
    """A :class:`CostLedger` per the ``SPARKDL_COST`` grammar (module
    docstring), or None when the knob is off/unset.  Raises on
    malformed specs — a typo must not silently disable showback."""
    spec = os.environ.get("SPARKDL_COST", "").strip().lower()
    if spec in _OFF:
        return None
    if spec in _ON:
        return CostLedger()
    kwargs: Dict[str, Any] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"SPARKDL_COST: expected 0|1|tenants=K,window=N,"
                f"factor=F, got {spec!r}")
        k, v = part.split("=", 1)
        k = k.strip()
        try:
            if k == "tenants":
                kwargs["max_tenants"] = int(v)
            elif k == "window":
                kwargs["window"] = int(v)
            elif k == "factor":
                kwargs["regress_factor"] = float(v)
            else:
                raise ValueError(f"unknown key {k!r}")
        except ValueError as e:
            raise ValueError(f"SPARKDL_COST: bad component {part!r} "
                             f"({e})") from e
    return CostLedger(**kwargs)


def configure(ledger: Optional[CostLedger]) -> Optional[CostLedger]:
    """Install ``ledger`` as the process default (None disables).
    Returns it."""
    global _default
    with _default_lock:
        _default = ledger
    return ledger


def configure_from_env() -> Optional[CostLedger]:
    """Resolve ``SPARKDL_COST`` into the process default (idempotent
    after the first call unless :func:`configure` intervenes)."""
    global _default
    with _default_lock:
        if _default is _UNSET:
            _default = cost_from_env()
        return _default


def get_default() -> Optional[CostLedger]:
    """The process-default ledger, resolving the env on first ask.
    Disabled path: one module-global read and an identity check."""
    d = _default
    if d is _UNSET:
        return configure_from_env()
    return d


def resolve_cost(cost: Any) -> Optional[CostLedger]:
    """The ONE constructor-side resolution rule (the
    ``serving.cache.resolve_cache`` pattern): ``None`` resolves the
    ``SPARKDL_COST`` process default, ``False`` forces unmetered, a
    :class:`CostLedger` passes through."""
    if cost is None:
        return get_default()
    if cost is False:
        return None
    if not isinstance(cost, CostLedger):
        raise TypeError(f"cost= expects a CostLedger, None, or False; "
                        f"got {type(cost).__name__}")
    return cost
