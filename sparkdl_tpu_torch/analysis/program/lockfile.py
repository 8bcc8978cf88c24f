"""``PROGRAMS_TORCH.lock.json`` — the port's committed program lockfile
(port of ``sparkdl_tpu/analysis/program/lockfile.py``, schema version 1).

One JSON document records every audited program of the port (the sha256
of its meta-traced call list, FLOPs, bytes, donation map, dtype-mix
counters, input key, sharding summary, kernel launches, outputs).
``diff_records`` classifies any divergence between the committed baseline
and a fresh audit into the GC rule whose invariant moved: a dropped
donation is GC001, an f32 upcast or a lost kernel is GC002, a new input
key is GC003, pad growth is GC004, a sharding change is GC005, anything
else is GC000 fingerprint drift.  ``meta`` records ``torch_version``
where JAX's records ``jax_version``.

This module is import-light on purpose (stdlib json only, no torch): the
serving cache, the cost ledger and the compile cache read the lockfile
through it in every process.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

from sparkdl_tpu_torch.analysis.core import Finding

DEFAULT_LOCKFILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    "PROGRAMS_TORCH.lock.json")

SCHEMA_VERSION = 1

#: drift classification: first differing field group wins, most
#: actionable first (donation before dtype before keys before cost)
_FIELD_RULES = (
    ("GC001", ("donation",)),
    ("GC002", ("dtype_counts", "compute_dtype", "kernels")),
    ("GC003", ("in_avals", "group")),
    ("GC004", ("flops", "rows", "flops_per_row", "bucket")),
    ("GC005", ("sharding_summary", "mesh_axes")),
)


def write_lockfile(records: Sequence[Dict[str, Any]], path: str,
                   meta: Optional[Dict[str, Any]] = None) -> None:
    doc = {
        "schema_version": SCHEMA_VERSION,
        "meta": dict(meta or {}),
        "programs": {rec["name"]: {k: v for k, v in sorted(rec.items())
                                   if k != "name"}
                     for rec in records},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def read_lockfile(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: unsupported lockfile schema "
            f"{doc.get('schema_version')!r} (expected {SCHEMA_VERSION}); "
            f"regenerate with tools/port_graftcheck.py --write-baseline")
    return doc


def _norm(value: Any) -> Any:
    """JSON round-trip normalization so fresh records compare equal to
    committed ones (tuples become lists, dict key order is irrelevant)."""
    return json.loads(json.dumps(value, sort_keys=True))


def diff_records(committed: Dict[str, Any],
                 current: Sequence[Dict[str, Any]],
                 subset: bool = False) -> List[Finding]:
    """Classified drift between the committed lockfile document and a
    fresh audit's records.  ``subset=True`` (the tier-1 acceptance gate
    audits a handful of programs) skips the missing-program check for
    programs the fresh audit did not enumerate."""
    findings: List[Finding] = []
    baseline = committed.get("programs", {})
    fresh = {rec["name"]: rec for rec in current}
    for name, rec in sorted(fresh.items()):
        base = baseline.get(name)
        if base is None:
            findings.append(Finding(
                "GC003", name, 0,
                "program not in the committed lockfile — a new compiled "
                "program entered the stack; review it and regenerate "
                "the baseline (tools/port_graftcheck.py --write-baseline)"))
            continue
        rule = None
        moved = []
        for code, fields in _FIELD_RULES:
            for f in fields:
                if _norm(rec.get(f)) != _norm(base.get(f)):
                    moved.append(f)
                    rule = rule or code
        if moved:
            findings.append(Finding(
                rule, name, 0,
                f"program drifted from the committed lockfile in "
                f"{', '.join(moved)} — "
                f"{GC_DRIFT_HINTS.get(rule, 'review the change')}"))
        elif _norm(rec.get("fingerprint")) != _norm(base.get("fingerprint")):
            findings.append(Finding(
                "GC000", name, 0,
                "program fingerprint (meta-traced call list) drifted with "
                "no tracked field moving (op-level program change); review "
                "and regenerate the baseline if deliberate"))
    if not subset:
        for name in sorted(set(baseline) - set(fresh)):
            findings.append(Finding(
                "GC003", name, 0,
                "program in the committed lockfile was not enumerated "
                "by this audit — a compiled program silently left the "
                "stack (or the inventory shrank); regenerate the "
                "baseline if deliberate"))
    return findings


GC_DRIFT_HINTS = {
    "GC001": "a donation was added/dropped or stopped aliasing",
    "GC002": "the op dtype mix changed (bf16/f32 regression?)",
    "GC003": "the executable cache key changed (retrace/recompile)",
    "GC004": "FLOPs / pad accounting moved",
    "GC005": "sharding layout changed",
}


def pad_gap_fracs(buckets: Sequence[int]) -> List[tuple]:
    """``[(prev, b, waste_frac)]`` per adjacent bucket pair — THE one
    spelling of GC004's interior pad-waste formula (a request of
    ``prev + 1`` rows served by bucket ``b`` wastes ``(b - prev - 1)/b``
    of the program), which ``audit.pad_waste_audit`` budgets."""
    bs = sorted(int(b) for b in buckets)
    return [(prev, b, (b - prev - 1) / b) for prev, b in zip(bs, bs[1:])]


def pad_worst_fracs(buckets: Sequence[int]) -> tuple:
    """``(interior_worst, floor)`` for a bucket set: the worst adjacent
    gap from :func:`pad_gap_fracs`, and GC004's floor formula (a 1-row
    request padded to the smallest bucket pays ``(b0 - 1)/b0``)."""
    bs = sorted(int(b) for b in buckets)
    interior = max((w for _, _, w in pad_gap_fracs(bs)), default=0.0)
    return interior, (bs[0] - 1) / bs[0]


def zoo_gflop_per_img(path: Optional[str] = None) -> Dict[str, float]:
    """Per-model GFLOPs/image derived from the committed lockfile (the
    largest audited bucket of each zoo featurize program).  Returns
    ``{}`` when no lockfile exists."""
    path = path or DEFAULT_LOCKFILE
    if not os.path.isfile(path):
        return {}
    try:
        doc = read_lockfile(path)
    except (ValueError, OSError, json.JSONDecodeError):
        return {}
    best: Dict[str, tuple] = {}
    for name, rec in doc.get("programs", {}).items():
        model = rec.get("model")
        rows = rec.get("rows") or 0
        flops = rec.get("flops") or 0.0
        if not (name.startswith("zoo/") and model and rows and flops):
            continue
        if rows > best.get(model, (0, 0.0))[0]:
            best[model] = (rows, flops)
    return {model: flops / rows / 1e9
            for model, (rows, flops) in best.items()}
