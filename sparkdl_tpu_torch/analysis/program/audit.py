"""graftcheck core (port of ``sparkdl_tpu/analysis/program/audit.py``):
the port's lowering + the GC001-GC005 program rules.

**The port's lowering.**  JAX lowers each program abstractly on the CPU
(``ShapeDtypeStruct`` avals: no weights, no device) and reads its
StableHLO text and ``cost_analysis``.  The port's counterpart builds each
program on ``torch.device("meta")`` (modules and batches with shapes and
dtypes but no storage, so nothing is computed and no memory is touched)
and runs it once under two recorders:

* a ``TorchFunctionMode`` that records every torch call the program's
  code makes, with the shapes and dtypes of its tensor inputs and
  outputs (calls that return no tensor, such as ``.shape`` or
  ``.dim()``, are left out), and a hand-written kernel's meta path
  (``ops.sepconv.meta_nodes``) adds one ``kernel:<B1|B3|B2|H1>`` node in
  place with its operands, its output, its FLOPs and its bytes;
* ``torch.utils.flop_counter.FlopCounterMode`` for the FLOPs of
  everything else.

The ``fingerprint`` is the sha256 of that call list.  A torch-function
mode sees the calls the port's code makes (and the ``torch.nn`` forward
methods it calls), never how a torch version decomposes them to aten
ops, and no text torch renders is hashed: the fingerprint moves with the
port's programs, not with the torch build (the lockfile is written under
one torch on the CPU and re-audited under the card's).

A kernel's meta path returns the kernel's output without launching, and
an audited program is built with the route the card takes (a model whose
route depends on the device, such as Xception's ``fused_inference=None``,
is built with the card's choice; see ``inventory.py``), so the record of
a zoo Xception program holds its 30 B1 nodes.

The rules read the record as JAX's read the lowering:

* GC001: a donated input leaf counts as ``aliased`` where an output leaf
  has its shape and dtype (each output leaf aliases at most one input),
  and as ``dropped`` otherwise: XLA's aliasing rule, on the meta shapes.
  A train program's outputs are what its step writes in place.
* GC002: ``dtype_counts`` from the recorded calls: convolutions and
  matrix products by their first operand's dtype, and casts to f32; a
  kernel node counts as a convolution with bf16 operands.
* GC003: ``in_avals`` is the program's flat (shape, dtype) list: each
  module's ``state_dict`` without ``num_batches_tracked``, then the
  batch, in the mesh tree's order (``parallel.mesh``); ``weak`` is
  always 0 (torch has no weak types).
* GC004: :func:`pad_waste_audit`, JAX's, over the meta FLOPs.
* GC005: the port's policy functions (``parallel.mesh``) over the
  DECLARED mesh axes: only arithmetic, so a layout is audited without
  the devices it names.  No text is scanned, so JAX's
  "no sharding annotation reached the lowered program" check has no
  counterpart here.

Beside JAX's record keys a record keeps ``kernels`` (the launches of
each hand-written kernel the program makes) and ``out_avals`` (its
output leaves' shapes and dtypes), which the card's ``[audit]`` phase of
``chip_smoke.py`` holds captures and replays to.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.analysis.core import Finding

GC_RULE_HELP = {
    "GC000": "committed program fingerprint matches the audited program",
    "GC001": "dispatch/train programs donate; declared donations alias",
    "GC002": "no f32 conv/matmul under a declared bf16 compute dtype",
    "GC003": "no weak-type/duplicate/churned program input keys",
    "GC004": "pad-to-bucket FLOP waste stays inside budget",
    "GC005": "shardings consistent with the mesh; no large param "
             "replicated past a usable model axis",
}

#: GC004 budgets (JAX's): worst-case pad fraction between adjacent
#: buckets, and the inherent floor of the smallest bucket.
PAD_INTERIOR_BUDGET = 0.55
PAD_FLOOR_BUDGET = 0.95

#: GC005: a single replicated param leaf larger than this, on a mesh
#: whose model axis could shard it, is flagged (JAX's budget).
REPLICATED_PARAM_BUDGET_BYTES = 32 * 1024 * 1024

#: the hand-written kernels a record counts
KERNEL_NAMES = ("B1", "B3", "B2", "H1")

_CONV_CALLS = {"conv1d", "conv2d", "conv3d", "convolution",
               "conv_transpose1d", "conv_transpose2d", "conv_transpose3d"}
_DOT_CALLS = {"linear", "matmul", "mm", "bmm", "addmm", "baddbmm",
              "__matmul__", "__rmatmul__", "einsum", "dot", "tensordot"}
_CAST_CALLS = {"to", "float", "type", "type_as"}
_SHORT_DTYPE = {"bfloat16": "bf16", "float16": "f16", "float32": "f32",
                "float64": "f64"}


@dataclass
class ProgramSpec:
    """One auditable program: a zero-argument ``build`` returning
    ``(fn, args)``, where ``fn(*args)`` runs the program on meta tensors
    (``args`` holds meta modules, tensors and trees of them), plus the
    declared contract the rules check the record against (JAX's
    fields)."""

    name: str                      # e.g. "zoo/Xception/featurize/bfloat16/b8"
    kind: str                      # "dispatch" | "train" | "kernel"
    build: Callable[[], Tuple[Any, tuple]]
    compute_dtype: Optional[str] = None   # "bfloat16" activates GC002
    donate: Tuple[int, ...] = ()          # donated arg indices
    donate_reason: Optional[str] = None   # recorded exemption for GC001
    batch_rows: Optional[int] = None      # padded rows per dispatch
    # per-arg sharding declaration: "replicated" | "batch" (data axis on
    # dim 0) | "stacked_batch" (the grouped layout, data axis on dim 1) |
    # "params" (per-leaf partition specs, ``param_partition``) | None
    shardings: Optional[Tuple[Optional[str], ...]] = None
    mesh_axes: Optional[Dict[str, int]] = None   # {"data": 1, "model": 1}
    # the "params" arg's declared layout: ((path, spec_json), ...)
    param_partition: Optional[Tuple] = None
    group: Optional[str] = None    # one program identity (GC003 groups)
    model: Optional[str] = None    # zoo model name (GC004 bucket grouping)
    bucket: Optional[int] = None


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's spelling, as JAX's
    records write dtypes)."""
    return str(dtype).replace("torch.", "")


def _leaves(tree) -> list:
    """The tensor leaves of ``tree`` in the mesh tree's order (a module
    is its ``state_dict`` without ``num_batches_tracked``)."""
    import torch

    from sparkdl_tpu_torch.parallel.mesh import tree_flatten_with_path

    return [leaf for _, leaf in tree_flatten_with_path(tree)
            if isinstance(leaf, torch.Tensor)]


def _tensor_sigs(obj, out: Optional[list] = None) -> list:
    """``[[shape], dtype]`` of every tensor in nested lists, tuples and
    dicts (values in key order), depth first."""
    import torch

    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append([list(obj.shape), dtype_name(obj.dtype)])
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensor_sigs(o, out)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _tensor_sigs(obj[k], out)
    return out


def _call_name(func) -> str:
    return getattr(func, "__name__", None) or type(func).__name__


def _trace(spec: ProgramSpec) -> Dict[str, Any]:
    """Build ``spec`` on the meta device and run it once under the call
    recorder, the FLOP counter and the kernels' node sink."""
    from torch.overrides import TorchFunctionMode
    from torch.utils.flop_counter import FlopCounterMode

    from sparkdl_tpu_torch.ops.sepconv import meta_nodes

    calls: List[list] = []
    kernels = {k: 0 for k in KERNEL_NAMES}
    tally = {"flops": 0.0, "bytes": 0.0}

    class _Recorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            outs = _tensor_sigs(out)
            if outs:
                ins = _tensor_sigs([list(args), kwargs])
                calls.append([_call_name(func), ins, outs])
                tally["bytes"] += _sig_bytes(ins) + _sig_bytes(outs)
            return out

    def node(kernel, operands, output, flops, nbytes):
        kernels[kernel] += 1
        calls.append([f"kernel:{kernel}", _tensor_sigs(list(operands)),
                      _tensor_sigs(output)])
        tally["flops"] += float(flops)
        tally["bytes"] += float(nbytes)

    fn, args = spec.build()
    counter = FlopCounterMode(display=False)
    with meta_nodes(node), counter, _Recorder():
        out = fn(*args)
    return {"args": args, "out": out, "calls": calls, "kernels": kernels,
            "flops": float(counter.get_total_flops()) + tally["flops"],
            "bytes": tally["bytes"]}


_ITEMSIZE = {"bool": 1, "uint8": 1, "int8": 1, "int16": 2, "int32": 4,
             "int64": 8, "float16": 2, "bfloat16": 2, "float32": 4,
             "float64": 8}


def _sig_bytes(sigs) -> float:
    total = 0.0
    for shape, dt in sigs:
        n = 1
        for d in shape:
            n *= int(d)
        total += n * _ITEMSIZE.get(dt, 4)
    return total


def _dtype_counts(calls: Sequence[list]) -> Dict[str, int]:
    """Operand-dtype mix of the compute-carrying calls, plus upcasts:
    ``{"conv_f32": N, "dot_bf16": N, ..., "convert_to_f32": N}``, keyed on
    the FIRST operand's dtype (a bf16 x bf16 product that accumulates in
    f32 is the kernels' contract, not a leak)."""
    counts: Dict[str, int] = {}

    def bump(key):
        counts[key] = counts.get(key, 0) + 1

    for name, ins, outs in calls:
        first = _SHORT_DTYPE.get(ins[0][1], "other") if ins else "other"
        if name.startswith("kernel:"):
            bump("conv_bf16")
        elif name in _CONV_CALLS:
            bump(f"conv_{first}")
        elif name in _DOT_CALLS:
            bump(f"dot_{first}")
        elif (name in _CAST_CALLS and outs and outs[0][1] == "float32"
              and ins and ins[0][1] != "float32"):
            bump("convert_to_f32")
    return counts


def _donation(spec: ProgramSpec, args: tuple, out) -> Dict[str, Any]:
    """GC001's record: each donated input leaf aliases one unclaimed
    output leaf of its shape and dtype, or is dropped."""
    donated = [s for i in spec.donate for s in _tensor_sigs(_leaves(args[i]))]
    free = _tensor_sigs(_leaves(out))
    aliased = 0
    for sig in donated:
        if sig in free:
            free.remove(sig)
            aliased += 1
    return {"declared": sorted(spec.donate), "donated_leaves": len(donated),
            "aliased": aliased, "dropped": len(donated) - aliased,
            "reason": spec.donate_reason}


def audit_program(spec: ProgramSpec) -> Dict[str, Any]:
    """Trace one program on the meta device and produce its lockfile
    record: fingerprint, FLOPs, bytes, donation map, dtype mix, input
    key, sharding summary, kernel launches, outputs, and the per-program
    findings (GC001/GC002/GC005)."""
    t = _trace(spec)
    args, out = t["args"], t["out"]
    sigs = _tensor_sigs(_leaves(args))
    in_avals = {
        "n": len(sigs),
        "weak": 0,
        "key": hashlib.sha256(json.dumps(sigs).encode()).hexdigest(),
        "shape_key": hashlib.sha256(
            json.dumps([s[0] for s in sigs]).encode()).hexdigest(),
    }
    flops = t["flops"]
    record: Dict[str, Any] = {
        "name": spec.name,
        "kind": spec.kind,
        "fingerprint": hashlib.sha256(
            json.dumps(t["calls"]).encode()).hexdigest(),
        "flops": flops,
        "bytes_accessed": t["bytes"],
        "rows": spec.batch_rows,
        "flops_per_row": (flops / spec.batch_rows
                          if spec.batch_rows else None),
        "compute_dtype": spec.compute_dtype,
        "donation": _donation(spec, args, out),
        "dtype_counts": _dtype_counts(t["calls"]),
        "in_avals": in_avals,
        "group": spec.group,
        "model": spec.model,
        "bucket": spec.bucket,
        "mesh_axes": spec.mesh_axes,
        "sharding_summary": _sharding_summary(spec, args),
        "kernels": t["kernels"],
        "out_avals": _tensor_sigs(_leaves(out)),
    }
    findings = (_rule_gc001(spec, record)
                + _rule_gc002(spec, record)
                + _rule_gc005(spec, record, args))
    record["findings"] = [f.code for f in findings]
    return {"record": record, "findings": findings}


def _leaf_bytes(leaf) -> int:
    return int(leaf.numel()) * int(leaf.element_size())


def _spec_shard_count(spec_json, mesh_axes: Dict[str, int]) -> int:
    """How many ways a spec_json dim list splits its leaf (product of the
    named mesh axis sizes; 1 = replicated)."""
    shards = 1
    for entry in spec_json or ():
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, (list, tuple)) else (entry,)):
            shards *= int(mesh_axes.get(str(axis), 1))
    return shards


def mesh_standin(mesh_axes: Dict[str, int]):
    """A shape-only mesh the port's policy functions read
    (``mesh.shape[axis]`` and ``mesh.axis_names``): how a declared
    layout is audited without the devices it names."""
    return SimpleNamespace(shape=dict(mesh_axes),
                           axis_names=tuple(mesh_axes))


def _sharding_summary(spec: ProgramSpec,
                      args: tuple) -> Optional[Dict[str, Any]]:
    if spec.shardings is None:
        return None
    from sparkdl_tpu_torch.parallel.mesh import (param_path_str,
                                                 tree_flatten_with_path)

    replicated_bytes = 0
    largest_leaf = 0
    batch_args = []
    param_shards: Optional[Dict[str, Any]] = None
    for i, kind in enumerate(spec.shardings):
        if kind in ("batch", "stacked_batch"):
            batch_args.append((i, 0 if kind == "batch" else 1))
        elif kind == "replicated":
            for leaf in _leaves(args[i]):
                size = _leaf_bytes(leaf)
                replicated_bytes += size
                largest_leaf = max(largest_leaf, size)
        elif kind == "params":
            # declared per-leaf specs: replicated leaves join the byte
            # budget, sharded leaves cost bytes/shards per chip and their
            # split dims must divide; an axis the mesh does not declare
            # matches no real layout and leaves both budgets
            spec_map = dict(spec.param_partition or ())
            axes = spec.mesh_axes or {}
            sharded_bytes = 0
            sharded_leaves = 0
            indivisible = []
            for path, leaf in tree_flatten_with_path(args[i]):
                name = param_path_str(path)
                sj = spec_map.get(name) or ()
                size = _leaf_bytes(leaf)
                unknown = False
                for dim, entry in enumerate(sj):
                    if entry is None:
                        continue
                    names = (entry if isinstance(entry, (list, tuple))
                             else (entry,))
                    for axis in names:
                        if str(axis) not in axes:
                            unknown = True
                            indivisible.append(
                                {"param": name, "dim": dim,
                                 "shape": list(leaf.shape), "shards": 0,
                                 "unknown_axis": str(axis)})
                if unknown:
                    continue
                shards = _spec_shard_count(sj, axes)
                if shards <= 1:
                    replicated_bytes += size
                    largest_leaf = max(largest_leaf, size)
                    continue
                sharded_leaves += 1
                sharded_bytes += size // shards
                for dim, entry in enumerate(sj):
                    n = _spec_shard_count([entry], axes)
                    if n > 1 and (dim >= len(leaf.shape)
                                  or leaf.shape[dim] % n):
                        indivisible.append(
                            {"param": name, "dim": dim,
                             "shape": list(leaf.shape), "shards": n})
            if param_shards is None:
                param_shards = {"specs": [], "sharded_leaves": 0,
                                "sharded_bytes_per_chip": 0,
                                "indivisible": []}
            param_shards["specs"] = sorted(
                param_shards["specs"]
                + [(n, list(sj)) for n, sj in spec_map.items()])
            param_shards["sharded_leaves"] += sharded_leaves
            param_shards["sharded_bytes_per_chip"] += sharded_bytes
            param_shards["indivisible"].extend(indivisible)
    summary: Dict[str, Any] = {
        "batch_args": batch_args,
        "replicated_bytes": replicated_bytes,
        "largest_replicated_leaf_bytes": largest_leaf,
    }
    if param_shards is not None:
        summary["param_shards"] = param_shards
    return summary


def _rule_gc001(spec: ProgramSpec, record: Dict[str, Any]) -> List[Finding]:
    if spec.kind == "kernel":
        # kernels declare no donation; their exemption reason rides in the
        # record (their inputs are chained activations)
        return []
    d = record["donation"]
    if not d["declared"]:
        if spec.donate_reason is None:
            return [Finding(
                "GC001", spec.name, 0,
                "dispatch-path program donates nothing and records no "
                "reason; donate its batch (or record why donation is "
                "unsafe/pointless for this program)")]
        return []
    if d["aliased"] < d["donated_leaves"] and spec.donate_reason is None:
        return [Finding(
            "GC001", spec.name, 0,
            f"donation silently dropped: {d['donated_leaves']} donated "
            f"leaf/leaves but only {d['aliased']} match an output leaf's "
            f"shape and dtype ({d['dropped']} dropped) — a dtype/shape "
            f"mismatch is eating the donation")]
    return []


def _rule_gc002(spec: ProgramSpec, record: Dict[str, Any]) -> List[Finding]:
    if spec.compute_dtype != "bfloat16":
        return []
    c = record["dtype_counts"]
    leaks = c.get("conv_f32", 0) + c.get("dot_f32", 0)
    if leaks:
        return [Finding(
            "GC002", spec.name, 0,
            f"{leaks} f32 compute op(s) under the declared bf16 compute "
            f"dtype (conv_f32={c.get('conv_f32', 0)}, "
            f"dot_f32={c.get('dot_f32', 0)}) — an upcast is leaking "
            f"into the hot path")]
    return []


def _rule_gc005(spec: ProgramSpec, record: Dict[str, Any],
                args: tuple) -> List[Finding]:
    if spec.shardings is None or spec.mesh_axes is None:
        return []
    findings: List[Finding] = []
    data = int(spec.mesh_axes.get("data", 1))
    model = int(spec.mesh_axes.get("model", 1))
    summary = record["sharding_summary"]
    for i, dim in summary["batch_args"]:
        for leaf in _leaves(args[i]):
            if len(leaf.shape) > dim and leaf.shape[dim] % data:
                findings.append(Finding(
                    "GC005", spec.name, 0,
                    f"batch aval {tuple(leaf.shape)} dim {dim} not "
                    f"divisible by the {data}-way data axis — uneven "
                    f"shards recompile or fail at dispatch"))
    if (model > 1 and summary["largest_replicated_leaf_bytes"]
            > REPLICATED_PARAM_BUDGET_BYTES):
        mb = summary["largest_replicated_leaf_bytes"] / 1e6
        findings.append(Finding(
            "GC005", spec.name, 0,
            f"param leaf of {mb:.0f} MB fully replicated although the "
            f"mesh has a {model}-way model axis — shard it with a "
            f"PartitionSpec (mesh.match_partition_rules / parallel.train "
            f"param_specs) instead of paying {model}x device memory"))
    shards = summary.get("param_shards")
    if shards:
        for bad in shards["indivisible"]:
            if bad.get("unknown_axis"):
                findings.append(Finding(
                    "GC005", spec.name, 0,
                    f"sharded param {bad['param']!r} dim {bad['dim']} "
                    f"names unknown mesh axis {bad['unknown_axis']!r} "
                    f"(declared axes: {sorted(spec.mesh_axes or {})}) "
                    f"— the declaration matches no real layout"))
                continue
            findings.append(Finding(
                "GC005", spec.name, 0,
                f"sharded param {bad['param']!r} dim {bad['dim']} "
                f"(shape {tuple(bad['shape'])}) not divisible by its "
                f"{bad['shards']}-way split — the layout fails "
                f"(mesh.resolve_param_shardings would have replicated "
                f"this leaf)"))
    return findings


def retrace_audit(records: Sequence[Dict[str, Any]]) -> List[Finding]:
    """GC003 over the WHOLE inventory (JAX's): a program's identity is
    (group, flat input signatures).  Weak types, duplicate keys, and
    same-shape dtype churn inside one group each mean a second build of
    the "same" program."""
    findings: List[Finding] = []
    seen: Dict[tuple, str] = {}
    by_group: Dict[str, list] = {}
    for rec in records:
        avals = rec["in_avals"]
        if avals["weak"]:
            findings.append(Finding(
                "GC003", rec["name"], 0,
                f"{avals['weak']} weak-typed input aval(s): a python "
                f"scalar is reaching the traced signature and will "
                f"re-specialize on the first strongly-typed call"))
        group = rec.get("group") or rec["name"]
        key = (group, avals["key"])
        if key in seen:
            findings.append(Finding(
                "GC003", rec["name"], 0,
                f"duplicate executable cache key: identical avals "
                f"already enumerated by {seen[key]} — the same program "
                f"would be built/compiled twice"))
        else:
            seen[key] = rec["name"]
        by_group.setdefault(group, []).append(rec)
    for group, recs in by_group.items():
        by_shape: Dict[str, set] = {}
        for rec in recs:
            by_shape.setdefault(rec["in_avals"]["shape_key"], set()).add(
                (rec["in_avals"]["key"], rec["name"]))
        for shape_key, keys in by_shape.items():
            if len({k for k, _ in keys}) > 1:
                names = sorted(n for _, n in keys)
                findings.append(Finding(
                    "GC003", names[0], 0,
                    f"dtype/weak-type churn in group {group!r}: "
                    f"{len(keys)} distinct cache keys share identical "
                    f"shapes ({', '.join(names)}) — each is a separate "
                    f"compilation of the same program"))
    return findings


def pad_waste_audit(records: Sequence[Dict[str, Any]],
                    interior_budget: float = PAD_INTERIOR_BUDGET,
                    floor_budget: float = PAD_FLOOR_BUDGET
                    ) -> List[Finding]:
    """GC004 over each model's bucket set (JAX's): FLOPs are row-linear
    (the per-row figure must agree across buckets — checked), so the
    padded share of a bucket's FLOPs equals its padded row share.  Worst
    cases: a request of ``prev_bucket + 1`` rows served by bucket ``b``
    wastes ``(b - prev - 1)/b`` of the program; a 1-row request pays the
    smallest bucket's floor."""
    from sparkdl_tpu_torch.analysis.program.lockfile import (pad_gap_fracs,
                                                             pad_worst_fracs)

    findings: List[Finding] = []
    by_model: Dict[str, list] = {}
    for rec in records:
        if rec.get("model") and rec.get("bucket") and rec.get("flops"):
            by_model.setdefault(rec["model"], []).append(rec)
    for model, recs in sorted(by_model.items()):
        recs = sorted(recs, key=lambda r: r["bucket"])
        per_row = [r["flops"] / r["bucket"] for r in recs]
        lo, hi = min(per_row), max(per_row)
        if lo > 0 and (hi - lo) / lo > 0.02:
            findings.append(Finding(
                "GC004", f"zoo/{model}", 0,
                f"per-row FLOPs disagree across buckets "
                f"({lo / 1e9:.3f}–{hi / 1e9:.3f} GF/row): the program is "
                f"not row-linear, so pad-to-bucket accounting is "
                f"invalid"))
        buckets = [r["bucket"] for r in recs]
        floor = pad_worst_fracs(buckets)[1]
        if floor > floor_budget:
            findings.append(Finding(
                "GC004", f"zoo/{model}", 0,
                f"smallest bucket {buckets[0]} pads a 1-row request to "
                f"{floor:.0%} waste (budget {floor_budget:.0%}); add a "
                f"smaller bucket"))
        for prev, b, waste in pad_gap_fracs(buckets):
            if waste > interior_budget:
                findings.append(Finding(
                    "GC004", f"zoo/{model}", 0,
                    f"bucket gap {prev}->{b}: a {prev + 1}-row request "
                    f"wastes {waste:.0%} of bucket {b}'s FLOPs (budget "
                    f"{interior_budget:.0%}); tighten the bucket "
                    f"spacing"))
    return findings


def audit_inventory(specs: Sequence[ProgramSpec],
                    progress: Optional[Callable[[str], None]] = None
                    ) -> Tuple[List[Dict[str, Any]], List[Finding]]:
    """Audit every spec and run the cross-program rules; returns
    ``(records, findings)`` with findings sorted most-actionable first
    (per-program order, then GC003/GC004)."""
    records: List[Dict[str, Any]] = []
    findings: List[Finding] = []
    for spec in specs:
        out = audit_program(spec)
        records.append(out["record"])
        findings.extend(out["findings"])
        if progress is not None:
            r = out["record"]
            progress(f"{spec.name}: {r['flops'] / 1e9:.2f} GF, "
                     f"{len(out['findings'])} finding(s)")
    findings.extend(retrace_audit(records))
    findings.extend(pad_waste_audit(records))
    return records, findings
