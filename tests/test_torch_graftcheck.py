"""The port's graftcheck (``sparkdl_tpu_torch.analysis.program``) held
against the JAX package's on the CPU.

* On the same records, the cross-program rules (``retrace_audit``,
  ``pad_waste_audit``), ``diff_records``, the pad formulas and the
  lockfile's bytes are JAX's.
* Tiny programs built in both packages (an f32 matmul under a bf16
  contract, a donated batch its output can or cannot take, a duplicate
  key, a wide bucket gap, a large replicated leaf beside a model axis)
  fire the same GC codes.  In this sandbox JAX's lowering carries no
  sharding annotations, so JAX's "no mhlo.sharding annotation" GC005
  finding fires on every sharded program; it is an artifact of the
  installed jax, has no counterpart in the port (no text is scanned) and
  is set aside before comparing.
* The port's ``stack_programs()`` lists JAX's program names, kinds, rows,
  models, buckets and declared contracts (JAX's listed on a one-device
  mesh), and listing builds nothing.
* The fused route's Xception program records 30 B1 nodes and the FLOPs of
  the unfused route; its FLOPs a row are within 1% of JAX's committed
  record.  Fingerprints are never compared across the packages.
* Each kernel wrapper's meta path launches nothing and returns the
  kernel's output shape and dtype; the subset audit is clean against the
  committed ``PROGRAMS_TORCH.lock.json``; a tampered copy is named by the
  right GC code; the CLI keeps JAX's flags and exit codes.
"""

from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.analysis.program import audit as jaudit
from sparkdl_tpu.analysis.program import lockfile as jlock
from sparkdl_tpu_torch.analysis.program import audit as paudit
from sparkdl_tpu_torch.analysis.program import lockfile as plock
from sparkdl_tpu_torch.analysis.program import (DEFAULT_LOCKFILE,
                                                ProgramSpec,
                                                audit_inventory,
                                                audit_program,
                                                diff_records, read_lockfile,
                                                stack_programs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LOCKFILE = os.path.join(REPO, "PROGRAMS.lock.json")
D = 16
FLOPS_REL_TOL = 1e-2      # the port's FLOPs a row vs JAX's record
ROUTE_FLOPS_REL_TOL = 1e-6  # fused vs unfused route of one program


def _jax_artifact(f) -> bool:
    return f.code == "GC005" and f.message.startswith(
        "no mhlo.sharding annotation")


def _codes(findings):
    return sorted({f.code for f in findings if not _jax_artifact(f)})


def _keys(findings):
    return [(f.code, f.path, f.line) for f in findings
            if not _jax_artifact(f)]


# -- the same records through both packages ---------------------------------

def _bucket_rec(model, bucket, gflop_per_row=1.0, key=None, group=None):
    return {"name": f"zoo/{model}/b{bucket}", "model": model,
            "bucket": bucket, "flops": gflop_per_row * 1e9 * bucket,
            "group": group,
            "in_avals": {"n": 1, "weak": 0, "key": key or str(bucket),
                         "shape_key": str(bucket)}}


RECORD_SETS = {
    "quarter_half_full": [_bucket_rec("M", b) for b in (8, 16, 32)],
    "wide_gap": [_bucket_rec("M", 8), _bucket_rec("M", 64)],
    "single": [_bucket_rec("M", 64)],
    "nonlinear": [_bucket_rec("M", 8), _bucket_rec("M", 16, 1.2)],
    "duplicate": [_bucket_rec("M", 8, group="g"),
                  dict(_bucket_rec("M", 8, group="g"), name="copy")],
    "churn": [_bucket_rec("M", 8, group="g"),
              dict(_bucket_rec("M", 8, key="other", group="g"), name="b")],
    "weak": [dict(_bucket_rec("M", 8),
                  in_avals={"n": 1, "weak": 1, "key": "w",
                            "shape_key": "w"})],
}


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_cross_program_rules_match_jax(name):
    recs = RECORD_SETS[name]
    for fn in ("retrace_audit", "pad_waste_audit"):
        assert _keys(getattr(paudit, fn)(recs)) == _keys(
            getattr(jaudit, fn)(recs)), fn
    buckets = [r["bucket"] for r in recs]
    assert plock.pad_gap_fracs(buckets) == jlock.pad_gap_fracs(buckets)
    assert plock.pad_worst_fracs(buckets) == jlock.pad_worst_fracs(buckets)


@pytest.fixture(scope="module")
def port_records():
    """Records of the port's small programs (the generic, the head fan-out
    pair, the train steps and the kernels), audited once."""
    from sparkdl_tpu_torch.analysis.program import inventory as inv

    specs = (inv.generic_dispatch_specs() + inv.headfanout_dispatch_specs()
             + inv.train_step_specs() + inv.sepconv_kernel_specs())
    records, findings = audit_inventory(specs)
    assert findings == [], [f.render() for f in findings]
    return records


def test_lockfile_bytes_and_drift_match_jax(tmp_path, port_records):
    meta = {"torch_version": "x", "device_count": 1}
    ppath, jpath = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    plock.write_lockfile(port_records, ppath, meta=meta)
    jlock.write_lockfile(port_records, jpath, meta=meta)
    with open(ppath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    doc = plock.read_lockfile(ppath)
    assert doc == jlock.read_lockfile(jpath)
    assert diff_records(doc, port_records) == []
    for subset in (False, True):
        for base, cur in ((doc, port_records[:2]),
                          (dict(doc, programs=dict(list(
                              doc["programs"].items())[:2])), port_records)):
            assert _keys(diff_records(base, cur, subset=subset)) == _keys(
                jlock.diff_records(base, cur, subset=subset))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema_version": 99, "programs": {}}))
    with pytest.raises(ValueError, match="unsupported lockfile schema"):
        plock.read_lockfile(str(bad))


@pytest.mark.parametrize("field,mutate,code", [
    ("fingerprint", lambda r: r.update(fingerprint="0" * 64), "GC000"),
    ("donation", lambda r: r["donation"].update(declared=[]), "GC001"),
    ("dtype_counts", lambda r: r["dtype_counts"].update(dot_f32=9), "GC002"),
    ("kernels", lambda r: r.update(kernels=dict(r["kernels"], B1=29)),
     "GC002"),
    ("in_avals", lambda r: r["in_avals"].update(key="churned"), "GC003"),
    ("flops", lambda r: r.update(flops=r["flops"] * 2), "GC004"),
    ("mesh_axes", lambda r: r.update(mesh_axes={"data": 2, "model": 1}),
     "GC005"),
])
def test_tampered_record_named_by_its_rule(port_records, field, mutate,
                                           code):
    doc = {"programs": {r["name"]: {k: v for k, v in r.items()
                                    if k != "name"} for r in port_records}}
    name = "train/linear_head/step/b32"
    bad = json.loads(json.dumps(doc))
    mutate(bad["programs"][name])
    drift = diff_records(bad, port_records)
    assert [(f.code, f.path) for f in drift] == [(code, name)]
    if field != "kernels":  # a field JAX's records lack
        assert _keys(jlock.diff_records(bad, port_records)) == _keys(drift)


# -- tiny programs built in both packages ------------------------------------

def _jax_spec(fn, *, name, rows=8, compute_dtype=None, donate=(),
              donate_reason="n/a", in_dtype=np.float32, param_shape=(D, D),
              model_parallel=1, out_dtype=None, kind="dispatch"):
    from sparkdl_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.get_mesh(model_parallel=model_parallel)
    repl = mesh_lib.replicated_sharding(mesh)
    bsh = mesh_lib.batch_sharding(mesh)

    def build():
        jitted = jax.jit(fn, in_shardings=(repl, bsh), out_shardings=bsh,
                         donate_argnums=donate)
        v = {"w": jax.ShapeDtypeStruct(param_shape, np.float32)}
        x = jax.ShapeDtypeStruct((rows, param_shape[0]), in_dtype)
        return jitted, (v, x)

    axes = {str(n): int(s) for n, s in zip(mesh.axis_names,
                                           mesh.devices.shape)}
    return jaudit.ProgramSpec(
        name=name, kind=kind, build=build, compute_dtype=compute_dtype,
        donate=donate, donate_reason=donate_reason, batch_rows=rows,
        shardings=("replicated", "batch"), mesh_axes=axes, group=name)


def _port_spec(fn, *, name, rows=8, compute_dtype=None, donate=(),
               donate_reason="n/a", in_dtype=torch.float32,
               param_shape=(D, D), axes=None, kind="dispatch"):
    def build():
        m = torch.nn.Module()
        m.register_buffer("w", torch.empty(param_shape, device="meta"))
        x = torch.empty((rows, param_shape[0]), dtype=in_dtype,
                        device="meta")
        return fn, (m, x)

    return ProgramSpec(name=name, kind=kind, build=build,
                       compute_dtype=compute_dtype, donate=donate,
                       donate_reason=donate_reason, batch_rows=rows,
                       shardings=("replicated", "batch"),
                       mesh_axes=axes or {"data": 8, "model": 1}, group=name)


def _jdot(leak, out_dtype=None):
    def fn(v, x):
        xc = x.astype(jnp.float32 if leak else jnp.bfloat16)
        y = xc @ v["w"].astype(xc.dtype)
        return y.astype(out_dtype) if out_dtype is not None else y
    return fn


def _pdot(leak, out_dtype=None):
    def fn(m, x):
        xc = x.to(torch.float32 if leak else torch.bfloat16)
        y = xc @ m.w.to(xc.dtype)
        return y.to(out_dtype) if out_dtype is not None else y
    return fn


CASES = {
    # (jax spec kwargs, port spec kwargs, expected codes)
    "f32_matmul_under_bf16": (
        dict(fn=_jdot(True), compute_dtype="bfloat16"),
        dict(fn=_pdot(True), compute_dtype="bfloat16"), ["GC002"]),
    "bf16_matmul_clean": (
        dict(fn=_jdot(False), compute_dtype="bfloat16"),
        dict(fn=_pdot(False), compute_dtype="bfloat16"), []),
    "f32_config_exempt": (
        dict(fn=_jdot(True), compute_dtype="float32"),
        dict(fn=_pdot(True), compute_dtype="float32"), []),
    "donated_batch_aliases": (
        dict(fn=_jdot(True), donate=(1,), donate_reason=None),
        dict(fn=_pdot(True), donate=(1,), donate_reason=None), []),
    "donated_batch_dropped": (
        dict(fn=_jdot(True, jnp.bfloat16), donate=(1,), donate_reason=None),
        dict(fn=_pdot(True, torch.bfloat16), donate=(1,),
             donate_reason=None), ["GC001"]),
    "no_donation_no_reason": (
        dict(fn=_jdot(True), donate_reason=None),
        dict(fn=_pdot(True), donate_reason=None), ["GC001"]),
    "large_replicated_leaf_with_model_axis": (
        dict(fn=_jdot(True), param_shape=(4096, 4096), model_parallel=2),
        dict(fn=_pdot(True), param_shape=(4096, 4096),
             axes={"data": 4, "model": 2}), ["GC005"]),
    "large_replicated_leaf_data_only": (
        dict(fn=_jdot(True), param_shape=(4096, 4096)),
        dict(fn=_pdot(True), param_shape=(4096, 4096)), []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiny_programs_fire_jax_codes(case):
    jkw, pkw, want = CASES[case]
    jout = jaudit.audit_program(_jax_spec(name=case, **jkw))
    pout = audit_program(_port_spec(name=case, **pkw))
    assert _codes(jout["findings"]) == _codes(pout["findings"]) == want
    jd, pd = jout["record"]["donation"], pout["record"]["donation"]
    assert (jd["declared"], jd["donated_leaves"]) == (pd["declared"],
                                                     pd["donated_leaves"])
    assert min(jd["aliased"], 1) == min(pd["aliased"], 1)


def test_duplicate_and_wide_gap_across_programs():
    a = audit_program(_port_spec(_pdot(False), name="synth/dup"))["record"]
    b = dict(a, name="synth/dup-copy")
    assert _codes(paudit.retrace_audit([a, b])) == _codes(
        jaudit.retrace_audit([a, b])) == ["GC003"]
    recs = [dict(a, name=f"zoo/M/b{k}", model="M", bucket=k,
                 flops=a["flops"] / 8 * k) for k in (8, 64)]
    assert _keys(paudit.pad_waste_audit(recs)) == _keys(
        jaudit.pad_waste_audit(recs))
    assert _codes(paudit.pad_waste_audit(recs)) == ["GC004"]
    assert a["in_avals"]["weak"] == 0   # torch has no weak types


# -- the inventory ----------------------------------------------------------

def _contract(spec, kernel_reason_text=True):
    reason = spec.donate_reason
    if spec.kind == "kernel" and not kernel_reason_text:
        reason = reason is not None
    return dict(kind=spec.kind, rows=spec.batch_rows, model=spec.model,
                bucket=spec.bucket, compute_dtype=spec.compute_dtype,
                donate=tuple(spec.donate), reason=reason,
                shardings=spec.shardings, mesh_axes=spec.mesh_axes,
                group=spec.group,
                partition=json.loads(json.dumps(spec.param_partition)))


def test_inventory_lists_jax_programs_and_builds_nothing(monkeypatch):
    from sparkdl_tpu.analysis.program import stack_programs as jstack
    from sparkdl_tpu.parallel import mesh as jmesh
    from sparkdl_tpu_torch import models as pmodels

    def refuse(*a, **k):
        raise AssertionError("listing built a model")

    monkeypatch.setattr(pmodels.ModelSpec, "build", refuse)
    port = {s.name: _contract(s, False) for s in stack_programs()}
    jax_ = {s.name: _contract(s, False) for s in
            jstack(mesh=jmesh.get_mesh(num_devices=1))}
    assert sorted(port) == sorted(jax_)
    for name in port:
        assert port[name] == jax_[name], name
    committed = read_lockfile(DEFAULT_LOCKFILE)
    assert set(committed["programs"]) == set(port)
    assert committed["meta"]["device_count"] == 1


@pytest.fixture(scope="module")
def xception_b8():
    from sparkdl_tpu_torch.analysis.program.inventory import \
        zoo_dispatch_specs

    [spec] = [s for s in zoo_dispatch_specs(models=["Xception"])
              if s.bucket == 8]
    return spec


def test_fused_xception_records_b1_and_the_unfused_flops(xception_b8):
    rec = audit_program(xception_b8)["record"]
    assert rec["kernels"] == {"B1": 30, "B3": 0, "B2": 0, "H1": 0}
    assert rec["out_avals"] == [[[8, 2048], "bfloat16"]]
    assert rec["findings"] == []
    unfused = copy.copy(xception_b8)

    def build_unfused():
        fn, (module, x) = xception_b8.build()
        module.fused_inference = False
        return fn, (module, x)

    unfused.build = build_unfused
    urec = audit_program(unfused)["record"]
    assert urec["kernels"]["B1"] == 0
    assert urec["fingerprint"] != rec["fingerprint"]
    assert abs(urec["flops"] - rec["flops"]) <= ROUTE_FLOPS_REL_TOL * \
        rec["flops"]
    # the JAX package's committed record of the same program, same rows
    jrec = read_lockfile(JAX_LOCKFILE)["programs"][xception_b8.name]
    assert jrec["rows"] == rec["rows"] == 8
    assert abs(rec["flops_per_row"] / (jrec["flops"] / jrec["rows"]) - 1) \
        <= FLOPS_REL_TOL


def test_meta_wrappers_launch_nothing_and_give_kernel_outputs():
    from sparkdl_tpu_torch.ops import head as phead
    from sparkdl_tpu_torch.ops import sepconv as psep

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    nodes = []
    before = psep.launch_counts() + (phead.head_pass.launches,)
    bf = torch.bfloat16
    with psep.meta_nodes(lambda *n: nodes.append(n)), torch.no_grad():
        y1 = psep.fused_sepconv(meta(2, 10, 12, 64), meta(3, 3, 64),
                                meta(64, 96), meta(96), meta(96),
                                pre_relu=True)
        y3 = psep.fused_sepconv(meta(2, 10, 12, 64, dtype=bf),
                                meta(3, 3, 64, 1), meta(1, 1, 64, 96),
                                meta(96), meta(96), row_tile=8)
        y2 = psep.fused_mbconv(meta(2, 7, 7, 32), meta(3, 3, 32),
                               meta(32, 16), meta(32), meta(16))
        yh = phead.head_pass(meta(5, 24), meta(5, dtype=torch.int32),
                             meta(4, 24, 3), meta(4, 3))
        with pytest.raises(ValueError, match="multiples of 8"):
            psep.fused_sepconv(meta(1, 4, 4, 12), meta(3, 3, 12),
                               meta(12, 8), meta(8), meta(8))
    assert psep.launch_counts() + (phead.head_pass.launches,) == before
    for y, shape in ((y1, (2, 10, 12, 96)), (y3, (2, 10, 12, 96)),
                     (y2, (2, 7, 7, 16))):
        assert y.is_meta and tuple(y.shape) == shape and y.dtype == bf
    assert yh.is_meta and tuple(yh.shape) == (5, 3) and \
        yh.dtype == torch.float32
    assert [n[0] for n in nodes] == ["B1", "B3", "B2", "H1"]
    assert nodes[0][3:] == psep.sepconv_cost(2, 10, 12, 64, 96)
    assert nodes[2][3:] == psep.mbconv_cost(2, 7, 7, 32, 16)
    assert nodes[3][3:] == phead.head_pass_cost(5, 24, 3, 4)


def test_subset_audit_clean_against_committed_lockfile():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    specs = chip_smoke.audit_subset()
    assert {s.name for s in specs} >= {
        "zoo/Xception/featurize/bfloat16/b8", "train/linear_head/step/b32",
        "kernel/sepconv/19x19x728", "headfanout/heads/k64/f32/b32"}
    records, findings = audit_inventory(specs)
    assert findings == [], [f.render() for f in findings]
    drift = diff_records(read_lockfile(DEFAULT_LOCKFILE), records,
                         subset=True)
    assert drift == [], [f.render() for f in drift]


# -- the CLI ------------------------------------------------------------------

def _cli(argv, capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import port_graftcheck
    finally:
        sys.path.pop(0)
    rc = port_graftcheck.main(argv)
    return rc, capsys.readouterr()


def test_cli_flags_and_exit_codes(tmp_path, capsys):
    rc, out = _cli(["--list-rules"], capsys)
    assert rc == 0 and all(f"GC00{i}" in out.out for i in range(6))
    rc, out = _cli(["--lockfile", str(tmp_path / "none.json"), "--models",
                    "Xception", "--no-train", "--no-kernels"], capsys)
    assert rc == 2 and "no lockfile" in out.err
    rc, out = _cli(["--models", "Xception", "--no-train", "--no-kernels",
                    "--json"], capsys)
    doc = json.loads(out.out)
    assert rc == 0, doc
    assert doc["findings"] == []
    assert doc["programs"]["zoo/Xception/featurize/bfloat16/b8"][
        "kernels"]["B1"] == 30
    # a narrowed bucket plan meets programs the lockfile does not hold
    rc, out = _cli(["--models", "Xception", "--max-batch", "16",
                    "--no-train", "--no-kernels", "--json"], capsys)
    codes = {f["rule"] for f in json.loads(out.out)["findings"]}
    assert rc == 1 and codes == {"GC003"}
    # --write-baseline of a subset into a new file, then verify against it
    path = str(tmp_path / "lock.json")
    rc, out = _cli(["--lockfile", path, "--write-baseline", "--models",
                    "MobileNetV2", "--no-train", "--no-kernels", "--json"],
                   capsys)
    assert rc == 0 and json.loads(out.out)["written"] == path
    assert read_lockfile(path)["meta"]["torch_version"] == torch.__version__
    rc, out = _cli(["--lockfile", path, "--models", "MobileNetV2",
                    "--no-train", "--no-kernels"], capsys)
    assert rc == 0 and "clean" in out.out


def test_cli_refuses_to_baseline_a_failing_audit(tmp_path, capsys,
                                                 monkeypatch):
    from sparkdl_tpu_torch.analysis.program import inventory as inv

    real = inv.generic_dispatch_specs

    def leaky(*a, **k):
        return [ProgramSpec(**dict(vars(s), donate_reason=None,
                                   donate=()))
                for s in real(*a, **k)]

    monkeypatch.setattr(inv, "generic_dispatch_specs", leaky)
    path = tmp_path / "lock.json"
    rc, out = _cli(["--lockfile", str(path), "--write-baseline", "--models",
                    "MobileNetV2", "--no-train", "--no-kernels"], capsys)
    assert rc == 1 and "refusing" in out.err and "GC001" in out.out
    assert not path.exists()
