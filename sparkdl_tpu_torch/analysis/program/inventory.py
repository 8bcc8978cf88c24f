"""The port's program inventory (port of
``sparkdl_tpu/analysis/program/inventory.py``): every program the serving
and training layers run, as :class:`~sparkdl_tpu_torch.analysis.program.
audit.ProgramSpec`\\ s built from the SAME constructors the runtime uses
(``transformers.named_image.zoo_model_fn``, ``parallel.engine.
device_module``, ``serving.server.bucket_plan``, ``parallel.engine.
head_fanout_backbone_fn`` and the H1 fan-out, ``parallel.train.
make_train_step``, the ``ops.sepconv`` kernel wrappers), so the audited
program set cannot drift from the served one.  The families and program
names are JAX's ``stack_programs``.

Meta by construction: every module is built under ``torch.device("meta")``
and every batch is an empty meta tensor, so nothing holds memory and
nothing is computed.  Building a spec LIST builds nothing; each spec's
``build`` makes its module when the audit traces it.

The route of each program is the card's: the engine's module is
``channels_last`` as on CUDA, and a module that picks its route by device
(``fused_inference=None``: Xception's fused separable convolutions) is
built with the card's choice, ``fused_inference=True``, so the record
holds the kernel nodes the card launches.  The zoo's mesh is this
process's one device, so its programs declare ``mesh_axes`` ``{"data": 1,
"model": 1}``; the wide-dense pair declares JAX's ``dp1tp8`` and
``dp2tp4`` layouts, which the audit checks by arithmetic alone (the
runtime refuses a real split: one card per process).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

from sparkdl_tpu_torch.analysis.program.audit import ProgramSpec

#: The donation exemption every zoo dispatch program records (GC001), as
#: JAX's: the uint8 image batch can never alias the float output.
ZOO_DONATE_REASON = (
    "uint8 image batch cannot alias the float feature output (smaller, "
    "different dtype); XLA drops the donation, so the engine leaves "
    "donate_batch off for zoo programs")

SEPCONV_DONATE_REASON = (
    "chained NHWC activations; callers reuse the input (residual adds), "
    "so writing the output over it would corrupt the residual source")

#: Canonical kernel audit shapes (JAX's): Xception middle flow (B1), the
#: entry flow block under row tiling (B3), a MobileNetV2 tail (B2).
_KERNEL_SHAPES = {
    "sepconv": dict(b=8, h=19, w=19, c=728, f=728),
    "sepconv_tiled": dict(b=8, h=74, w=74, c=256, f=256, th=8),
    "mbconv": dict(b=8, h=28, w=28, c=192, f=32),
}

#: The one-device mesh axes of the zoo, serving and train programs.
ONE_DEVICE_AXES = {"data": 1, "model": 1}


def _meta(shape, dtype=None):
    import torch

    return torch.empty(tuple(shape), dtype=dtype or torch.float32,
                       device="meta")


def _engine_program(fn, group: bool = False):
    """The engine's forward of ``fn`` (``InferenceEngine._eager``) under
    ``torch.inference_mode``: one forward, or for a grouped dispatch one
    forward per piece, stacked."""
    import torch

    from sparkdl_tpu_torch.parallel.engine import _tree_map

    def program(module, x):
        with torch.inference_mode():
            if not group:
                return fn(module, x)
            outs = [fn(module, x[i]) for i in range(int(x.shape[0]))]
            return _tree_map(lambda *parts: torch.stack(parts), *outs)

    return program


def card_route(module):
    """``module`` with the card's route where it picks one by device: a
    ``fused_inference`` of None (Xception's "fused on CUDA") becomes True.
    Routes set by a knob (``SPARKDL_MNV2_FUSED`` and the like) stay as
    the knob set them."""
    for m in module.modules():
        if "fused_inference" in vars(m) and m.fused_inference is None:
            m.fused_inference = True
    return module


def _fresh(module):
    """A copy of ``module`` with every fold cache empty, so that each
    program's trace computes its folds itself whatever was traced
    before."""
    module = copy.deepcopy(module)
    for m in module.modules():
        if isinstance(getattr(m, "_folds", None), dict):
            m._folds.clear()
    return module


def zoo_dispatch_specs(max_batch_size: int = 32,
                       models: Optional[Sequence[str]] = None,
                       compute_dtype: str = "bfloat16") -> List[ProgramSpec]:
    """One spec per (zoo model x serving bucket x cut), as JAX's: the
    engine program as ``zoo_serving_bundle`` + ``InferenceEngine`` build it
    (preprocess on the device, compute-dtype cast, the engine's module
    copy) at every bucket of ``bucket_plan(max_batch_size)``, the
    predictor cut at the fixed bucket 32, and the grouped program (four
    pieces a dispatch) for MobileNetV2."""
    from sparkdl_tpu_torch.models import SUPPORTED_MODELS, get_model_spec
    from sparkdl_tpu_torch.serving.server import bucket_plan

    buckets = bucket_plan(max_batch_size, mesh=_one_device_mesh())
    names = list(models) if models else list(SUPPORTED_MODELS)
    memo: Dict[str, Any] = {}

    def module_for(name: str):
        import torch

        from sparkdl_tpu_torch.parallel.engine import device_module

        if name not in memo:
            with torch.device("meta"):
                built = get_model_spec(name).build()
            cdt = torch.bfloat16 if compute_dtype == "bfloat16" else None
            memo[name] = card_route(device_module(
                built, torch.device("meta"), cdt, channels_last=True))
        return _fresh(memo[name])

    def build(name: str, bucket: int, featurize: bool, group_k: int = 0):
        def _build():
            import torch

            from sparkdl_tpu_torch.transformers.named_image import \
                zoo_model_fn

            cdt = torch.bfloat16 if compute_dtype == "bfloat16" else None
            h, w = get_model_spec(name).input_size
            fn = zoo_model_fn(name, featurize, compute_dtype=cdt)
            shape = ((group_k, bucket, h, w, 3) if group_k
                     else (bucket, h, w, 3))
            return (_engine_program(fn, group=bool(group_k)),
                    (module_for(name), _meta(shape, torch.uint8)))

        return _build

    base = dict(kind="dispatch", compute_dtype=compute_dtype, donate=(),
                donate_reason=ZOO_DONATE_REASON,
                mesh_axes=dict(ONE_DEVICE_AXES))
    specs: List[ProgramSpec] = []
    for name in names:
        canonical = get_model_spec(name).name
        for b in buckets:
            specs.append(ProgramSpec(
                name=f"zoo/{canonical}/featurize/{compute_dtype}/b{b}",
                build=build(canonical, b, featurize=True), batch_rows=b,
                shardings=("replicated", "batch"),
                group=f"zoo/{canonical}/featurize/{compute_dtype}",
                model=canonical, bucket=b, **base))
        pb = 32
        specs.append(ProgramSpec(
            name=f"zoo/{canonical}/predict/{compute_dtype}/b{pb}",
            build=build(canonical, pb, featurize=False), batch_rows=pb,
            shardings=("replicated", "batch"),
            group=f"zoo/{canonical}/predict/{compute_dtype}", **base))
    rep = "MobileNetV2"
    if any(get_model_spec(n).name == rep for n in names):
        specs.append(ProgramSpec(
            name=f"zoo/{rep}/featurize/{compute_dtype}/b32xk4",
            build=build(rep, 32, featurize=True, group_k=4),
            batch_rows=32 * 4,
            shardings=("replicated", "stacked_batch"),
            group=f"zoo/{rep}/featurize/{compute_dtype}/grouped", **base))
    return specs


def fleet_dispatch_specs(models: Optional[Sequence[str]] = None,
                         max_batch_size: int = 32,
                         compute_dtype: str = "bfloat16"
                         ) -> List[ProgramSpec]:
    """Every program a ``serving.fleet.Fleet`` can build for its zoo
    entries: by construction the zoo x serving-bucket set of
    :func:`zoo_dispatch_specs` (a later version reuses the entry's fn with
    new weights, through the same ``bucket_plan``), so versions and hot
    swaps add no program."""
    return zoo_dispatch_specs(max_batch_size=max_batch_size, models=models,
                              compute_dtype=compute_dtype)


#: The head fan-out proof model's shape (JAX's): a 12 -> 16 feature
#: backbone in front of 64 stacked per-tenant 16 -> 4 heads.
HEADFANOUT_DIM_IN = 12
HEADFANOUT_DIM_FEAT = 16
HEADFANOUT_CLASSES = 4
HEADFANOUT_TENANTS = 64

HEADFANOUT_DONATE_REASON = (
    "the (b, 12) f32 row batch cannot alias the (b, 16) feature output "
    "(the feature cut widens it), and the fan-out program's gathered "
    "head inputs are read by every padded row — XLA would drop either "
    "donation, so the serving tier leaves both off")


def headfanout_dispatch_specs(batch_rows: int = 32,
                              tenants: int = HEADFANOUT_TENANTS
                              ) -> List[ProgramSpec]:
    """The head fan-out's program pair: the backbone cut through
    ``parallel.engine.head_fanout_backbone_fn`` (model ``"headfanout"``,
    which ``serving.cache.lockfile_model_fingerprint`` resolves), and the
    stacked bank's one head pass, kernel H1 through the fan-out callable
    ``parallel.engine.build_head_fanout`` makes for ``dense_head_row``."""
    b = batch_rows

    def build_backbone():
        import torch

        from sparkdl_tpu_torch.parallel.engine import (
            head_fanout_backbone_fn, head_fanout_module)

        module = head_fanout_module({}).to("meta")
        module.register_buffer("backbone", _meta(
            (HEADFANOUT_DIM_IN, HEADFANOUT_DIM_FEAT)))
        return (_engine_program(head_fanout_backbone_fn),
                (module, _meta((b, HEADFANOUT_DIM_IN), torch.float32)))

    def build_heads():
        import torch

        from sparkdl_tpu_torch.parallel.engine import (_make_fanout,
                                                       dense_head_row)

        fanout = _make_fanout(dense_head_row)

        def program(stacked, idx, feats):
            with torch.inference_mode():
                return fanout(stacked, idx, feats)

        stacked = {
            "kernel": _meta((tenants, HEADFANOUT_DIM_FEAT,
                             HEADFANOUT_CLASSES)),
            "bias": _meta((tenants, HEADFANOUT_CLASSES)),
        }
        return program, (stacked, _meta((b,), torch.int32),
                         _meta((b, HEADFANOUT_DIM_FEAT)))

    base = dict(kind="dispatch", donate=(),
                donate_reason=HEADFANOUT_DONATE_REASON,
                mesh_axes=dict(ONE_DEVICE_AXES))
    return [
        ProgramSpec(name=f"headfanout/backbone/f32/b{b}",
                    build=build_backbone, batch_rows=b,
                    shardings=("replicated", "batch"),
                    group="headfanout/backbone/f32",
                    model="headfanout", **base),
        ProgramSpec(name=f"headfanout/heads/k{tenants}/f32/b{b}",
                    build=build_heads, batch_rows=b,
                    shardings=("replicated", "batch", "batch"),
                    group=f"headfanout/heads/k{tenants}/f32", **base),
    ]


def generic_dispatch_specs(feature_dim: int = 16) -> List[ProgramSpec]:
    """The donated GENERIC serving program (JAX's): a square float linear
    head whose (b, 16) f32 batch the engine donates (``donate_batch=
    True``), declaring ``donate=(1,)`` with NO recorded exemption, so
    GC001 fails loudly if the batch stops matching the output."""
    b = 32

    def _build():
        import torch
        import torch.nn as nn

        def fn(module, x):
            return torch.tanh(x @ module.w)

        module = nn.Module()
        module.register_buffer("w", _meta((feature_dim, feature_dim)))
        return _engine_program(fn), (module, _meta((b, feature_dim)))

    return [ProgramSpec(
        name=f"serving/generic/tanh_linear/f32/b{b}",
        kind="dispatch", build=_build, donate=(1,), batch_rows=b,
        mesh_axes=dict(ONE_DEVICE_AXES), shardings=("replicated", "batch"),
        group="serving/generic/tanh_linear/f32")]


#: The wide-dense proof model's shape (JAX's): a (128, 131072) f32 kernel
#: of 64 MB, over GC005's 32 MB replicated budget.
WIDE_DENSE_IN = 128
WIDE_DENSE_OUT = 131072

WIDE_DENSE_DONATE_REASON = (
    "the (b, 128) f32 batch cannot alias the (b, 131072) output — the "
    "whole point of the wide head is an output wider than its input, "
    "so XLA would drop the donation")

#: the model-axis layouts JAX audits on its 8-device topology: pure
#: tensor parallel (1, 8) and mixed (2, 4)
WIDE_DENSE_LAYOUTS = ({"data": 1, "model": 8}, {"data": 2, "model": 4})


def wide_dense_fn(module, x):
    """The wide-dense proof model's fn (JAX's ``wide_dense_fn``)."""
    import torch

    return torch.tanh(x @ module.dense.kernel + module.dense.bias)


def wide_dense_module(feature_dim_in: int = WIDE_DENSE_IN,
                      feature_dim_out: int = WIDE_DENSE_OUT):
    """The wide-dense model on the meta device: ``dense.kernel`` (in,
    out) and ``dense.bias`` (out,), JAX's variable names."""
    import torch.nn as nn

    module = nn.Module()
    module.dense = nn.Module()
    module.dense.register_buffer("kernel", _meta((feature_dim_in,
                                                  feature_dim_out)))
    module.dense.register_buffer("bias", _meta((feature_dim_out,)))
    return module


def sharded_dispatch_specs(feature_dim_in: int = WIDE_DENSE_IN,
                           feature_dim_out: int = WIDE_DENSE_OUT,
                           batch_rows: int = 32) -> List[ProgramSpec]:
    """The tensor-parallel wide-dense programs (JAX's): the layout from
    ``mesh.resolve_param_shardings`` under the default rules (the kernel
    split on its output dim, the bias replicated) on each of JAX's two
    model-axis layouts, declared for GC005.  The port's runtime holds
    every weight whole on one card, so these programs are audited by the
    declaration's arithmetic, never run split."""
    from sparkdl_tpu_torch.analysis.program.audit import mesh_standin
    from sparkdl_tpu_torch.parallel import mesh as mesh_lib

    specs: List[ProgramSpec] = []
    for axes in WIDE_DENSE_LAYOUTS:
        if feature_dim_out % axes["model"]:
            continue
        module = wide_dense_module(feature_dim_in, feature_dim_out)
        _, resolved = mesh_lib.resolve_param_shardings(module,
                                                       mesh_standin(axes))
        flat_specs = [s for _, s in mesh_lib.tree_flatten_with_path(
            resolved, mesh_lib._is_spec)]
        paths = [mesh_lib.param_path_str(p)
                 for p, _ in mesh_lib.tree_flatten_with_path(module)]
        partition = tuple(sorted(
            (name, [] if mesh_lib.spec_is_replicated(s)
             else mesh_lib.spec_to_json(s))
            for name, s in zip(paths, flat_specs)))
        b = -(-batch_rows // axes["data"]) * axes["data"]

        def _build(b=b):
            return (_engine_program(wide_dense_fn),
                    (wide_dense_module(feature_dim_in, feature_dim_out),
                     _meta((b, feature_dim_in))))

        name = f"serving/wide_dense/f32/b{b}/dp{axes['data']}tp{axes['model']}"
        specs.append(ProgramSpec(
            name=name, kind="dispatch", build=_build, donate=(),
            donate_reason=WIDE_DENSE_DONATE_REASON, batch_rows=b,
            mesh_axes=dict(axes), shardings=("params", "batch"),
            param_partition=partition, group=name))
    return specs


def train_step_specs(batch_rows: int = 32, feature_dim: int = 2048,
                     num_classes: int = 10) -> List[ProgramSpec]:
    """The train-step programs (JAX's): the transfer-learning linear head
    through ``parallel.train.make_train_step`` with the port's Adam
    (optax's defaults, capturable), as one step and as a group of four
    (``steps_per_execution=4``, the captured group).  The step writes the
    params and the optimizer state in place: those are its outputs beside
    the loss, and both are donated (GC001's primary subjects)."""

    def make(k: int):
        def _build():
            import torch

            from sparkdl_tpu_torch.param.converters import NamedOptimizer
            from sparkdl_tpu_torch.parallel.train import make_train_step

            params = {"w": _meta((feature_dim, num_classes)).requires_grad_(),
                      "b": _meta((num_classes,)).requires_grad_()}
            opt = NamedOptimizer("adam")([params["w"], params["b"]])
            step = make_train_step(lambda p, xb: xb @ p["w"] + p["b"],
                                   "sparse_categorical_crossentropy", opt,
                                   params)
            x = _meta((batch_rows, feature_dim))
            y = _meta((batch_rows,), torch.int32)
            step(x, y)  # the optimizer's state exists from the first step
            state = {str(i): dict(opt.state[p])
                     for i, p in enumerate([params["w"], params["b"]])}

            def program(params, state, xs, ys):
                if k == 1:
                    losses = step(xs, ys)
                else:
                    losses = torch.stack([step(xs[i], ys[i])
                                          for i in range(k)])
                return params, state, losses

            if k == 1:
                return program, (params, state, x, y)
            return program, (params, state,
                             _meta((k, batch_rows, feature_dim)),
                             _meta((k, batch_rows), torch.int32))

        return _build

    base = dict(kind="train", donate=(0, 1), batch_rows=batch_rows,
                mesh_axes=dict(ONE_DEVICE_AXES))
    return [
        ProgramSpec(name=f"train/linear_head/step/b{batch_rows}",
                    build=make(1),
                    shardings=("replicated", "replicated", "batch",
                               "batch"),
                    group="train/linear_head/step", **base),
        ProgramSpec(name=f"train/linear_head/multi4/b{batch_rows}",
                    build=make(4),
                    shardings=("replicated", "replicated",
                               "stacked_batch", "stacked_batch"),
                    group="train/linear_head/multi4", **base),
    ]


def _kernel_operands(s: Dict[str, int], mbconv: bool = False) -> tuple:
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    return (_meta((s["b"], s["h"], s["w"], s["c"]), bf),
            _meta((3, 3, s["c"]), bf), _meta((s["c"], s["f"]), bf),
            _meta((s["c"] if mbconv else s["f"],), f32),
            _meta((s["f"],), f32))


def sepconv_kernel_specs() -> List[ProgramSpec]:
    """The three hand-written Hopper kernels at JAX's canonical audit
    shapes, through their wrappers' meta paths: B1 (``fused_sepconv``),
    B3 (``fused_sepconv(row_tile=8)``) and B2 (``fused_mbconv``)."""

    def build_sepconv():
        from sparkdl_tpu_torch.ops.sepconv import fused_sepconv

        return (lambda *a: fused_sepconv(*a, pre_relu=True,
                                         post_relu=False),
                _kernel_operands(_KERNEL_SHAPES["sepconv"]))

    def build_tiled():
        from sparkdl_tpu_torch.ops.sepconv import fused_sepconv

        s = _KERNEL_SHAPES["sepconv_tiled"]
        return (lambda *a: fused_sepconv(*a, pre_relu=True, post_relu=False,
                                         row_tile=s["th"]),
                _kernel_operands(s))

    def build_mbconv():
        from sparkdl_tpu_torch.ops.sepconv import fused_mbconv

        return fused_mbconv, _kernel_operands(_KERNEL_SHAPES["mbconv"],
                                              mbconv=True)

    base = dict(kind="kernel", donate=(),
                donate_reason=SEPCONV_DONATE_REASON,
                compute_dtype="bfloat16")
    s1 = _KERNEL_SHAPES["sepconv"]
    s2 = _KERNEL_SHAPES["sepconv_tiled"]
    s3 = _KERNEL_SHAPES["mbconv"]
    return [
        ProgramSpec(name=f"kernel/sepconv/{s1['h']}x{s1['w']}x{s1['c']}",
                    build=build_sepconv, batch_rows=s1["b"],
                    group="kernel/sepconv", **base),
        ProgramSpec(
            name=f"kernel/sepconv_tiled/{s2['h']}x{s2['w']}x{s2['c']}",
            build=build_tiled, batch_rows=s2["b"],
            group="kernel/sepconv_tiled", **base),
        ProgramSpec(name=f"kernel/mbconv/{s3['h']}x{s3['w']}x{s3['c']}",
                    build=build_mbconv, batch_rows=s3["b"],
                    group="kernel/mbconv", **base),
    ]


def _one_device_mesh():
    """The zoo's mesh for ``bucket_plan``: one (meta) device, shape
    (1, 1), as an engine's mesh is this process's one device."""
    import torch

    from sparkdl_tpu_torch.parallel.mesh import Mesh

    return Mesh([[torch.device("meta")]])


def stack_programs(max_batch_size: int = 32,
                   models: Optional[Sequence[str]] = None,
                   compute_dtype: str = "bfloat16",
                   include_train: bool = True,
                   include_kernels: bool = True) -> List[ProgramSpec]:
    """The full auditable inventory (JAX's families): zoo x bucket plan,
    the generic donated program, the wide-dense pair, the head fan-out
    pair, and (unless excluded) the train steps and the kernel programs.
    ``models`` narrows the zoo sweep (a subset audit)."""
    specs = zoo_dispatch_specs(max_batch_size=max_batch_size,
                               models=models, compute_dtype=compute_dtype)
    specs.extend(generic_dispatch_specs())
    specs.extend(sharded_dispatch_specs())
    specs.extend(headfanout_dispatch_specs())
    if include_train:
        specs.extend(train_step_specs())
    if include_kernels:
        specs.extend(sepconv_kernel_specs())
    return specs
