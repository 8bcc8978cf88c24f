"""The JAX package's zoo variables -> the port's ``state_dict``.

``state_dict_from_jax(name, variables)`` takes the variable tree of the
JAX zoo module (``{"params": ..., "batch_stats": ...}`` with numpy leaves,
as ``jax.tree_util.tree_map(np.asarray, variables)`` gives it; this module
imports no JAX) and maps it by layer path, nested paths included
(InceptionV3's ``stem_conv1/conv`` -> ``stem_conv1.conv.weight``):

  * conv ``kernel`` HWIO -> ``weight`` OIHW
  * ``depthwise_kernel`` [3,3,C,1] -> ``depthwise_weight`` [C,1,3,3]
    (a SeparableConv2D's, or a DepthwiseConv2D's on its own)
  * ``pointwise_kernel`` [1,1,C,F] -> ``pointwise_weight`` [F,C,1,1]
  * BatchNorm ``scale``/``bias`` + ``mean``/``var`` -> ``weight``/``bias``
    + ``running_mean``/``running_var`` (``num_batches_tracked`` = 0); a
    BatchNorm without a scale has no ``weight``
  * EfficientNet's ``InputNorm`` (``mean``/``var``/``post_scale``
    statistics, no parameters) -> the same three buffers
  * dense ``kernel`` [in,out] -> ``Linear.weight`` [out,in]

It raises on any leaf it cannot place and on any port tensor left unset.
The layout transposes are :func:`kernel_to_torch`,
:func:`depthwise_to_torch` and :func:`pointwise_to_torch`, which the Keras
importer (``models/keras_import.py``) shares: Keras and the JAX package
keep the same layouts.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from sparkdl_tpu_torch.models import get_model_spec


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def kernel_to_torch(k, name: str) -> torch.Tensor:
    """A conv kernel HWIO -> OIHW, a dense kernel [in,out] -> [out,in]."""
    k = _tensor(k)
    if k.dim() == 4:
        return k.permute(3, 2, 0, 1)
    if k.dim() == 2:
        return k.t()
    raise ValueError(f"{name}/kernel has unexpected rank {k.dim()}")


def depthwise_to_torch(k) -> torch.Tensor:
    """A depthwise kernel [kh,kw,C,mult] -> the grouped conv's
    [C*mult,1,kh,kw] (output channel c*mult + j, as Keras orders them)."""
    k = _tensor(k)
    kh, kw, c, m = k.shape
    return k.permute(2, 3, 0, 1).reshape(c * m, 1, kh, kw)


def pointwise_to_torch(k) -> torch.Tensor:
    """A pointwise kernel [1,1,C,F] -> [F,C,1,1]."""
    return _tensor(k).permute(3, 2, 0, 1)


def _layer(name: str, leaves: Mapping, st: Mapping) -> Dict[str, torch.Tensor]:
    """The port tensors of one layer: its parameter leaves and its
    batch_stats leaves ``st`` (empty for a layer without statistics)."""
    leaves = dict(leaves)
    st = dict(st)
    out: Dict[str, torch.Tensor] = {}
    if "depthwise_kernel" in leaves or "pointwise_kernel" in leaves:
        if "depthwise_kernel" in leaves:
            out["depthwise_weight"] = depthwise_to_torch(
                leaves.pop("depthwise_kernel"))
        if "pointwise_kernel" in leaves:
            out["pointwise_weight"] = pointwise_to_torch(
                leaves.pop("pointwise_kernel"))
    elif "kernel" in leaves:
        out["weight"] = kernel_to_torch(leaves.pop("kernel"), name)
        if "bias" in leaves:
            out["bias"] = _tensor(leaves.pop("bias"))
    elif "post_scale" in st and not leaves:
        for key in ("mean", "var", "post_scale"):
            if key in st:
                out[key] = _tensor(st.pop(key))
    elif st:
        # a leaf missing here leaves its port tensor unset, which the
        # caller's check names
        for src, key, dst in (("scale", "weight", leaves),
                              ("bias", "bias", leaves),
                              ("mean", "running_mean", st),
                              ("var", "running_var", st)):
            if src in dst:
                out[key] = _tensor(dst.pop(src))
        out["num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    if st:
        raise ValueError(f"unused batch_stats leaves {name}/{sorted(st)}")
    if leaves:
        raise ValueError(f"unused variable leaves {name}/{sorted(leaves)}")
    prefix = name.replace("/", ".")
    return {f"{prefix}.{k}": v.contiguous() for k, v in out.items()}


def _walk(path: str, params: Mapping, stats: Mapping,
          sd: Dict[str, torch.Tensor]) -> None:
    """Place the layer at ``path`` (its array leaves, if any) and walk its
    sub-layers; ``stats`` is the batch_stats node at the same path (a
    sub-layer may have statistics only, as EfficientNet's ``InputNorm``)."""
    leaves = {k: v for k, v in params.items() if not isinstance(v, Mapping)}
    st = {k: v for k, v in stats.items() if not isinstance(v, Mapping)}
    if leaves or st:
        sd.update(_layer(path.rstrip("/"), leaves, st))
    children = [k for k, v in params.items() if isinstance(v, Mapping)]
    children += [k for k, v in stats.items()
                 if isinstance(v, Mapping) and k not in children]
    for k in children:
        _walk(f"{path}{k}/", params.get(k, {}), stats.get(k, {}), sd)


def state_dict_from_jax(name: str, variables: Mapping,
                        **build_kwargs) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for zoo model ``name`` from the JAX
    module's variables; see the module doc for the mapping.
    ``build_kwargs`` go to the model's builder beside ``num_classes``
    (read off ``predictions``), for a tree of a narrowed build (ResNet's
    ``stages``, VGG's ``input_size``)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unused variable collections {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}
    _walk("", params, stats, sd)

    num_classes = int(np.shape(params["predictions"]["kernel"])[-1])
    with torch.device("meta"):
        expected = get_model_spec(name).build(
            num_classes=num_classes, **build_kwargs).state_dict()
    missing = sorted(set(expected) - set(sd))
    unused = sorted(set(sd) - set(expected))
    if missing or unused:
        raise ValueError(f"{name}: port tensors without a JAX leaf "
                         f"{missing[:5]}, JAX leaves without a port tensor "
                         f"{unused[:5]}")
    for key, t in expected.items():
        if tuple(sd[key].shape) != tuple(t.shape):
            raise ValueError(f"{key}: JAX gives shape {tuple(sd[key].shape)}, "
                             f"the port needs {tuple(t.shape)}")
    return sd
