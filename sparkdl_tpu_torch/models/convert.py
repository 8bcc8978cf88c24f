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
  * dense ``kernel`` [in,out] -> ``Linear.weight`` [out,in]

It raises on any leaf it cannot place and on any port tensor left unset.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from sparkdl_tpu_torch.models import get_model_spec


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layer(name: str, leaves: Mapping, st: Mapping) -> Dict[str, torch.Tensor]:
    """The port tensors of one layer: its parameter leaves and its
    batch_stats leaves ``st`` (empty for a layer without statistics)."""
    leaves = dict(leaves)
    st = dict(st)
    out: Dict[str, torch.Tensor] = {}
    if "depthwise_kernel" in leaves or "pointwise_kernel" in leaves:
        if "depthwise_kernel" in leaves:
            out["depthwise_weight"] = _tensor(
                leaves.pop("depthwise_kernel")).permute(2, 3, 0, 1)
        if "pointwise_kernel" in leaves:
            out["pointwise_weight"] = _tensor(
                leaves.pop("pointwise_kernel")).permute(3, 2, 0, 1)
    elif "kernel" in leaves:
        k = _tensor(leaves.pop("kernel"))
        if k.dim() == 4:
            out["weight"] = k.permute(3, 2, 0, 1)
        elif k.dim() == 2:
            out["weight"] = k.t()
        else:
            raise ValueError(f"{name}/kernel has unexpected rank {k.dim()}")
        if "bias" in leaves:
            out["bias"] = _tensor(leaves.pop("bias"))
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
    sub-layers; ``stats`` is the batch_stats node at the same path."""
    extra = ({k for k, v in stats.items() if isinstance(v, Mapping)}
             - {k for k, v in params.items() if isinstance(v, Mapping)})
    if extra:
        raise ValueError(f"unused batch_stats layers "
                         f"{sorted(f'{path}{k}' for k in extra)}")
    leaves = {k: v for k, v in params.items() if not isinstance(v, Mapping)}
    st = {k: v for k, v in stats.items() if not isinstance(v, Mapping)}
    if leaves or st:
        sd.update(_layer(path.rstrip("/"), leaves, st))
    for k, v in params.items():
        if isinstance(v, Mapping):
            _walk(f"{path}{k}/", v, stats.get(k, {}), sd)


def state_dict_from_jax(name: str, variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for zoo model ``name`` from the JAX
    module's variables; see the module doc for the mapping."""
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
            num_classes=num_classes).state_dict()
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
