"""Content digests: sha256 over dtype, shape and bytes (port of
``sparkdl_tpu/utils/digest.py``).

One core for every "same bytes" question: the serving result cache keys
its entries on :func:`content_digest`, and the streaming sources and
journal name chunks by :func:`content_chunk_id`.  Every digest covers
dtype, shape AND bytes, so two arrays that merely reinterpret each other's
buffers (f32 vs u8 views, [2, 6] vs [3, 4]) never collide.

A single array (numpy, or a torch tensor on the CPU) digests to the same
hex string as the JAX package's, so the two packages' caches and journals
agree on it.  A pytree digest hashes the port's own description of the
tree's structure (:func:`tree_structure`) where the JAX package hashes
``str(jax treedef)``, which the port cannot reproduce without JAX: pytree
digests differ across the two packages (each is stable within its own).
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

from sparkdl_tpu_torch.parallel.engine import _tree_leaves


def _as_numpy(arr: Any) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(arr)


def array_digest(arr: Any) -> str:
    """Full sha256 hexdigest over one array's dtype/shape/bytes.  Stable
    across processes: two reads of the same payload always agree; two
    payloads differing in dtype, shape, or any byte never do."""
    a = _as_numpy(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def content_chunk_id(offset: int, payload: Any) -> str:
    """Stable content-addressed chunk id: zero-padded offset (so ids sort
    in stream order) + the first 16 hex chars of :func:`array_digest`."""
    return f"{offset:08d}-{array_digest(payload)[:16]}"


def tree_structure(tree: Any) -> str:
    """The structure of a pytree (dicts with sorted keys, lists, tuples,
    None) with every leaf written ``*``: what a pytree digest hashes
    beside its leaves."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(tree_structure(t) for t in tree)
        if hasattr(tree, "_fields"):  # namedtuple
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def content_digest(payload: Any) -> str:
    """Digest of an arbitrary payload: a single array digests via
    :func:`array_digest` (the JAX package's string); a pytree of arrays
    digests each leaf plus :func:`tree_structure`, so two pytrees collide
    only when every leaf AND the structure match."""
    if (isinstance(payload, (np.ndarray, torch.Tensor))
            or np.isscalar(payload)):
        return array_digest(payload)
    h = hashlib.sha256()
    h.update(tree_structure(payload).encode())
    for leaf in _tree_leaves(payload):
        h.update(array_digest(leaf).encode())
    return h.hexdigest()


def module_digest(module: torch.nn.Module) -> str:
    """Digest of a module's weights: :func:`content_digest` over its
    ``state_dict`` (every parameter and buffer by name, on the host; a
    bf16 tensor, which numpy cannot hold, by its 16-bit patterns).  The
    port's own digest of a backbone's weights: the JAX package digests a
    flax variables tree, so the two differ for the same numbers."""
    def host(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().cpu()
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    return content_digest({k: host(v)
                           for k, v in module.state_dict().items()})
