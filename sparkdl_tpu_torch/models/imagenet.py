"""ImageNet top-K prediction decoding (port of
``sparkdl_tpu/models/imagenet.py``).

Counterpart of the reference's ``_decodeOutputAsPredictions``, which
delegated to ``keras.decode_predictions``.  The ImageNet class-index JSON
is read from a local file when one is found; otherwise rows decode to
stable synthetic ids (``class_123``).  Nothing is downloaded.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_CLASS_INDEX = None          # idx -> (synset_id, description)
_CLASS_INDEX_TRIED = False


def reset_class_index_cache():
    global _CLASS_INDEX, _CLASS_INDEX_TRIED
    _CLASS_INDEX = None
    _CLASS_INDEX_TRIED = False


def _class_index_candidates():
    """Air-gap-friendly resolution order for the class-index JSON:

    1. ``SPARKDL_CLASS_INDEX`` — explicit file path
    2. ``<package>/models/data/imagenet_class_index.json`` — vendored copy
       (drop the public 35 KB file here for fully offline deployments)
    3. ``$SPARKDL_WEIGHTS_DIR/imagenet_class_index.json`` — alongside the
       offline weight bundle
    """
    import os

    explicit = os.environ.get("SPARKDL_CLASS_INDEX")
    if explicit:
        yield explicit
    yield os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "data", "imagenet_class_index.json")
    wdir = os.environ.get("SPARKDL_WEIGHTS_DIR")
    if wdir:
        yield os.path.join(wdir, "imagenet_class_index.json")


def _parse_class_index(path):
    import json

    with open(path) as f:
        raw = json.load(f)
    return {int(k): (v[0], v[1]) for k, v in raw.items()}


def _load_class_index():
    global _CLASS_INDEX, _CLASS_INDEX_TRIED
    if _CLASS_INDEX_TRIED:
        return _CLASS_INDEX
    _CLASS_INDEX_TRIED = True
    import os

    for path in _class_index_candidates():
        if not os.path.isfile(path):
            continue
        try:
            _CLASS_INDEX = _parse_class_index(path)
            return _CLASS_INDEX
        except (OSError, ValueError, KeyError, IndexError, TypeError) as e:
            logger.warning("Bad class-index file %s (%s); trying next", path, e)
    logger.warning(
        "ImageNet class index not found; topK decode uses synthetic class "
        "ids. Provide it via SPARKDL_CLASS_INDEX or the package data dir "
        "(see _class_index_candidates)")
    return _CLASS_INDEX


def decode_predictions(probs: np.ndarray, top: int = 5
                       ) -> List[List[Tuple[str, str, float]]]:
    """[(class_id, description, probability) x top] per row, sorted
    descending — same row shape as keras ``decode_predictions``."""
    probs = np.asarray(probs)
    if probs.ndim != 2:
        raise ValueError(f"Expected [batch, classes] probabilities, got "
                         f"shape {probs.shape}")
    index = _load_class_index()
    out = []
    for row in probs:
        top_idx = np.argsort(row)[::-1][:top]
        decoded = []
        for i in top_idx:
            if index is not None and int(i) in index:
                cid, desc = index[int(i)]
            else:
                cid = desc = f"class_{int(i)}"
            decoded.append((cid, desc, float(row[i])))
        out.append(decoded)
    return out
