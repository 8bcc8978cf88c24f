"""OpenCV-convention image struct schema (port of ``sparkdl_tpu/image/schema.py``).

Replaces the image representation of ``python/sparkdl/image/imageIO.py``
(``imageSchema``, ``imageArrayToStruct``, ``imageStructToArray`` and the
OpenCV mode tables ``CV_8UC1/3/4`` + float variants).  An image is a struct

    {origin: str, height: i32, width: i32, nChannels: i32, mode: i32,
     data: binary}

with ``data`` holding row-major bytes in **BGR** channel order for 3/4-channel
uint8 images (OpenCV convention, same as Spark 2.3's ImageSchema which the
reference's schema was upstreamed into).  Arrow struct arrays use exactly these
field names so frames interop with Spark's image source format.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import pyarrow as pa


@dataclass(frozen=True)
class ImageType:
    """One OpenCV storage mode: name, numeric mode code, channels, dtype."""
    name: str
    ord: int
    nChannels: int
    dtype: str

    @property
    def itemsize(self) -> int:
        return np.dtype(self.dtype).itemsize


# OpenCV type table — codes follow OpenCV's CV_<depth>C<channels> encoding
# (mode = depth + (channels-1)*8), matching the reference's table and Spark's
# ImageSchema.ocvTypes.
_SUPPORTED_TYPES = [
    ImageType("CV_8UC1", 0, 1, "uint8"),
    ImageType("CV_8UC3", 16, 3, "uint8"),
    ImageType("CV_8UC4", 24, 4, "uint8"),
    ImageType("CV_32FC1", 5, 1, "float32"),
    ImageType("CV_32FC3", 21, 3, "float32"),
    ImageType("CV_32FC4", 29, 4, "float32"),
]

ocvTypes: Dict[str, int] = {t.name: t.ord for t in _SUPPORTED_TYPES}
_BY_MODE: Dict[int, ImageType] = {t.ord: t for t in _SUPPORTED_TYPES}
_BY_NAME: Dict[str, ImageType] = {t.name: t for t in _SUPPORTED_TYPES}


def imageTypeByMode(mode: int) -> ImageType:
    try:
        return _BY_MODE[int(mode)]
    except KeyError:
        raise ValueError(f"Unsupported OpenCV image mode {mode!r}; "
                         f"supported: {sorted(_BY_MODE)}")


def imageTypeByName(name: str) -> ImageType:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"Unsupported OpenCV image type {name!r}; "
                         f"supported: {sorted(_BY_NAME)}")


# Arrow schema for the image struct column (field order mirrors Spark's
# ImageSchema.columnSchema).
imageSchema: pa.StructType = pa.struct([
    pa.field("origin", pa.string()),
    pa.field("height", pa.int32()),
    pa.field("width", pa.int32()),
    pa.field("nChannels", pa.int32()),
    pa.field("mode", pa.int32()),
    pa.field("data", pa.binary()),
])


class ImageSchema:
    """Namespace mirroring the reference's schema helpers."""

    columnSchema = imageSchema
    ocvTypes = ocvTypes
    imageFields = ["origin", "height", "width", "nChannels", "mode", "data"]
    undefinedImageType = "Undefined"

    imageTypeByMode = staticmethod(imageTypeByMode)
    imageTypeByName = staticmethod(imageTypeByName)


def _infer_image_type(array: np.ndarray) -> ImageType:
    if array.ndim != 3:
        raise ValueError(
            f"Expected an image array of rank 3 [H,W,C], got shape {array.shape}")
    n = array.shape[2]
    if array.dtype == np.uint8:
        name = {1: "CV_8UC1", 3: "CV_8UC3", 4: "CV_8UC4"}.get(n)
    elif array.dtype == np.float32:
        name = {1: "CV_32FC1", 3: "CV_32FC3", 4: "CV_32FC4"}.get(n)
    else:
        raise ValueError(
            f"Unsupported image dtype {array.dtype}; use uint8 or float32")
    if name is None:
        raise ValueError(f"Unsupported channel count {n}")
    return imageTypeByName(name)


def imageArrayToStruct(array: np.ndarray, origin: str = "") -> dict:
    """Pack a [H,W,C] numpy array (BGR channel order for color) into the image
    struct dict.  Counterpart of ``imageIO.imageArrayToStruct``."""
    array = np.ascontiguousarray(array)
    if array.ndim == 2:
        array = array[:, :, None]
    t = _infer_image_type(array)
    h, w, c = array.shape
    return {
        "origin": origin,
        "height": int(h),
        "width": int(w),
        "nChannels": int(c),
        "mode": t.ord,
        "data": array.tobytes(),
    }


def imageStructToArray(struct: dict) -> np.ndarray:
    """Unpack an image struct dict into a [H,W,C] numpy array (BGR order for
    color images).  Counterpart of ``imageIO.imageStructToArray``."""
    t = imageTypeByMode(struct["mode"])
    h, w, c = int(struct["height"]), int(struct["width"]), int(struct["nChannels"])
    if c != t.nChannels:
        raise ValueError(
            f"nChannels {c} inconsistent with mode {t.name} ({t.nChannels})")
    data = struct["data"]
    if isinstance(data, memoryview):
        data = bytes(data)
    arr = np.frombuffer(data, dtype=t.dtype)
    expected = h * w * c
    if arr.size != expected:
        raise ValueError(
            f"Image data has {arr.size} elements; expected {expected} "
            f"for shape ({h},{w},{c})")
    return arr.reshape(h, w, c)


def structsToArrow(structs, column: str = "image") -> pa.Table:
    """Build a single-column Arrow table of image structs."""
    arr = pa.array(structs, type=imageSchema)
    return pa.table({column: arr})
