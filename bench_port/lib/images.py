"""Seeded input images and the image-struct column the batch cells read.

Images are smooth random pictures: each is a sum of noise fields drawn at
four scales (2x2, 8x8, 32x32 upsampled bilinearly, and per pixel), so
images differ in the large structures a CNN's pooled features see, as
natural photographs do.  Independent noise per pixel would give every
image nearly the same pooled features, and an output check could then
not tell one row from another.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pyarrow as pa
import torch
import torch.nn.functional as F

# (grid side or None for per pixel, amplitude in grey levels)
OCTAVES: Tuple[Tuple[object, float], ...] = (
    (2, 60.0), (8, 40.0), (32, 25.0), (None, 15.0))

# The OpenCV-convention image struct (Spark's ImageSchema.columnSchema):
# data holds row-major uint8 BGR bytes; mode 16 is CV_8UC3.
IMAGE_STRUCT = pa.struct([
    pa.field("origin", pa.string()),
    pa.field("height", pa.int32()),
    pa.field("width", pa.int32()),
    pa.field("nChannels", pa.int32()),
    pa.field("mode", pa.int32()),
    pa.field("data", pa.binary()),
])
CV_8UC3 = 16


def smooth_images(n: int, height: int, width: int,
                  generator: torch.Generator, device: torch.device,
                  block: int = 128) -> torch.Tensor:
    """uint8 [n, height, width, 3] on ``device``, made ``block`` images at
    a time."""
    out = torch.empty((n, height, width, 3), dtype=torch.uint8,
                      device=device)
    for lo in range(0, n, block):
        b = min(block, n - lo)
        acc = torch.full((b, 3, height, width), 128.0, device=device)
        for side, amp in OCTAVES:
            if side is None:
                z = torch.randn((b, 3, height, width), generator=generator,
                                device=device)
            else:
                z = F.interpolate(
                    torch.randn((b, 3, side, side), generator=generator,
                                device=device),
                    size=(height, width), mode="bilinear",
                    align_corners=False)
            acc.add_(z, alpha=amp)
        out[lo:lo + b] = acc.clamp_(0, 255).round_().to(
            torch.uint8).permute(0, 2, 3, 1)
    return out


def struct_column(bgr: np.ndarray, valid: np.ndarray) -> pa.StructArray:
    """The image-struct column over ``bgr`` ([n, h, w, 3] uint8, C order),
    row ``i`` null where ``valid[i]`` is False, built over the array's
    own bytes in one piece."""
    n, h, w, c = bgr.shape
    row = h * w * c
    offsets = pa.py_buffer((np.arange(n + 1, dtype=np.int64) * row)
                           .astype(np.int32))
    data = pa.Array.from_buffers(pa.binary(), n,
                                 [None, offsets, pa.py_buffer(bgr)])

    def const(v):
        return pa.array(np.full(n, v, np.int32))

    origin = pa.array([""] * n, pa.string())
    return pa.StructArray.from_arrays(
        [origin, const(h), const(w), const(c), const(CV_8UC3), data],
        fields=list(IMAGE_STRUCT), mask=pa.array(~valid))
