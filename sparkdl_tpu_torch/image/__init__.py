"""Image schema + host-side I/O (port of ``sparkdl_tpu.image``).

pyarrow and PIL are imported by this layer only, so ``sparkdl_tpu_torch.ops``
and ``sparkdl_tpu_torch.models`` import on a machine without them.
"""

from sparkdl_tpu_torch.image.schema import (
    ImageSchema,
    imageSchema,
    ocvTypes,
    imageTypeByMode,
    imageTypeByName,
    imageArrayToStruct,
    imageStructToArray,
)
from sparkdl_tpu_torch.image.io import (
    PIL_decode,
    arrowStructsToBatch,
    createResizeImageUDF,
    decodeImage,
    decodeResizeBatch,
    filesToDF,
    filesToModelBatch,
    iterFileBatches,
    iterImageBatches,
    readImages,
    readImagesWithCustomFn,
    resizeImage,
    structToModelInput,
    structsToBatch,
)

__all__ = [
    "ImageSchema",
    "imageSchema",
    "ocvTypes",
    "imageTypeByMode",
    "imageTypeByName",
    "imageArrayToStruct",
    "imageStructToArray",
    "PIL_decode",
    "arrowStructsToBatch",
    "createResizeImageUDF",
    "decodeImage",
    "decodeResizeBatch",
    "filesToDF",
    "filesToModelBatch",
    "iterFileBatches",
    "iterImageBatches",
    "readImages",
    "readImagesWithCustomFn",
    "resizeImage",
    "structToModelInput",
    "structsToBatch",
]
