"""UDF deployment layer (port of ``sparkdl_tpu.udf``).

A registered UDF is a vectorized callable over an image-struct (or tensor)
column, backed by the same engine the transformers use.  Standalone it
applies to our Arrow DataFrame; when pyspark is importable,
``to_pandas_udf`` emits a real ``pyspark.sql.functions.pandas_udf``.
``register_serving_udf`` puts a running ``serving.Server`` behind a column.
"""

from sparkdl_tpu_torch.udf.registry import (UDFRegistry, register_image_udf,
                                            register_serving_udf,
                                            register_udf,
                                            registerKerasImageUDF,
                                            udf_registry)

__all__ = [
    "UDFRegistry", "register_image_udf", "register_serving_udf",
    "register_udf", "registerKerasImageUDF", "udf_registry",
]
