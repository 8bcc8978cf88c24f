"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(port of ``sparkdl_tpu.ops``).  The wrappers take NHWC tensors; the JAX
package's padded-flat row layout (``fused_sepconv_flat``, ``pad_to_flat``,
``unflatten``) is a TPU layout with no counterpart here."""

from sparkdl_tpu_torch.ops.sepconv import (fused_mbconv, fused_sepconv,
                                           mbconv_reference,
                                           sepconv_reference)

__all__ = ["fused_mbconv", "fused_sepconv", "mbconv_reference",
           "sepconv_reference"]
