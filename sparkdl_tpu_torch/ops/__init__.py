"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(port of ``sparkdl_tpu.ops``).  The wrappers take NHWC tensors; the JAX
package's padded-flat row layout (``fused_sepconv_flat``, ``pad_to_flat``,
``unflatten``) is a TPU layout with no counterpart here.  ``head_pass``
(kernel H1, the head fan-out's head pass) and its plain version are the
port's own: the JAX package runs that head through XLA."""

from sparkdl_tpu_torch.ops.head import head_pass, head_pass_reference
from sparkdl_tpu_torch.ops.sepconv import (fused_mbconv, fused_sepconv,
                                           mbconv_reference,
                                           sepconv_reference)

__all__ = ["fused_mbconv", "fused_sepconv", "head_pass",
           "head_pass_reference", "mbconv_reference", "sepconv_reference"]
