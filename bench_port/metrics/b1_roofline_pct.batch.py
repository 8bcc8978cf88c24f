"""b1_roofline_pct.batch (kernels): kernel B1's least time (the larger of its
frozen operations over the bf16 peak and its frozen bytes over the HBM
bandwidth, for the launches in the traced window) over B1's device time
in that window."""

from bench_port.lib.readers import kernel_roofline_pct

# B1's instantiations in the trace: void sepconv_kernel<NT, PRE, POST>(...)
PATTERN = r"\bsepconv_kernel<"


def read(w):
    return kernel_roofline_pct(w, PATTERN, "b1_launch_classes")
