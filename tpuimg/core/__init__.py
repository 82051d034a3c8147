from tpuimg.core.borders import REFLECT101, REPLICATE, SHRINK, pad2d, pad_mode
from tpuimg.core.kernelgen import gaussian_kernel_1d, gaussian_kernel_2d
from tpuimg.core.layout import cdiv, round_up
from tpuimg.core.timing import BenchResult, time_stream_fn

__all__ = [
    "REFLECT101", "REPLICATE", "SHRINK", "pad2d", "pad_mode",
    "gaussian_kernel_1d", "gaussian_kernel_2d",
    "cdiv", "round_up",
    "BenchResult", "time_stream_fn",
]
