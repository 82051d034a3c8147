"""tpuimg — classical image processing in JAX/XLA.

A from-scratch JAX redesign of the capabilities of the CUDA reference
MrAoTian/CudaImageProcessing (see SURVEY.md). Public per-op API mirrors the
reference entry points (SURVEY.md §7).
"""

from tpuimg.ops import (
    box_filter,
    clahe,
    dilate,
    erode,
    gaussian,
    guided_filter,
    hist_equalize,
    integral,
    morph_close,
    morph_open,
)

__version__ = "0.1.0"

__all__ = [
    "box_filter", "clahe", "dilate", "erode", "gaussian", "guided_filter",
    "hist_equalize", "integral", "morph_close", "morph_open",
]
