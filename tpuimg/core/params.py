"""Op configuration dataclasses.

The reference's configuration is positional argv + compile-time macros /
template parameters (SURVEY.md §5 "Config/flag system"); here each op family
gets a small frozen dataclass whose fields are the static (trace-time)
arguments, hashable so configs can be jit static args directly.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpuimg.core.validate import ParamError, check_positive, check_radius


@dataclass(frozen=True)
class GaussianConfig:
    radius: int = 1
    sigma: float = 1.0  # <=0 selects OpenCV's derived sigma / small-kernel table

    def __post_init__(self):
        check_radius(self.radius)


@dataclass(frozen=True)
class ClaheConfig:
    clip_limit: float = 1.0  # demo default, Histogram/main.cpp:80
    xtiles: int = 8
    ytiles: int = 8

    def __post_init__(self):
        check_positive(self.clip_limit, "clip_limit")
        check_radius(self.xtiles, name="xtiles")
        check_radius(self.ytiles, name="ytiles")


@dataclass(frozen=True)
class GuidedConfig:
    radius: int = 4
    eps: float = 0.3  # demo default, GuidedFilter/main.cpp:184-190
    border: str = "shrink"  # class path; "reflect101" = fused path

    def __post_init__(self):
        check_radius(self.radius)
        check_positive(self.eps, "eps")


@dataclass(frozen=True)
class MorphConfig:
    radius: int = 5
    mode: int = 0  # 0 = erode/min, 1 = dilate/max (fn table image_process.cu:11-26)

    def __post_init__(self):
        check_radius(self.radius)
        if self.mode not in (0, 1):
            raise ParamError(
                f"mode must be 0 (erode) or 1 (dilate), got {self.mode}")
