"""transform360_tpu_torch — the PyTorch/CUDA port of transform360_tpu.

360° video re-projection (equirect ↔ cubemap and friends) on an NVIDIA
GPU: plan-time warp maps and prefilter plans built on the CPU, and three
hand-written CUDA kernels on the frame path — K1, the adaptive prefilter
(``csrc/blur.cu``), K3, the window-gather remap (``csrc/window.cu``),
and K4, the INTER_AREA resize of supersampled configs (``csrc/area.cu``)
— each with a plain PyTorch version that serves CPU tensors, for 8-bit
and deep (10-, 12-, 16-bit) pixel formats; ``ops.nodes`` is their one C
ABI seam, and plans save to and load from the JAX package's plan files.  ``python -m transform360_tpu_torch.cli`` is the
command-line front end.  The JAX package
``transform360_tpu`` is the reference; this package imports neither it
nor jax.
"""

from .config import (
    FaceType,
    FilterOptions,
    Interpolation,
    Layout,
    StereoFormat,
    TransformConfig,
    chroma_dims,
    negotiate_output_geometry,
    parse_options,
    resolve_stereo_formats,
)
from .api import Transform360, open_filter
from .plan import TransformPlan, build_plan, load_plan, plan_from_jax, save_plan
from .pipeline import device_put_plan, transform_batch, transform_frame

__version__ = "0.1.0"

__all__ = [
    "FaceType",
    "FilterOptions",
    "Interpolation",
    "Layout",
    "StereoFormat",
    "TransformConfig",
    "Transform360",
    "TransformPlan",
    "build_plan",
    "chroma_dims",
    "device_put_plan",
    "load_plan",
    "negotiate_output_geometry",
    "open_filter",
    "parse_options",
    "plan_from_jax",
    "resolve_stereo_formats",
    "save_plan",
    "transform_batch",
    "transform_frame",
    "__version__",
]
