"""PyTorch/CUDA port of the stereo moving-object detector.

The same detector as the JAX package beside it (the reference),
written in PyTorch for an NVIDIA H100: SGM stereo and the PWC-Net
correlation run on hand-written CUDA kernels (``csrc/``), the rest is
plain PyTorch. The port imports nothing of the JAX package; it keeps its
own copies of what it needs (``config.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without a device they raise. On CPU tensors every kernel
wrapper runs its plain PyTorch version.
"""

import torch as _torch

# Geometry, ego-motion and Kalman math must stay in full f32 (the JAX
# package pins f32 matmuls for the same reason: a reduced-precision 3x3
# product was measured 2e-3 off). PyTorch keeps f32 matmuls exact by
# default but sends f32 convolutions through TF32; turn both off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import (  # noqa: E402
    DEFAULT_CONFIG,
    ClustererConfig,
    EgoMotionConfig,
    FlowNetConfig,
    PipelineConfig,
    RAFTConfig,
    SceneFlowConfig,
    SGMConfig,
    TrackerConfig,
)
from .types import (  # noqa: E402
    CameraModel,
    DisparityImage,
    MovingObjects,
    SceneFlowCloud,
    StereoModel,
    TrackedObjects,
)


def resolve_device(device=None) -> _torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``cuda``. Raises when no device was given and CUDA is absent; the port
    never moves to the CPU on its own."""
    if device is not None:
        return _torch.device(device)
    if not _torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch forms on the CPU"
        )
    return _torch.device("cuda")


__version__ = "0.1.0"
