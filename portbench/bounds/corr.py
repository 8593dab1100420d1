"""Bytes and operations of one launch of the correlation forward
(``csrc/corr.cu`` ``corr_kernel``) from its call shapes.

Frozen from ``chip_smoke.py`` ``check_corr_kernel`` at fc97bde: both
(B, C, H, W) f32 feature maps read once and the (B, (2r+1)^2, H, W) f32
cost volume written once; a multiply-add for every offset, channel and
pixel.
"""

import re

NAME = "corr"
TARGET = "moving_object_detector_tpu_torch.ops.flow_corr_cuda:corr_forward"
DEVICE_NAME = re.compile(r"corr_kernel")


def bytes_ops(f1, f2, search_range=4, *args, **kwargs):
    b, c, h, w = f1.shape
    k = (2 * search_range + 1) ** 2
    return (2 * c + k) * h * w * b * 4, 2 * k * c * h * w * b
