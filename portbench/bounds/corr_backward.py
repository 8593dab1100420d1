"""Bytes and operations of one launch of the correlation backward
(``csrc/corr_bwd.cu`` ``corr_bwd_kernel``) from its call shapes.

Frozen from ``chip_smoke.py`` ``corr_grad_bytes_ops`` at fc97bde: f1, f2
and the output gradient read once, both input gradients written once; a
multiply-add for each offset, channel and pixel, for both gradients.
"""

import re

NAME = "corr_backward"
TARGET = "moving_object_detector_tpu_torch.ops.flow_corr_cuda:corr_backward"
DEVICE_NAME = re.compile(r"corr_bwd_kernel")


def bytes_ops(f1, f2, g, search_range=4, *args, **kwargs):
    b, c, h, w = f1.shape
    k = (2 * search_range + 1) ** 2
    return (4 * b * c * h * w + k * b * h * w) * 4, 2 * 2 * k * b * c * h * w
