"""Bytes and operations of one launch of the windowed gather
(``csrc/gather.cu`` ``window_gather_kernel``) from its call shapes.

Frozen from ``chip_smoke.py`` ``check_gather_kernel`` at fc97bde: the
source, both index images and the output, 4 bytes a pixel each, once;
12 operations a pixel (bounds, window and address).
"""

import re

NAME = "gather"
TARGET = "moving_object_detector_tpu_torch.ops.gather_cuda:window_gather"
DEVICE_NAME = re.compile(r"window_gather_kernel")


def bytes_ops(src, *args, **kwargs):
    n = src.shape[0] * src.shape[1]
    return 16 * n, 12 * n
