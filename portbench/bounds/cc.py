"""Bytes and operations of one call of connected components
(``csrc/cc.cu``: ``cc_local_kernel``, ``cc_border_kernel`` and
``cc_flatten_kernel``, three launches) from its call shapes.

Frozen from ``chip_smoke.py`` ``check_cc_kernel`` at fc97bde: the dynamic
mask (1 byte), the depth (4) and the labels (4) of every pixel, once;
6 operations (2 loads, a subtraction, an absolute value, 2 compares) an
edge test, 24 forward offsets for each dynamic pixel with a finite
depth. Counting those pixels would need a read of the device in the
traced part; every pixel is counted instead, which changes nothing:
144 operations at 67 TFLOP/s take less time than 9 bytes at 3.35 TB/s,
so the bound is the bytes' whatever the share of dynamic pixels.
"""

import re

NAME = "cc"
TARGET = ("moving_object_detector_tpu_torch.ops.clustering_cuda:"
          "connected_components")
DEVICE_NAME = re.compile(r"cc_(local|border|flatten)_kernel")
OPS_PER_EDGE_TEST = 6


def bytes_ops(dynamic, *args, **kwargs):
    n = dynamic.shape[0] * dynamic.shape[1]
    return 9 * n, OPS_PER_EDGE_TEST * 24 * n
