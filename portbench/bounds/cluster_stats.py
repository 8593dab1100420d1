"""Bytes and operations of one launch of the cluster statistics
(``csrc/cluster_stats.cu`` ``stats_kernel``) from its call shapes.

Frozen from ``chip_smoke.py`` ``check_stats_kernel`` at fc97bde: the
labels (4 bytes), the points (12) and the compact ids written (4) of every
pixel, once; 16 operations a pixel.
"""

import re

NAME = "cluster_stats"
TARGET = "moving_object_detector_tpu_torch.ops.cluster_stats_cuda:cluster_stats"
DEVICE_NAME = re.compile(r"stats_kernel")


def bytes_ops(labels, *args, **kwargs):
    n = labels.shape[0] * labels.shape[1]
    return 20 * n, 16 * n
