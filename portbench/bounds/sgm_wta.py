"""Bytes and operations of one launch of the SGM winner-take-all
(``csrc/sgm_v2.cu`` ``wta_kernel``) from its call shapes.

Frozen from ``chip_smoke.py`` ``check_sgm_kernels`` at fc97bde: four int8
delta volumes (D bytes a pixel each) and two census images read once,
the f32 disparity written once; 8 operations a candidate (4 adds, the
cost, a pack, 2 min for the left and the right view) over every pixel and
disparity of both views. The v1 WTA (``csrc/sgm_v1.cu``, int16 totals)
has the same kernel name; the pattern takes v2's int8 signature.
"""

import re

NAME = "sgm_wta"
TARGET = "moving_object_detector_tpu_torch.ops.sgm_cuda:wta"
DEVICE_NAME = re.compile(r"wta_kernel(<[^>]*>)?\(signed char|wta_kernelILb[01]EEvPKa")
D = 128
OPS_PER_WTA_CANDIDATE = 8


def bytes_ops(hf, *args, **kwargs):
    n = hf.shape[0] * hf.shape[1]
    return 4 * n * D + 2 * n * 4 + n * 4, 2 * n * D * OPS_PER_WTA_CANDIDATE
