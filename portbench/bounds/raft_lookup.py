"""Bytes and operations of one launch of RAFT's correlation lookup
(``csrc/raft_lookup.cu`` ``raft_lookup_kernel``) from its call shapes.

Frozen from ``chip_smoke.py`` ``check_raft_lookup``: the (B, 2, h, w) f32
coordinates read once, the (B, L (2r+1)^2, h, w) f32 features written
once, and of each pyramid level only what the samples need, the
(2r+2) x (2r+2) patch of f32 values around each pixel's match (the
pyramid itself, 286 MB at the KITTI grid, is not read whole); four
multiply-adds a sample.

A checkout of the program older than the kernel has no module
``raft_lookup_cuda``: there a placeholder module of that name stands in,
with a function that raises, so that the benchmark's recorder can wrap it
and the cells that never look up run as before.
"""

import importlib.util
import re
import sys
import types

NAME = "raft_lookup"
TARGET = "moving_object_detector_tpu_torch.ops.raft_lookup_cuda:raft_lookup"
DEVICE_NAME = re.compile(r"raft_lookup_kernel")


def _placeholder():
    mod_name = TARGET.split(":")[0]
    if mod_name in sys.modules or importlib.util.find_spec(
            mod_name.rsplit(".", 1)[0]) is None:
        return
    if importlib.util.find_spec(mod_name) is None:
        mod = types.ModuleType(mod_name)

        def raft_lookup(*args, **kwargs):
            raise RuntimeError("this checkout of the program has no RAFT "
                               "lookup kernel")

        mod.raft_lookup = raft_lookup
        sys.modules[mod_name] = mod


_placeholder()


def bytes_ops(pyramid, coords, radius=4, *args, **kwargs):
    b, _, h, w = coords.shape
    n = b * h * w
    k = 2 * radius + 1
    levels = len(pyramid)
    nbytes = 4 * (2 * n + n * levels * k * k + n * levels * (k + 1) ** 2)
    return nbytes, 8 * n * levels * k * k
