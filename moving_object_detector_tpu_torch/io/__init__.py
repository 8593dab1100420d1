"""Host-side I/O: sequence readers, the planar-scene renderer with its
analytic ground truth (``scenes``), the frame ring, visualization exports,
the live dashboard and the streaming runner (the JAX package's ``io/``)."""

from .readers import (
    ImageSequence,
    NpzSequence,
    SyntheticStereoSequence,
    read_image,
    read_pgm,
    read_png,
)

__all__ = [
    "ImageSequence",
    "NpzSequence",
    "SyntheticStereoSequence",
    "read_image",
    "read_pgm",
    "read_png",
]
