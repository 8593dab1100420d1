"""Host-side I/O: sequence readers, the frame ring, visualization exports
and the streaming runner (the JAX package's ``io/``). The interactive
scenes and the live dashboard are not ported yet (ROADMAP.md Queue 1)."""

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
