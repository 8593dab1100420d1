"""Compute ops: geometry, resize, SGM, flow layers, clustering, and the
CUDA kernel wrappers."""


def resolve_backend(backend: str, device) -> str:
    """The port's "auto" policy: the CUDA kernel ("pallas", the JAX
    package's name for the kernel form) for CUDA tensors, the plain
    PyTorch form ("xla") for CPU tensors. A kernel wrapper given a CPU
    tensor runs its plain version, so "pallas" is safe on the CPU too."""
    if backend == "auto":
        return "pallas" if getattr(device, "type", device) == "cuda" else "xla"
    return backend
