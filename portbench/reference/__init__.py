"""The plain reference the benchmark judges the port's outputs by: plain
PyTorch copies of the detector's stages and of the flow net's training
step, importing nothing of the port and nothing of JAX."""
