"""The benchmark's plain reference: the path tracer in plain PyTorch ops,
imports nothing of the program, and the count arithmetic of the
kernels' roofline."""
