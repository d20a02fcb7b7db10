"""The benchmark's plain reference: PyTorch and NumPy only.

It imports neither JAX, nor the JAX package, nor anything of the
PyTorch port: it works out again from the benchmark's inputs (the
stream, the starting parameters, the seeds) what the port derives
(temporal adjacency, samples, negatives, dropout masks) and computes the
networks, the loss, the gradients and Adam's update in float32 with TF32
off. ``precision.Precision("tf32")`` computes every product from TF32
operands instead: the control that the comparison has to fail.
"""
