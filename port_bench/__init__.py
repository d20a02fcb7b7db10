"""The benchmark of the PyTorch and CUDA port (``dyglib_tpu_torch``) on one H100."""
