"""pilosa_tpu_torch: the PyTorch + CUDA port of pilosa_tpu.

A second package beside ``pilosa_tpu`` (the JAX reference, which stays
as it is). Same PQL surface, storage tree, on-disk bytes and HTTP
answers for the calls ported so far; device state lives as int32
tensors, and the device work runs in hand-written CUDA kernels for
Hopper (``kernels.py``, ``csrc/``). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``. This package imports neither jax
nor anything of ``pilosa_tpu``.
"""

__version__ = "0.1.0"
