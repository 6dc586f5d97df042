"""seedvr2_tpu_torch: the PyTorch + CUDA port of seedvr2_tpu for NVIDIA Hopper.

The module tree mirrors seedvr2_tpu (ops/, models/vae/, models/dit/,
pipeline/, io/). Plain tensor code is PyTorch; the three Pallas kernels of
the main upscale path are hand-written CUDA (csrc/), built with nvcc at
first use and launched through ctypes. On a CPU tensor every kernel wrapper
runs its plain PyTorch version instead, which is what the CPU tests compare
against the JAX package. The package never imports jax.
"""

__version__ = "0.1.0"
