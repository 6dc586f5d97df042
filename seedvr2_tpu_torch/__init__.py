"""seedvr2_tpu_torch: the PyTorch + CUDA port of seedvr2_tpu for NVIDIA Hopper.

The module tree mirrors seedvr2_tpu (ops/, models/vae/, models/dit/,
pipeline/, io/). Plain tensor code is PyTorch; the Pallas kernels of the
ported paths (K1, K2, K3, K3q, K5) are hand-written CUDA (csrc/), built
with nvcc at first use and launched through ctypes. On a CPU tensor every
kernel wrapper runs its plain PyTorch version instead, which is what the
CPU tests compare against the JAX package. The package imports neither jax
nor any module of seedvr2_tpu: what it shares with the JAX package
(configuration, window plans, batch math, checkpoint key maps, the bundled
text embeddings) is its own copy.
"""

__version__ = "0.1.0"
