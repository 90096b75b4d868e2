"""dnnpde_tpu_torch: the PyTorch/CUDA port of dnnpde_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (``dnnpde_tpu/X/y.py`` has its
counterpart at ``dnnpde_tpu_torch/X/y.py``) and imports neither JAX nor the
JAX package. Entry points run on the first CUDA card unless the caller passes
``device="cpu"``. The CUDA kernels under ``csrc/`` are compiled with ``nvcc``
the first time a wrapper launches one (``ops/_build.py``).
"""

from dnnpde_tpu_torch.runtime import default_device

__all__ = ["default_device"]
