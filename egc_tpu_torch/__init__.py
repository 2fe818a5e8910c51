"""egc_tpu_torch: the PyTorch/CUDA port of egc_tpu for NVIDIA Hopper.

The module tree mirrors ``egc_tpu``; each module names its JAX counterpart.
Plain tensor code is PyTorch. The TPU kernels on the port's path
(``egc_tpu/ops/pallas/``) are CUDA C++ kernels under ``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use (``ops/cuda/_build.py``).

Dispatch follows the tensor's device: a CPU tensor runs the kernel's plain
PyTorch version, a CUDA tensor launches the kernel or raises. Entry points
run on the card unless the caller passes ``device="cpu"``.

Importing this package imports neither ``jax`` nor ``egc_tpu``, and imports
no submodule: it stays light.
"""

__version__ = "0.1.0"
