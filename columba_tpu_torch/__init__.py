"""columba_tpu_torch: the PyTorch + CUDA port of columba_tpu.

Lossless approximate read mapping with search schemes on a bidirectional
FM-index, for one NVIDIA Hopper GPU. The package mirrors ``columba_tpu``
module by module; device state is PyTorch tensors, and the hot device
stages are hand-written CUDA kernels (``csrc/``) with plain PyTorch
versions beside them, which the CPU runs. It imports neither JAX nor
``columba_tpu``.
"""

__version__ = "0.1.0"
