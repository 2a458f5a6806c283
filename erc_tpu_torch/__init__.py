"""erc_tpu_torch — the PyTorch/CUDA port of erc_tpu for NVIDIA Hopper.

Mirrors the layout of ``erc_tpu``: ``core`` (config), ``data`` (synthetic
dialogues, batching), ``ops`` (graphs, attention, norm, dense and banded
graph layers, GRU cells), ``ops/kernels`` (wrappers of the hand-written
CUDA kernels in ``csrc/``), ``models`` (COGMEN, DAG-ERC) and ``serve``.
The package imports torch, numpy and the standard library only; the JAX
package is its reference in the tests, never a dependency.

Importing the package builds nothing: the CUDA kernels are compiled with
``nvcc`` on their first launch (``ops/kernels/build.py``).
"""

__version__ = "0.1.0"
