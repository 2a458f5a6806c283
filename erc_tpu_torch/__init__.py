"""erc_tpu_torch — the PyTorch/CUDA port of erc_tpu for NVIDIA Hopper.

Mirrors the layout of ``erc_tpu``: ``core`` (config), ``data`` (synthetic
dialogues, the IEMOCAP-COGMEN, MELD-MMGCN, MOSEI and DailyDialog readers,
MMIN's utterances and reader, batching), ``ops`` (graphs, attention, norm,
dense and banded graph layers, GCNII, recurrent layers), ``ops/kernels`` (wrappers of the hand-written CUDA
kernels in ``csrc/``), ``models`` (COGMEN and its MOSEI alias
``cogmen_mosei``, DAG-ERC, DialogueGCN, MMGCN, DialogueGCN v2 and its
DailyDialog token track, CIM, and the MMIN family ``mmin_base``,
``mmin_miss``, ``mmin_miss2``, which trains only), ``train`` (the train loop with its val and
test stages, the metrics and checkpoints), ``parallel`` (data-parallel
training over processes, one a card, on ``torch.distributed``) and ``serve``.
The package imports torch, numpy and the standard library only; the JAX
package is its reference in the tests, never a dependency.

Importing the package builds nothing: the CUDA kernels are compiled with
``nvcc`` on their first launch (``ops/kernels/build.py``).
"""

__version__ = "0.1.0"
