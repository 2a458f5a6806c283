"""Training: the loop (``trainer``), its callbacks (``callbacks``) and
profiler (``profiler``), optimizers and gradient clipping (``optim``),
evaluation metrics (``metrics``), checkpoints (``checkpoint``) and the entry
point ``python -m erc_tpu_torch.train --module=<name> ...`` (``__main__``).

Port of ``erc_tpu.train``; see ``trainer.Trainer`` for what is left out.
Nothing here builds or launches a kernel at import.
"""
