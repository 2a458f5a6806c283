"""Training: the loop (``trainer``), optimizers and gradient clipping
(``optim``), evaluation metrics (``metrics``) and the entry point
``python -m erc_tpu_torch.train --module=<name> ...`` (``__main__``).

Port of ``erc_tpu.train``'s core; see ``trainer.Trainer`` for what is left
out.  Nothing here builds or launches a kernel at import.
"""
