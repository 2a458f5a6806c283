"""``python -m erc_tpu_torch.preprocess acoustic|text|video``: see ``entry.py``."""

from erc_tpu_torch.preprocess.entry import main

if __name__ == "__main__":
    main()
