"""The port's baseline sweep generator: seeds × modality subsets × datasets,
written as shell lines that train the port (``python -m erc_tpu_torch.train``).

The counterpart of ``scripts/baseline.py``, with its flags, defaults, order
and sharding (``--shard=i/n`` keeps every n-th line from the i-th), on
``erc_tpu_torch.core.params``: it imports nothing of JAX or ``erc_tpu``.

    python scripts/torch_baseline.py | bash
    python scripts/torch_baseline.py --module=cogmen --seeds=3 --modality=1000000 --shard=0/2 | bash
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from erc_tpu_torch.core.params import BaseParams  # noqa: E402

ALL_MODALITY = ["atv", "av", "at", "tv", "a", "t", "v"]
DEFAULT_DATASETS = [
    "iemocap-cogmen-sbert-4",
    "iemocap-cogmen-sbert-6",
    "meld-mmgcn-sbert-7",
]


def main():
    p = BaseParams()
    p.module = "cogmen"
    p.modality = "1111111"  # bitmask over ALL_MODALITY
    p.seeds = 3
    p.script = "-m erc_tpu_torch.train"
    p.datasets = ",".join(DEFAULT_DATASETS)
    p.shard = "0/1"
    p.finalize()

    mask = str(p.modality).ljust(len(ALL_MODALITY), "0")
    modalities = [m for i, m in enumerate(ALL_MODALITY) if mask[i] == "1"]
    datasets = str(p.datasets).split(",")
    shard_i, shard_n = (int(x) for x in str(p.shard).split("/"))

    cmds = [f"python3 {p.script} --module={p.module} --dataset={dataset} --reimplement --modality={modality} "
            f"--seed={seed}"
            for seed in range(int(p.seeds)) for modality in modalities for dataset in datasets]
    cmds = [c for i, c in enumerate(cmds) if i % shard_n == shard_i]
    print(f'echo "execute {len(cmds)} runs."')
    for c in cmds:
        print(c)


if __name__ == "__main__":
    main()
