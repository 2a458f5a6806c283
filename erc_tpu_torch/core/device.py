"""Device selection for the port's entry points.

``MMBaseParams.device`` picks the device: an int or ``"cuda[:N]"`` means the
card, ``"cpu"`` the CPU.  Asking for the card where CUDA is absent raises;
an entry point never carries on on the CPU unless the caller said so.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceSpec = Union[int, str, torch.device, None]


def resolve_device(spec: DeviceSpec) -> torch.device:
    if spec is None:
        dev = torch.device("cuda")
    elif isinstance(spec, torch.device):
        dev = spec
    elif isinstance(spec, bool):
        raise TypeError(f"device must be an int, a string or a torch.device, not {spec!r}")
    elif isinstance(spec, int):
        dev = torch.device("cuda", spec)
    elif isinstance(spec, str):
        dev = torch.device(spec)
    else:
        raise TypeError(f"device must be an int, a string or a torch.device, not {spec!r}")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda[:N]' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
