"""Device selection for the port's entry points.

``MMBaseParams.device`` picks the device: an int or ``"cuda[:N]"`` means the
card, ``"cpu"`` the CPU.  Asking for the card where CUDA is absent raises;
an entry point never carries on on the CPU unless the caller said so.

Under a process group (``parallel.mesh``) each rank takes the card of
``rank_card``, and the group its backend from ``pick_backend``.
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


def rank_card(spec: DeviceSpec, local_rank: int) -> DeviceSpec:
    """The device of one rank of a process group: ``spec`` where it names a
    device other than the default card 0 (``"cpu"``, ``"cuda:N"``, an int
    N > 0), else (0, None, or ``"cuda"`` with no index) the card of the
    rank's local rank, as one process a card wants.  So ``--device=cuda:0``
    puts every rank on card 0, and the default gives rank r of a host card r."""
    if isinstance(spec, bool):
        return spec  # resolve_device refuses it
    if spec is None or spec == 0 or (isinstance(spec, (str, torch.device)) and torch.device(spec) ==
                                     torch.device("cuda")):
        return int(local_rank)
    return spec


def place_of(dev: torch.device, host: str) -> str:
    """Where a rank runs, as ``pick_backend`` compares places: ``cpu``, or the
    host and the card's index."""
    return "cpu" if dev.type == "cpu" else f"{host}/cuda:{dev.index}"


def pick_backend(places) -> str:
    """The process group's backend for ranks at ``places`` (``place_of``, one
    a rank): NCCL where every rank has a card of its own; gloo where a rank
    runs on the CPU, or where two ranks share a card (NCCL refuses two ranks
    on one device)."""
    places = list(places)
    if any(p == "cpu" for p in places) or len(set(places)) < len(places):
        return "gloo"
    return "nccl"
