"""Per-run experiment directories + provenance (reference: lumo/exp/experiment.py).

Port of ``erc_tpu.core.experiment``, in the same layout:
    <exproot>/experiment/<exp_name>/<test_name>/   — metadata (params, info, metrics)
    <exproot>/blob/<exp_name>/<test_name>/         — large files (checkpoints, boards)

``test_name`` is ``YYMMDD.HHMMSS.<hash>``.  The port's trainers name their
experiment ``erc_tpu_torch.<TrainerClass>``, so that the two packages' runs
never share a directory under one root.  ``record_start`` names torch, its
CUDA and cuDNN versions and numpy, and, on the card, the card's name and
power limit as ``nvidia-smi`` gives them.  The heartbeat thread writes files
only: no CUDA call leaves the main thread.  Under a process group every rank
holds an ``Experiment`` of the test name that rank 0 made, and only rank 0's
(``write=True``) writes its files; the others make its directories and write
nothing.
"""

from __future__ import annotations

import functools
import getpass
import json
import os
import subprocess
import sys
import time
from typing import Optional


def exproot() -> str:
    from erc_tpu_torch.core.machine import cfg_get

    return cfg_get("exproot", env="ERC_TPU_EXPROOT", default=os.path.expanduser("~/.erc_tpu"))


class Experiment:
    def __init__(self, exp_name: str, test_name: Optional[str] = None, root: Optional[str] = None,
                 write: bool = True):
        self.exp_name = exp_name
        self.write = write
        self.root = root or exproot()
        if test_name is None:
            test_name = self.make_test_name()
        self.test_name = test_name
        os.makedirs(self.test_dir, exist_ok=True)
        os.makedirs(self.blob_dir, exist_ok=True)

    @staticmethod
    def make_test_name() -> str:
        stamp = time.strftime("%y%m%d.%H%M%S")
        salt = hex(abs(hash((os.getpid(), time.time_ns()))) % 16**4)[2:].zfill(4)
        return f"{stamp}.{salt}t"


    @property
    def test_dir(self) -> str:
        return os.path.join(self.root, "experiment", self.exp_name, self.test_name)

    @property
    def blob_dir(self) -> str:
        return os.path.join(self.root, "blob", self.exp_name, self.test_name)

    def test_file(self, name: str, *subdirs: str) -> str:
        d = os.path.join(self.test_dir, *subdirs)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def blob_file(self, name: str, *subdirs: str) -> str:
        d = os.path.join(self.blob_dir, *subdirs)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    # -- provenance (reference: exphook.py LastCmd/GitCommit/LockFile) --------
    def dump_info(self, key: str, value) -> None:
        if not self.write:
            return
        path = self.test_file(f"{key}.json")
        with open(path, "w") as f:
            json.dump(value, f, indent=2, default=str)

    def load_info(self, key: str):
        path = os.path.join(self.test_dir, f"{key}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def record_start(self, device=None) -> None:
        """Write ``initial.json`` (command, user, git head, versions and,
        where ``device`` is a CUDA device, the card), ``rerun.sh`` and a line
        in the day's diary."""
        if not self.write:
            return
        info = {
            "argv": sys.argv,
            "exec": sys.executable,
            "cwd": os.getcwd(),
            "user": getpass.getuser(),
            "start": time.strftime("%Y-%m-%d %H:%M:%S"),
            "git": self._git_hash(),
            "versions": self._versions(),
        }
        if device is not None and getattr(device, "type", None) == "cuda":
            info["card"] = card_line()
        # working-tree snapshot: uncommitted edits become a commit on the
        # snapshot branch so the run is reproducible (reference
        # exphook.py:107-171 GitCommit; disable: ERC_TPU_GIT_SNAPSHOT=0)
        from erc_tpu_torch.core.machine import git_snapshot, snapshot_enabled

        if snapshot_enabled():
            snap = git_snapshot(message=f"run {self.exp_name}/{self.test_name}")
            if snap:
                info["git_snapshot"] = snap
        self.dump_info("initial", info)
        # rerun script (reference: exphook.py:33-50)
        with open(self.test_file("rerun.sh"), "w") as f:
            f.write("#!/bin/bash\n" + " ".join([sys.executable] + sys.argv) + "\n")
        # daily diary index (reference: exphook.py Diary :59-63)
        diary_dir = os.path.join(self.root, "diary")
        os.makedirs(diary_dir, exist_ok=True)
        with open(os.path.join(diary_dir, time.strftime("%y%m%d") + ".log"), "a") as f:
            f.write(f"{time.strftime('%H:%M:%S')} {self.exp_name}/{self.test_name}\n")

    def record_end(self, ok: bool = True, error: Optional[str] = None) -> None:
        self.dump_info(
            "final", {"end": time.strftime("%Y-%m-%d %H:%M:%S"), "finished": ok, "error": error}
        )

    @staticmethod
    def _git_hash() -> Optional[str]:
        try:
            return (
                subprocess.run(
                    ["git", "rev-parse", "HEAD"], capture_output=True, timeout=5, text=True
                ).stdout.strip()
                or None
            )
        except Exception:
            return None

    @staticmethod
    def _versions() -> dict:
        import numpy
        import torch

        return {"python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
                "cudnn": torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None,
                "numpy": numpy.__version__}

    def start_heartbeat(self, interval: float = 2.0) -> "Heartbeat":
        """Liveness beacon (reference: exphook.py TimeMonitor → exp/agent.py
        detached process appending a heartbeat json + .hb every 2 s).  A
        daemon thread gives the same signal without process management."""
        hb = Heartbeat(self.test_dir, interval)
        hb.start()
        return hb

    @classmethod
    def find_tests(cls, exp_name: str, root: Optional[str] = None) -> list:
        d = os.path.join(root or exproot(), "experiment", exp_name)
        if not os.path.isdir(d):
            return []
        return sorted(os.listdir(d))


@functools.lru_cache(maxsize=1)
def card_line() -> Optional[str]:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (its first line), or None where it fails;
    read once a process."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, timeout=10, text=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


class Heartbeat:
    """Daemon thread writing `<test_dir>/.hb` + heartbeat.json periodically."""

    def __init__(self, test_dir: str, interval: float = 2.0):
        self.test_dir = test_dir
        self.interval = interval
        self._stop = False
        self._thread = None

    def start(self):
        import threading

        def loop():
            import json as _json

            path = os.path.join(self.test_dir, "heartbeat.json")
            flag = os.path.join(self.test_dir, ".hb")
            while not self._stop:
                stamp = {"pid": os.getpid(), "time": time.time()}
                try:
                    with open(path, "w") as f:
                        _json.dump(stamp, f)
                    with open(flag, "w") as f:
                        f.write(str(stamp["time"]))
                except OSError:
                    pass
                time.sleep(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop = True
