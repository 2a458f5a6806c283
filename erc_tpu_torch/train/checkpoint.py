"""Checkpoints: the port's Saver, and a reader of the JAX package's files.

``Saver`` ports ``erc_tpu.train.checkpoint.Saver`` onto torch state dicts,
with the same three tiers and the trainer's writers of each:
  - ``checkpoint.<N>.ckpt``   rotating, pruned to ``max_keep``, the one of
                              the best epoch so far copied to
                              ``best.checkpoint.ckpt`` (``--checkpoint_per_epoch``;
                              ``--resume`` reads them);
  - ``model.<tag>.ckpt``      overwrite-style saves (``main``'s ``model.last``;
                              the test stage's ``model.best``, also copied to
                              ``best.model.ckpt``);
  - ``key.<N>.ckpt``          permanent keypoints (``--keypoint_per_epoch``);
each with a ``.json`` meta sidecar.  A tree is a dict of state dicts and
plain values (``Trainer.state_tree``), written with ``torch.save`` to a
temporary file and renamed, meta first, so a preempted write never leaves
a truncated ``.ckpt``.

``load_flax_msgpack`` reads a file that the JAX package's Saver wrote: flax
serialises its tree with msgpack, arrays as an extension type.  It decodes
that msgpack subset in plain Python (``unpackb``), since neither flax nor
``msgpack`` is a dependency of the port.  Arrays come back in the dtype
that numpy names for flax's dtype string; flax's chunked form of arrays
over 1 GiB is not read, since no ported model has such an array.  ``load_model_state`` gives the
module's torch state dict from a file of either Saver, or from a bare
state dict (``python -m erc_tpu_torch.convert``'s output).
``read_train_state`` gives a trainer's state tree (``model``, ``optimizer``,
and MMIN's ``ema``) from a file of either Saver, for ``--pretrain``: a
JAX TrainState's params, model state and EMA go through ``convert.STATES``,
and its optax state becomes the torch optimizer's: the LR and count of
``inject_hyperparams`` (a declared schedule's count), Adam's ``count``,
``mu`` and ``nu`` (``step``, ``exp_avg``, ``exp_avg_sq``), and a ``trace``
(the ``trace`` of ``Lars`` and ``Sgd``), each moment tree converted as the
parameters are.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class Saver:
    def __init__(self, save_dir: str, max_keep: int = 3, write: bool = True):
        # write=False (every process but 0, once several train one model):
        # each save_* returns the path that process 0 writes and writes nothing
        self.save_dir = save_dir
        self.max_keep = max_keep
        self.write = write
        os.makedirs(save_dir, exist_ok=True)

    # -- low level ------------------------------------------------------------
    def _write(self, path: str, tree: Any, meta: Optional[Dict] = None) -> str:
        if not self.write:
            return path
        # meta lands first: a .ckpt without meta loads with defaults, but meta
        # without its .ckpt is never read
        if meta is not None:
            tmp_meta = path + ".json.tmp"
            with open(tmp_meta, "w") as f:
                json.dump(meta, f, indent=2, default=str)
            os.replace(tmp_meta, path + ".json")
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        return path

    def load(self, path: str, map_location="cpu") -> Any:
        """The tree saved at `path` (tensors on `map_location`)."""
        return torch.load(path, map_location=map_location, weights_only=True)

    # -- tiers ----------------------------------------------------------------
    def save_checkpoint(self, step: int, tree: Any, meta: Optional[Dict] = None, is_best: bool = False) -> str:
        path = self._write(os.path.join(self.save_dir, f"checkpoint.{step:08d}.ckpt"), tree, meta)
        if self.write:
            if is_best:
                shutil.copy(path, os.path.join(self.save_dir, "best.checkpoint.ckpt"))
            self._prune()
        return path

    def save_model(self, tag: str, tree: Any, meta: Optional[Dict] = None, is_best: bool = False) -> str:
        path = self._write(os.path.join(self.save_dir, f"model.{tag}.ckpt"), tree, meta)
        if is_best and self.write:
            shutil.copy(path, os.path.join(self.save_dir, "best.model.ckpt"))
        return path

    def save_keypoint(self, step: int, tree: Any, meta: Optional[Dict] = None) -> str:
        return self._write(os.path.join(self.save_dir, f"key.{step:08d}.ckpt"), tree, meta)

    def _prune(self) -> None:
        cps = self.list_checkpoints()
        while len(cps) > self.max_keep:
            victim = cps.pop(0)
            for p in (victim, victim + ".json"):
                if os.path.exists(p):
                    os.remove(p)

    def list_checkpoints(self) -> List[str]:
        """The rotating checkpoints, oldest first."""
        return sorted(
            os.path.join(self.save_dir, f)
            for f in os.listdir(self.save_dir)
            if f.startswith("checkpoint.") and f.endswith(".ckpt")
        )

    def latest_checkpoint(self) -> Optional[str]:
        cps = self.list_checkpoints()
        return cps[-1] if cps else None


# ------------------------------------------------------------------ msgpack
# flax's extension types (flax.serialization._MsgpackExtType)
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack of (shape, dtype name, C-order bytes)."""
    shape, dtype, buf = unpackb(payload)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack extension type {code}: only flax's ndarray and numpy scalar types are read")


def _decode(buf: bytes, pos: int):
    """(value, next position) of the msgpack object at `pos`."""
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b <= 0x8F:
        return _decode_map(buf, pos, b & 0x0F)
    if b <= 0x9F:
        return _decode_array(buf, pos, b & 0x0F)
    if b <= 0xBF:
        n = b & 0x1F
        return buf[pos : pos + n].decode("utf-8"), pos + n
    if b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], pos
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)

    def length(width):
        return struct.unpack_from(_LEN[width], buf, pos)[0], pos + width

    if b in _BIN:
        n, pos = length(_BIN[b])
        return bytes(buf[pos : pos + n]), pos + n
    if b in _STR:
        n, pos = length(_STR[b])
        return buf[pos : pos + n].decode("utf-8"), pos + n
    if b in _ARRAY:
        n, pos = length(_ARRAY[b])
        return _decode_array(buf, pos, n)
    if b in _MAP:
        n, pos = length(_MAP[b])
        return _decode_map(buf, pos, n)
    if b in _EXT or b in _FIXEXT:
        if b in _EXT:
            n, pos = length(_EXT[b])
        else:
            n = _FIXEXT[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        pos += 1
        return _ext(code, bytes(buf[pos : pos + n])), pos + n
    raise ValueError(f"byte 0x{b:02x} at {pos - 1} starts no msgpack object")


def _decode_array(buf: bytes, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _decode(buf, pos)
        out.append(v)
    return out, pos


def _decode_map(buf: bytes, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _decode(buf, pos)
        out[k], pos = _decode(buf, pos)
    return out, pos


def unpackb(data: bytes):
    """Decode one msgpack object: maps, arrays, str/bin, ints, floats,
    nil/bool and flax's ndarray and numpy scalar extension types.
    Arrays come back as lists and str as Python strings, as
    ``msgpack.unpackb(data, raw=False)`` gives them."""
    value, pos = _decode(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the msgpack object")
    return value


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """The flax variables in a file of the JAX package's Saver, as nested
    numpy dicts: ``{'params': ..., 'batch_stats': ...}``.  A full TrainState
    (params, opt_state, model_state, step) yields its params and its model
    state, as ``Saver.load_params`` unpacks it; a variables dict passes
    through; a bare params tree becomes ``{'params': tree}``."""
    with open(path, "rb") as f:
        raw = unpackb(f.read())
    if isinstance(raw, dict) and {"params", "opt_state", "step"} <= set(raw):
        return {"params": raw["params"], **(raw.get("model_state") or {})}
    if isinstance(raw, dict) and "params" in raw:
        return raw
    return {"params": raw}


def load_model_state(path: str, module: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The torch state dict of `module` ("cogmen", "dagerc", "dgcn", "mmgcn", "dgcnv2",
    "dgcnv2_daily", "cim", "cogmen_mosei", "mmin_base", "mmin_miss",
    "mmin_miss2") from `path`: a
    file of the port's Saver (its ``model`` entry), a bare state dict, or a
    file of the JAX package's Saver (its ``params``, converted by
    ``convert.STATES``): the model weights alone, as the JAX Saver's
    ``load_params`` extracts them for MMIN's ``--pretrain_path``."""
    if zipfile.is_zipfile(path):  # torch.save's format
        state = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and {"model", "step"} <= set(state):
            return state["model"]
        return state
    from erc_tpu_torch import convert

    if module not in convert.STATES:
        raise ValueError(f"{path} is a flax file: name the module to convert it to, one of {sorted(convert.STATES)}")
    return convert.STATES[module](load_flax_msgpack(path))


def _find(tree, keys) -> list:
    """Every dict in ``tree`` (nested dicts and lists) that holds all of ``keys``, depth first."""
    found = []
    if isinstance(tree, dict):
        if set(keys) <= set(tree):
            found.append(tree)
        for v in tree.values():
            found += _find(v, keys)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            found += _find(v, keys)
    return found


def _flax_optimizer_state(opt_state, to_state, model_state, optimizer, named) -> Dict[str, Any]:
    """The torch ``optimizer``'s state dict from an optax state tree (see the
    module's note); ``named`` the model's (name, parameter) pairs."""
    def convert(tree):
        return to_state({"params": tree, **model_state})

    sd = optimizer.state_dict()
    names = {id(p): n for n, p in named}
    index = {names[id(p)]: i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    inject = _find(opt_state, ("count", "hyperparams"))
    if inject:
        lr = float(np.asarray(inject[0]["hyperparams"]["learning_rate"]))
        for g in sd["param_groups"]:
            g["lr"] = lr
        if "schedule" in optimizer.state:
            sd["state"]["schedule"] = {"count": torch.tensor(int(np.asarray(inject[0]["count"])))}
    adam = _find(opt_state, ("count", "mu", "nu"))
    if adam:
        mu, nu = convert(adam[0]["mu"]), convert(adam[0]["nu"])
        step = float(np.asarray(adam[0]["count"]))
        for n, i in index.items():
            sd["state"][i] = {"step": torch.tensor(step), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    trace = _find(opt_state, ("trace",))
    if trace:
        tr = convert(trace[0]["trace"])
        for n, i in index.items():
            sd["state"][i] = {"trace": tr[n]}
    return sd


def read_train_state(path: str, trainer) -> Dict[str, Any]:
    """A trainer's state tree from ``path``: a file of the port's Saver as
    it is, or a JAX package file (a TrainState, or bare variables) converted
    with the trainer's ``flax_module``."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    from erc_tpu_torch import convert

    with open(path, "rb") as f:
        raw = unpackb(f.read())
    if trainer.flax_module not in convert.STATES:
        raise ValueError(f"{path} is a flax file, and {type(trainer).__name__} names no converter for it")
    to_state = convert.STATES[trainer.flax_module]
    if not (isinstance(raw, dict) and {"params", "opt_state", "step"} <= set(raw)):
        return {"model": to_state(raw if isinstance(raw, dict) and "params" in raw else {"params": raw})}
    model_state = raw.get("model_state") or {}
    tree = {"model": to_state({"params": raw["params"], **model_state}),
            "optimizer": _flax_optimizer_state(raw["opt_state"], to_state, model_state, trainer.optimizer,
                                               list(trainer.model.named_parameters()))}
    if raw.get("ema_params") is not None:
        tree["ema"] = to_state({"params": raw["ema_params"], **model_state})
    return tree
