"""The port's checkpoints (erc_tpu_torch.train.checkpoint) ≡ the JAX package's.

- ``Saver``: the same call sequence on the port's and the JAX package's
  Saver leaves the same files (three tiers, pruning to ``max_keep``,
  ``best.*`` copies, ``.json`` meta); a failed write leaves the previous
  file whole (temporary file and rename, meta first); a saved tree loads
  back equal.
- The trainer's writers of the tiers (COGMEN and DAG-ERC on the CPU, at
  dropout 0.5): ``--checkpoint_per_epoch`` and ``--keypoint_per_epoch``
  leave their files (and the test stage its best model, ``model.best.ckpt``
  and ``best.model.ckpt``, as the JAX trainer's test stage does), the best
  epoch's checkpoint is ``best.checkpoint.ckpt``,
  and a run of one epoch resumed (``--resume``, past a torn newer file) for
  a second ends with the parameters of an uninterrupted two-epoch run,
  bit for bit.
- ``unpackb``, the port's msgpack decoder, gives what ``msgpack.unpackb``
  gives on random trees (every type and width the format has), and what
  ``flax.serialization.msgpack_restore`` gives on arrays of several dtypes
  and numpy scalars.
- A COGMEN TrainState saved by the JAX package's ``Saver.save_model``
  (hidden 16, both encoder modes) is read by ``load_flax_msgpack``,
  converted by ``convert.cogmen_state`` and served by ``InferenceEngine``
  on the CPU: logits within 1e-5 of the flax module's (float32, JAX at
  matmul precision highest; the encoder's sums run in another order).
"""

import json
import os
import random

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.models.cogmen import COGMENModule as JCOGMEN
from erc_tpu.train import checkpoint as jcheckpoint
from erc_tpu.train import optim as joptim
from erc_tpu.train.trainer import TrainState
from erc_tpu_torch.serve import InferenceEngine
from erc_tpu_torch.train import checkpoint as tcheckpoint
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)


# ------------------------------------------------------------------ Saver
def _drive(saver, tree):
    """One call sequence over the three tiers; returns the paths returned."""
    paths = [saver.save_checkpoint(step, tree, {"step": step}, is_best=(step == 20)) for step in (10, 20, 30, 40, 50)]
    paths.append(saver.save_model("last", tree, {"eidx": 1}))
    paths.append(saver.save_model("last", tree, {"eidx": 2}))
    paths.append(saver.save_keypoint(7, tree))
    return paths


def test_tiers_pruning_and_best_copies_match_jax(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    js, ts = jcheckpoint.Saver(str(jdir), max_keep=3), tcheckpoint.Saver(str(tdir), max_keep=3)
    jpaths = _drive(js, {"w": np.arange(4, dtype=np.float32)})
    tpaths = _drive(ts, {"model": {"w": torch.arange(4.0)}, "step": 1})
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == sorted(
        [f"checkpoint.000000{n}0.ckpt{m}" for n in (3, 4, 5) for m in ("", ".json")]
        + ["best.checkpoint.ckpt", "model.last.ckpt", "model.last.ckpt.json", "key.00000007.ckpt"])
    for name in os.listdir(tdir):
        if name.endswith(".json"):
            assert (tdir / name).read_text() == (jdir / name).read_text()
    assert [os.path.basename(p) for p in ts.list_checkpoints()] == [os.path.basename(p) for p in js.list_checkpoints()]
    # the best copy is the step-20 save, whose rotating file was pruned
    assert torch.equal(ts.load(str(tdir / "best.checkpoint.ckpt"))["model"]["w"], torch.arange(4.0))


def test_failed_write_leaves_the_previous_file_whole(tmp_path, monkeypatch):
    saver = tcheckpoint.Saver(str(tmp_path))
    path = saver.save_model("last", {"model": {"w": torch.zeros(3)}, "step": 1}, {"eidx": 0})

    def broken(obj, f):
        with open(f, "wb") as out:
            out.write(b"PK\x03\x04 truncated")
        raise OSError("disk full")

    monkeypatch.setattr(tcheckpoint.torch, "save", broken)
    with pytest.raises(OSError):
        saver.save_model("last", {"model": {"w": torch.ones(3)}, "step": 2}, {"eidx": 1})
    monkeypatch.undo()
    assert saver.load(path)["step"] == 1  # still the first save
    assert '"eidx": 1' in open(path + ".json").read()  # meta lands first, as in the JAX Saver
    assert not any(n.endswith(".ckpt") and n != "model.last.ckpt" for n in os.listdir(tmp_path))


# ------------------------------------------------------------------ the trainer's tiers
TRAINERS = {
    "cogmen": ["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--graph_impl=banded", "--max_seq_len=32"],
    "dagerc": ["--dataset=synthetic-iemocap-6", "--hidden_dim=16", "--gnn_layers=2", "--dag_chunk=4",
               "--dag_impl=kernel"],
}


def _run(module, save_dir, *extra):
    """A trainer of `module` on the CPU (4 dialogues a step, 2 steps an
    epoch, the test stage every epoch), trained."""
    from erc_tpu_torch.models import cogmen, dagerc

    mod = {"cogmen": cogmen, "dagerc": dagerc}[module]
    p = getattr(mod, f"{module.upper()}Params")()
    p.finalize([*TRAINERS[module], "--device=cpu", "--seed=5", "--batch_count=2", "--train.batch_size=4",
                "--test.batch_size=16", "--confusion_matrix=false", f"--save_dir={save_dir}", *extra])
    trainer = getattr(mod, f"{module.upper()}Trainer")(p)
    trainer.log = lambda msg: None
    return trainer, trainer.train()


@pytest.mark.parametrize("module", sorted(TRAINERS))
def test_trainer_writes_the_tiers_and_resumes(tmp_path, module):
    full, history = _run(module, tmp_path / "full", "--epoch=2", "--checkpoint_per_epoch=1", "--keypoint_per_epoch=1")
    assert sorted(os.listdir(tmp_path / "full")) == sorted(
        [f"{t}.0000000{n}.ckpt{m}" for t in ("checkpoint", "key") for n in (2, 4) for m in ("", ".json")]
        + ["best.checkpoint.ckpt", "model.best.ckpt", "model.best.ckpt.json", "best.model.ckpt"])
    f1 = [r["test"]["f1"] for r in history]
    best = torch.load(tmp_path / "full" / "best.checkpoint.ckpt", weights_only=True)
    assert best["step"] == (4 if f1[1] >= f1[0] else 2) and best["best_f1"] == max(f1)
    meta = json.loads((tmp_path / "full" / "checkpoint.00000004.ckpt.json").read_text())
    assert meta == {"eidx": 1, "global_steps": 4, "epoch_end": True, "params_hash": full.params.resume_hash()}

    part, _ = _run(module, tmp_path / "part", "--epoch=1", "--checkpoint_per_epoch=1")
    (tmp_path / "part" / "checkpoint.00000099.ckpt").write_bytes(b"PK\x03\x04 torn")
    resumed, history = _run(module, tmp_path / "part", "--epoch=2", "--resume")
    assert [r["epoch"] for r in history] == [1] and resumed.global_steps == 4
    assert (resumed.best_f1, part.eidx) == (full.best_f1, 0)
    for (name, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    fresh, history = _run(module, tmp_path / "empty", "--epoch=1", "--resume")  # nothing to resume from
    assert [r["epoch"] for r in history] == [0] and fresh.global_steps == 2


# ------------------------------------------------------------------ msgpack
def _random_tree(r, depth=0):
    kind = r.randrange(10 if depth < 3 else 7)
    if kind == 0:
        return r.choice([0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                         -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63])
    if kind == 1:
        return r.choice([None, True, False])
    if kind == 2:
        return r.uniform(-1e30, 1e30)
    if kind == 3:
        return "".join(chr(r.randrange(32, 0x3000)) for _ in range(r.choice([0, 5, 31, 32, 300, 70000])))
    if kind == 4:
        return bytes(r.randrange(256) for _ in range(r.choice([0, 3, 255, 256, 70000])))
    if kind == 5:
        return r.randrange(-2**40, 2**40)
    if kind == 6:
        return r.uniform(-1, 1)
    if kind in (7, 8):
        return [_random_tree(r, depth + 1) for _ in range(r.choice([0, 3, 15, 16, 20]))]
    return {f"k{i}": _random_tree(r, depth + 1) for i in range(r.choice([0, 2, 15, 16, 17]))}


@pytest.mark.parametrize("seed", range(5))
def test_decoder_agrees_with_msgpack(seed):
    r = random.Random(seed)
    tree = {f"t{i}": _random_tree(r) for i in range(8)}
    data = msgpack.packb(tree, use_bin_type=True)
    assert tcheckpoint.unpackb(data) == msgpack.unpackb(data, raw=False)
    data32 = msgpack.packb([1.5, -2.25], use_single_float=True)
    assert tcheckpoint.unpackb(data32) == msgpack.unpackb(data32)


def test_decoder_reads_flax_arrays_and_scalars():
    r = np.random.default_rng(0)
    tree = {
        "f32": r.normal(size=(3, 4)).astype(np.float32),
        "f16": r.normal(size=(5,)).astype(np.float16),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "u8": np.arange(7, dtype=np.uint8),
        "b": np.array([True, False]),
        "zero_d": np.asarray(3, np.int32),
        "scalar": np.float32(2.5),
        "empty": np.zeros((0, 3), np.float32),
        "nested": {"list": [1, "x", 2.0], "none": None},
    }
    data = serialization.msgpack_serialize(tree)
    got = tcheckpoint.unpackb(data)
    want = serialization.msgpack_restore(data)
    assert got.keys() == want.keys()
    for k in tree:
        if isinstance(want[k], dict):
            assert got[k] == want[k]
        else:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------ JAX checkpoint → the port
KW = dict(input_size=712, hidden_size=16, num_head=17, n_speakers=2, n_classes=6, wp=5, wf=5, drop_rate=0.5)


@pytest.mark.parametrize("mode", ["reference", "chained"])
def test_jax_checkpoint_serves_through_the_port(tmp_path, mode):
    model = JCOGMEN(graph_impl="dense", encoder_mode=mode, **KW)
    engine_kw = dict(dataset="synthetic-cogmen-6", batch_size=3, hidden_size=16, encoder_mode=mode,
                     graph_impl="banded", device="cpu")
    probe = InferenceEngine.from_module("cogmen", **engine_kw)
    batch = probe.batcher(j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=3, min_len=5, max_len=20, seed=4))
    variables = model.init(jax.random.PRNGKey(2), batch, deterministic=True)
    rng = np.random.default_rng(5)
    stats = {"gcn": {"bn": {"mean": rng.normal(0, 0.3, 16).astype(np.float32),
                            "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}}}
    tx = joptim.build_optim(joptim.create_optim("Adam", lr=1e-4, weight_decay=1e-8))
    state = TrainState(params=variables["params"], opt_state=tx.init(variables["params"]),
                       model_state={"batch_stats": stats}, step=jnp.asarray(3))
    path = jcheckpoint.Saver(str(tmp_path)).save_model("last", state, meta={"eidx": 1})

    trees = tcheckpoint.load_flax_msgpack(path)
    assert set(trees) == {"params", "batch_stats"}
    for a, b in zip(jax.tree_util.tree_leaves(trees), jax.tree_util.tree_leaves({**variables, "batch_stats": stats})):
        np.testing.assert_array_equal(a, np.asarray(b))
    engine = InferenceEngine.from_module("cogmen", path, **engine_kw)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(model.apply({"params": variables["params"], "batch_stats": stats}, batch,
                                      deterministic=True))
    np.testing.assert_allclose(engine.logits(batch), want, rtol=0, atol=1e-5)

    # a bare params tree (the JAX Saver's load_params input) reads as {'params': tree}
    bare = tmp_path / "params.msgpack"
    bare.write_bytes(serialization.to_bytes(variables["params"]))
    got = tcheckpoint.load_flax_msgpack(str(bare))
    assert set(got) == {"params"}
    with pytest.raises(ValueError, match="name the module"):
        tcheckpoint.load_model_state(path)
