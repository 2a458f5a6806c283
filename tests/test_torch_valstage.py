"""The port's val stage (``Trainer.evaluate``), ``--select_on`` and
``plateau_source`` ≡ the JAX trainer's.

On a DailyDialog tree fabricated in ``tmp_path`` (3 train dialogues, 2
val, 1 test; vocabulary 50, 6 words, L 9, hidden 8, embedding 8, batch 2),
a 2-epoch ``DGCNV2DailyTrainer`` run at dropout 0 from the same weights in
both packages (JAX at matmul precision highest): each epoch's val ``Lall``,
``f1`` and ``acc`` and the test results within 1e-5, and ``--select_on=val``
saves ``best_val`` after the same epochs.  Then, on the port alone: the
fallback to ``select_on=test`` where the dataset has no val split, the
plateau controller stepped on the val loss with ``plateau_source = "val"``,
and a checkpoint written before the best val F1 was kept still resumes.
"""

import numpy as np
import pytest
import torch

import jax

from erc_tpu.models import dgcnv2 as jdgcnv2
from erc_tpu.parallel.mesh import make_mesh
from erc_tpu.train import trainer as jtrainer
from erc_tpu_torch import convert
from erc_tpu_torch.models import cogmen as tcogmen
from erc_tpu_torch.models import dgcnv2 as tdgcnv2
from erc_tpu_torch.ops.dropout import Dropout
from erc_tpu_torch.train import trainer as ttrainer
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
DAILY_FILES = {
    "train": (["Hi there . __eou__ Hello ! __eou__", "How are you ? __eou__ Fine , thanks . __eou__ Good __eou__",
               "Hello again __eou__ hi hi there __eou__"], ["0 4", "0 4 4", "6 0"]),
    "validation": (["Hello there you __eou__", "A B __eou__ C are you __eou__"], ["3", "5 2"]),
    "test": (["there you are __eou__ Hi __eou__ What ? __eou__"], ["1 2 0"]),
}
ARGS = ["--dataset=dailydialog-token-7", "--vocab_size=50", "--n_words=6", "--embedding_dim=8", "--max_seq_len=9",
        "--hidden_size=8", "--train.batch_size=2", "--test.batch_size=2", "--confusion_matrix=false", "--seed=3"]


@pytest.fixture
def daily_root(tmp_path):
    for split, (text, emo) in DAILY_FILES.items():
        d = tmp_path / "data" / split
        d.mkdir(parents=True)
        (d / f"dialogues_{split}.txt").write_text("\n".join(text) + "\n", encoding="utf-8")
        (d / f"dialogues_emotion_{split}.txt").write_text("\n".join(emo) + "\n", encoding="utf-8")
    return tmp_path / "data"


def _port_daily(root, save_dir, *extra, cls=tdgcnv2.DGCNV2DailyTrainer):
    """A port DGCNV2DailyTrainer on the fabricated tree at dropout 0; its log
    lines are kept in ``trainer.lines``."""
    p = tdgcnv2.DGCNV2DailyParams()
    p.finalize([*ARGS, f"--data_root={root}", f"--save_dir={save_dir}", "--device=cpu", *extra])
    trainer = cls(p)
    trainer.lines = []
    trainer.log = trainer.lines.append
    trainer.initialize()
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return trainer


class _JAXDaily(jdgcnv2.DGCNV2DailyTrainer):
    def imodels(self, params):
        super().imodels(params)
        self.model = self.model.clone(dropout_rec=0.0, drop_rate=0.0, cnn_dropout=0.0)


def _recording(trainer, name, calls):
    """Wrap ``trainer.<name>`` to append (epoch, result) to ``calls``."""
    fn = getattr(trainer, name)

    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        calls.append((trainer.eidx, a[0] if name == "save_model" else res))
        return res

    setattr(trainer, name, wrapped)


def test_val_stage_and_select_on_val_match_jax(daily_root, tmp_path, monkeypatch):
    monkeypatch.setenv("ERC_TPU_EXPROOT", str(tmp_path / "exp"))
    # one device, as the port has: the JAX batches then pad to the same 2 rows
    monkeypatch.setattr(jtrainer.meshlib, "make_mesh", lambda: make_mesh(devices=jax.devices()[:1]))
    prec = jax.config.jax_default_matmul_precision
    jp = jdgcnv2.DGCNV2DailyParams()
    jp.from_args([*ARGS, f"--data_root={daily_root}", "--epoch=2", "--select_on=val", "--matmul_precision=highest",
                  "--heartbeat=false"])
    jp.iparams()
    try:
        jtr = _JAXDaily(jp)
        jtr.initialize()
        params = jax.tree_util.tree_map(np.asarray, jtr.state.params)
        jcalls = {"evaluate": [], "test": [], "save_model": []}
        for name, calls in jcalls.items():
            _recording(jtr, name, calls)
        jtr.train()
    finally:
        jax.config.update("jax_default_matmul_precision", prec)

    ttr = _port_daily(daily_root, tmp_path / "port", "--epoch=2", "--select_on=val", "--checkpoint_per_epoch=1")
    ttr.model.load_state_dict(convert.dgcnv2_state(params))
    tcalls = {"save_model": []}
    _recording(ttr, "save_model", tcalls["save_model"])
    history = ttr.train()

    assert [r["epoch"] for r in history] == [0, 1] and [e for e, _ in jcalls["evaluate"]] == [0, 1]
    for rec, (_, jval), (_, jtest) in zip(history, jcalls["evaluate"], jcalls["test"]):
        assert rec["val"].keys() == {"Lall", "acc", "f1", "wa"} and jval.keys() == rec["val"].keys()
        for key in ("Lall", "f1", "acc", "wa"):
            np.testing.assert_allclose(rec["val"][key], float(jval[key]), rtol=0, atol=TOL, err_msg=f"val {key}")
        for key in ("Lall", "acc", "f1", "wa", "pre", "rec", "mif1", "maf1"):
            np.testing.assert_allclose(rec["test"][key], float(jtest[key]), rtol=0, atol=TOL, err_msg=f"test {key}")
        np.testing.assert_allclose(rec["test"]["cls_f1"], np.asarray(jtest["cls_f1"]), rtol=0, atol=TOL)
    assert any(line.startswith("val: Lall=") for line in ttr.lines)
    # --select_on=val: best_val after the same epochs, and test() marks no best model
    want = [e for e, tag in jcalls["save_model"] if tag == "best_val"]
    assert want and tcalls["save_model"] == [(e, "best_val") for e in want]
    assert not [tag for _, tag in jcalls["save_model"] if tag == "best"]
    val_f1 = [r["val"]["f1"] for r in history]
    assert ttr.best_val_f1 == max(val_f1)
    # the rotating checkpoint's best copy is the last epoch with the best val F1 so far
    best = torch.load(tmp_path / "port" / "best.checkpoint.ckpt", weights_only=True)
    assert best["step"] == 2 * (want[-1] + 1) and best["best_val_f1"] == max(val_f1)
    served = torch.load(tmp_path / "port" / "model.best_val.ckpt", weights_only=True)
    assert served["eidx"] == want[-1] and served["best_val_f1"] == max(val_f1)


def test_select_on_val_falls_back_where_there_is_no_val_split(tmp_path):
    """synthetic-cogmen-6 aliases val to test: the fallback is logged, no val
    stage runs, and the best rotating checkpoint follows test F1."""
    p = tcogmen.COGMENParams()
    p.finalize(["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--max_seq_len=16", "--device=cpu", "--epoch=1",
                "--batch_count=1", "--train.batch_size=4", "--test.batch_size=32", "--select_on=val",
                "--checkpoint_per_epoch=1", "--confusion_matrix=false", f"--save_dir={tmp_path}"])
    trainer = tcogmen.COGMENTrainer(p)
    lines = []
    trainer.log = lines.append
    trainer.evaluate = lambda: pytest.fail("the val stage ran on a dataset without a val split")
    (record,) = trainer.train()
    assert any("--select_on=val but dataset 'synthetic-cogmen-6' has no real val split" in line for line in lines)
    assert p.select_on == "test" and "val" not in record and "f1" in record["test"]
    assert (tmp_path / "best.checkpoint.ckpt").exists() and not (tmp_path / "model.best_val.ckpt").exists()
    assert trainer.best_val_f1 == float("-inf") and trainer.best_f1 == record["test"]["f1"]


class _ValPlateau(tdgcnv2.DGCNV2DailyTrainer):
    plateau_source = "val"

    def imodels(self, params):
        super().imodels(params)
        self.lr_sche = torch.optim.lr_scheduler.ReduceLROnPlateau(self.optimizer, mode="min", factor=0.5,
                                                                  patience=0)


@pytest.mark.parametrize("source", ["val", "test"])
def test_plateau_source_picks_the_loss_that_steps_the_controller(daily_root, tmp_path, source, monkeypatch):
    assert ttrainer.Trainer.plateau_source == jtrainer.Trainer.plateau_source == "test"
    cls = _ValPlateau if source == "val" else type("_TestPlateau", (_ValPlateau,), {"plateau_source": "test"})
    trainer = _port_daily(daily_root, tmp_path, "--epoch=1", cls=cls)
    stepped = []
    # on the class: the test stage's best model pickles the scheduler's state, which an instance attribute joins
    plateau = type(trainer.lr_sche)
    step = plateau.step
    monkeypatch.setattr(plateau, "step", lambda self, loss: (stepped.append(loss), step(self, loss)))
    history = trainer.train()
    assert stepped == [r[source]["Lall"] for r in history]


def test_a_checkpoint_without_the_best_val_f1_still_resumes(daily_root, tmp_path):
    """Checkpoints written before the val stage hold no ``best_val_f1``: they
    resume with none, so the next val stage saves ``best_val``; a new
    checkpoint carries it, and ``--resume`` restores it."""
    first = _port_daily(daily_root, tmp_path, "--epoch=1", "--checkpoint_per_epoch=1", "--select_on=val")
    (record,) = first.train()
    path = tmp_path / "checkpoint.00000002.ckpt"
    tree = torch.load(path, weights_only=True)
    assert tree["best_val_f1"] == record["val"]["f1"] == first.best_val_f1
    tree.pop("best_val_f1")
    torch.save(tree, path)
    old = _port_daily(daily_root, tmp_path, "--epoch=2", "--resume", "--checkpoint_per_epoch=1", "--select_on=val")
    (record,) = old.train()
    assert record["epoch"] == 1 and old.global_steps == 4
    assert any(line.startswith(f"resumed from {path}") for line in old.lines)
    assert old.best_val_f1 == record["val"]["f1"]  # the first val stage after the resume is the best so far
    new = _port_daily(daily_root, tmp_path, "--epoch=3", "--select_on=val")
    assert new.resume() == str(tmp_path / "checkpoint.00000004.ckpt")
    assert (new.eidx, new.best_val_f1) == (2, old.best_val_f1)
