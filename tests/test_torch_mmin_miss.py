"""``mmin_miss`` ≡ a JAX reference step, and the MMIN training loop.

``MMINMissTrainer`` is held as ``test_torch_mmin_train.py`` holds the other
two (its helpers, the same sizes and tolerances): Lall = Lce + 4·Lmse +
2·Lcycle with the frozen encoder's reverse features as the target, the
outputs (logits, fusion, fusion_cycle, features), gradients, 3 steps'
losses, weights and EMA shadow (α 0.5).  The frozen encoder stays out of the
optimizer, the EMA, the state dict and the parameter count, and does not
move.

Then the loop, on the port alone at MMIN's widths (synthetic-mmin-4, batch
4, 2 steps an epoch): an epoch whose val and test results carry the EMA's
``Acc2`` (``on_eval_end`` puts it into the val row), row counts from
``sample_mask``, ``--ema=False``, ``--resume`` restoring the shadow,
``model.best_val.ckpt`` giving a fresh trainer's logits bit for bit, a
port ``mmin_base`` file as ``--pretrain_path``, the serving engine's refusal
and the entry points' refusal without CUDA.
"""

import numpy as np
import pytest
import torch

from erc_tpu.models import mmin_models as jm
from erc_tpu_torch import convert
from erc_tpu_torch.data.mmin import MMINBatcher, synthetic_mmin
from erc_tpu_torch.models import mmin_base, mmin_miss, mmin_miss2
from erc_tpu_torch.serve import InferenceEngine
from erc_tpu_torch.train import trainer as ttrainer
from test_torch_mmin_train import assert_trajectory, batches, draw_params, jax_reference, port_trainer
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)


def test_mmin_miss_three_steps_match_jax():
    host = batches(has_miss=True, seed=2)
    pre = jm.MMINBaseModule(n_classes=4)
    pre_params = draw_params(pre, host[0], 4)
    trainer = port_trainer(mmin_miss, "--ema_alpha=0.5")
    trainer.pretrained_model.load_state_dict(convert.mmin_base_state(pre_params))
    frozen = {k: v.clone() for k, v in trainer.pretrained_model.state_dict().items()}
    assert sum(t.numel() for t in trainer.model.parameters()) == sum(
        t.numel() for t in trainer.ema_model.parameters())
    assert not any(k.startswith("pretrained") for k in trainer.state_tree()["model"])
    owned = {id(t) for g in trainer.optimizer.param_groups for t in g["params"]}
    assert not owned & {id(t) for t in trainer.pretrained_model.parameters()}

    ref = jax_reference("mmin_miss", host, pretrained=(pre, pre_params), alpha=0.5)
    assert_trajectory(trainer, convert.mmin_miss_state, host, ref, lambda m, b: m(b))
    assert all(torch.equal(v, frozen[k]) for k, v in trainer.pretrained_model.state_dict().items())
    assert not trainer.pretrained_model.training


# ------------------------------------------------------------------ the loop
LOOP = ["--dataset=synthetic-mmin-4", "--device=cpu", "--epoch=1", "--batch_count=2", "--train.batch_size=4",
        "--confusion_matrix=false"]


def _trainer(cls, params_cls, *extra):
    p = params_cls()
    p.finalize([*LOOP, *extra])
    trainer = cls(p)
    trainer.log = lambda msg: None
    return trainer


def test_epoch_val_and_test_rows_carry_acc2(tmp_path):
    """``on_eval_end`` puts Acc2 into the val row; the test result has it too;
    the record counts the rows with ``sample_mask`` > 0."""
    trainer = _trainer(mmin_base.MMINBaseTrainer, mmin_base.MMINBaseParams, "--select_on=val",
                       f"--save_dir={tmp_path}")
    ends = []
    hook = trainer.on_eval_end
    trainer.on_eval_end = lambda res: (ends.append(dict(res)), hook(res))
    (rec,) = trainer.train()
    assert rec["steps"] == 2 and rec["dialogues"] == 8
    for res in (rec["val"], rec["test"]):
        assert 0.0 <= res["Acc2"] <= 1.0 and np.isfinite(res["Lall"]) and np.isfinite(res["f1"])
    assert len(ends) == 1 and "Acc2" not in ends[0] and "Acc2" in rec["val"]
    # a batch of 3 utterances padded to 5 rows counts 3
    assert ttrainer._rows(MMINBatcher(pad_batch_to=5)(synthetic_mmin(4, "test", n_test=3))) == 3

    fresh = _trainer(mmin_base.MMINBaseTrainer, mmin_base.MMINBaseParams, f"--save_dir={tmp_path}")
    fresh.initialize()
    fresh.load_state_tree(fresh.saver.load(str(tmp_path / "model.best_val.ckpt")))
    batch = {k: torch.from_numpy(v) for k, v in next(iter(trainer.make_loader("test"))).items()}
    trainer.model.eval()
    fresh.model.eval()
    with torch.no_grad():
        for got, want in zip(fresh.to_logits(batch), trainer.to_logits(batch), strict=True):
            assert torch.equal(got, want)


def test_ema_off():
    trainer = _trainer(mmin_base.MMINBaseTrainer, mmin_base.MMINBaseParams, "--ema=False")
    (rec,) = trainer.train()
    assert trainer.ema_model is None and "ema" not in trainer.state_tree()
    assert "Acc2" not in rec["test"] and "Acc2" not in rec["val"]


def test_resume_restores_the_ema_shadow(tmp_path):
    args = ("--checkpoint_per_epoch=1", f"--save_dir={tmp_path}")
    first = _trainer(mmin_miss2.MMINMiss2Trainer, mmin_miss2.MMINMiss2Params, *args)
    first.train()
    assert "ema" in first.saver.load(first.saver.list_checkpoints()[-1])
    shadow = [t.clone() for t in first.ema_model.parameters()]
    assert not all(torch.equal(a, b) for a, b in zip(shadow, first.model.parameters()))
    second = _trainer(mmin_miss2.MMINMiss2Trainer, mmin_miss2.MMINMiss2Params, *args, "--epoch=2", "--resume")
    second.initialize()
    assert second.resume() is not None and second.eidx == 1 and second.global_steps == 2
    assert all(torch.equal(a, b) for a, b in zip(second.ema_model.parameters(), shadow))


def test_pretrain_path_from_a_port_mmin_base_file(tmp_path):
    base = mmin_base.main([*LOOP, f"--save_dir={tmp_path}"])
    path = str(tmp_path / "model.last.ckpt")
    want = base.model.state_dict()
    miss = _trainer(mmin_miss.MMINMissTrainer, mmin_miss.MMINMissParams, f"--pretrain_path={path}")
    miss.initialize()
    assert all(torch.equal(v, want[k]) for k, v in miss.pretrained_model.state_dict().items())
    miss2 = _trainer(mmin_miss2.MMINMiss2Trainer, mmin_miss2.MMINMiss2Params, f"--pretrain_path={path}")
    miss2.initialize()
    assert all(torch.equal(v, want[k]) for k, v in miss2.ema_model.netB.state_dict().items())


def test_no_serving_path_and_entry_points_need_cuda(monkeypatch):
    for module in ("mmin_base", "mmin_miss", "mmin_miss2", "dgcnv2_daily"):
        with pytest.raises(ValueError, match="has no serving path"):
            InferenceEngine.from_module(module, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (mmin_base, mmin_miss, mmin_miss2):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(["--dataset=synthetic-mmin-4"])
