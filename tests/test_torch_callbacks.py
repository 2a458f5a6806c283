"""The port's callbacks, case for case with ``tests/test_callbacks.py``.

A tiny COGMEN (``graph_impl=dense``, hidden 16, L 16, batch 8, 2 steps an
epoch) on ``synthetic-cogmen-6`` on the CPU, each test under its own
experiment root:

- the ``.stop`` file (polled, and a run that stops after its first step);
- epoch checkpoints and auto-resume of the counters and weights; a
  truncated newest checkpoint passed over, a torn meta sidecar tolerated;
- the NaN guard (a checkpoint before the raise; end to end, a parameter set
  to NaN mid-run raises at the next check, with ``epoch_end: false``);
- ``EvalFirst`` with ``FinalReport``; keypoints that survive
  the rotation; a resumed run that trains only the epochs left;
- a relaunched run (a fresh test directory) resuming from a sibling run with
  the same ``resume_hash``, ignoring one with another, and passing over a
  corrupt newest sibling or an own saver that is all corrupt;
- ``GlobalStepCheckpoint`` at ``--steps_per_call=2`` (thresholds, not
  multiples), and a mid-epoch checkpoint that re-runs its epoch on resume
  where an epoch-end one continues at the next;
- ``KeyErrorSave`` on an interrupt; the exporters (a TensorBoard event file
  that ``analyse.load_tb_events`` reads back; ``RemoteCallback`` against a
  stub server on 127.0.0.1);
- every callback on against off: the same losses, parameters and test
  result, bit for bit.
"""

import glob
import http.server
import json
import os
import threading

import numpy as np
import pytest
import torch

from erc_tpu_torch import analyse
from erc_tpu_torch.models.cogmen import COGMENParams, COGMENTrainer
from erc_tpu_torch.train import callbacks as cbs
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

ARGS = ["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--graph_impl=dense", "--max_seq_len=16",
        "--train.batch_size=8", "--test.batch_size=8", "--epoch=1", "--batch_count=2", "--eval_per_epoch=0",
        "--confusion_matrix=false", "--device=cpu", "--heartbeat=false"]


@pytest.fixture
def make(tmp_path, monkeypatch):
    """A COGMEN trainer under `tmp_path`'s experiment root, flags over ARGS."""
    monkeypatch.setenv("ERC_TPU_EXPROOT", str(tmp_path))

    def _make(*extra):
        p = COGMENParams()
        p.finalize([*ARGS, *extra])
        tr = COGMENTrainer(p)
        tr.log = lambda msg: None
        return tr

    return _make


def _train_epochs_run(tr):
    """Epochs the trainer trained (its board's train rows)."""
    return sum(1 for r in map(json.loads, open(tr.exp.test_file("board.jsonl"))) if r["stage"] == "train")


def _meta(path):
    return json.loads(open(path + ".json").read())


def test_stop_by_code(make):
    tr = make()
    tr.initialize()
    cb = cbs.StopByCode(check_every=1).hook(tr)
    open(os.path.join(tr.exp.test_dir, ".stop"), "w").close()
    tr.global_steps = 1
    cb.train_step_end(tr, 0, {})
    assert tr.stopped
    # end to end: the file is found after the first step, and the run ends there
    run = make("--epoch=2")
    cbs.StopByCode(check_every=1).hook(run)
    open(os.path.join(run.exp.test_dir, ".stop"), "w").close()
    history = run.train()
    assert run.global_steps == 1 and [r["steps"] for r in history] == [1]
    assert run.exp.load_info("final")["finished"] is True


def test_epoch_checkpoint_and_auto_resume(make):
    tr = make("--checkpoint_per_epoch=1")
    tr.train()
    cps = tr.saver.list_checkpoints()
    assert len(cps) >= 1 and _meta(cps[-1]) == {"eidx": 0, "global_steps": 2, "epoch_end": True,
                                                 "params_hash": tr.params.resume_hash()}
    tr2 = make("--resume=true")
    tr2.exp, tr2.saver = tr.exp, tr.saver
    tr2.initialize()
    cbs.AutoResume().train_begin(tr2)
    # an epoch-end checkpoint resumes at eidx + 1; the step counter continues
    assert (tr2.eidx, tr2.global_steps) == (tr.eidx + 1, tr.global_steps)
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        assert torch.equal(a, b)


def test_auto_resume_survives_truncated_latest_checkpoint(make):
    tr = make("--checkpoint_per_epoch=1", "--epoch=2")
    tr.train()
    cps = tr.saver.list_checkpoints()
    assert len(cps) >= 2
    assert not [f for f in os.listdir(tr.saver.save_dir) if f.endswith(".tmp")]
    with open(cps[-1], "r+b") as f:  # truncate the newest mid-"write"
        f.truncate(37)
    tr2 = make("--resume=true", "--epoch=2")
    tr2.exp, tr2.saver = tr.exp, tr.saver
    tr2.initialize()
    assert cbs.AutoResume().resume(tr2) == cps[-2]
    meta = _meta(cps[-2])
    assert (tr2.eidx, tr2.global_steps) == (meta["eidx"] + 1, meta["global_steps"])
    # a torn meta sidecar beside an intact checkpoint: the tree's own counters, the epoch run again
    with open(cps[-2] + ".json", "w") as f:
        f.write('{"eidx": 0, "glo')
    tr3 = make("--resume=true", "--epoch=2")
    tr3.exp, tr3.saver = tr.exp, tr.saver
    tr3.initialize()
    cbs.AutoResume().train_begin(tr3)
    assert tr3.eidx == 0


def test_nan_guard(make):
    tr = make()
    tr.initialize()
    cb = cbs.NaNGuard(check_every=1).hook(tr)
    tr.global_steps = 1
    cb.train_step_end(tr, 0, {"Lall": torch.tensor(1.0)})
    tr.global_steps = 2  # threshold cadence: past the last check
    with pytest.raises(FloatingPointError):
        cb.train_step_end(tr, 0, {"Lall": torch.tensor(float("nan"))})
    assert tr.saver.latest_checkpoint() is not None


class _Poison(cbs.Callback):
    """Sets one parameter to NaN in place after the first step (before the guard looks)."""

    priority = 50

    def train_step_end(self, tr, bidx, mets):
        if tr.global_steps == 1:
            with torch.no_grad():
                next(tr.model.parameters()).fill_(float("nan"))


def test_nan_guard_end_to_end(make):
    tr = make("--batch_count=4")
    cbs.NaNGuard(check_every=1).hook(tr)
    _Poison().hook(tr)
    with pytest.raises(FloatingPointError, match="step 2"):
        tr.train()
    path = tr.saver.latest_checkpoint()
    assert path.endswith("checkpoint.00000002.ckpt") and _meta(path)["epoch_end"] is False
    assert tr.exp.load_info("final")["finished"] is False


def test_eval_first_and_final_report(make):
    tr = make("--eval_first=true")
    tr.train()
    # EvalFirst ran test() before epoch 0: best metrics exist though eval_per_epoch=0
    assert tr.database.todict().get("f1") is not None
    rep = tr.exp.load_info("report")
    assert rep is not None and rep["global_steps"] == tr.global_steps and "best" in rep


def test_keypoint_checkpoint(make):
    tr = make("--keypoint_per_epoch=1")
    tr.train()
    keys = glob.glob(os.path.join(tr.saver.save_dir, "key.*.ckpt"))
    assert len(keys) == 1  # one epoch → one permanent keypoint
    for _ in range(6):
        tr.save_checkpoint()
    assert glob.glob(os.path.join(tr.saver.save_dir, "key.*.ckpt")) == keys


def test_auto_resume_continues_epochs_end_to_end(make):
    tr1 = make("--checkpoint_per_epoch=1")
    tr1.train()
    steps_per_epoch = tr1.global_steps
    ck1 = tr1.saver.latest_checkpoint()
    tr2 = make("--checkpoint_per_epoch=1", "--resume=true", "--epoch=3")
    tr2.exp, tr2.saver = tr1.exp, tr1.saver
    history = tr2.train()
    assert [r["epoch"] for r in history] == [1, 2]
    assert tr2.global_steps == 3 * steps_per_epoch and tr2.eidx == 2
    latest = tr2.saver.latest_checkpoint()
    assert latest != ck1 and latest > ck1  # zero-padded names sort by step


def test_auto_resume_finds_sibling_run(make):
    tr1 = make("--checkpoint_per_epoch=1")
    tr1.train()
    steps_per_epoch = tr1.global_steps
    # a relaunch: a NEW test dir, the same config but for run-control knobs
    tr2 = make("--checkpoint_per_epoch=1", "--resume=true", "--epoch=3")
    assert tr2.exp.test_name != tr1.exp.test_name and tr2.saver.latest_checkpoint() is None
    tr2.train()
    assert tr2.global_steps == 3 * steps_per_epoch and tr2.eidx == 2
    assert _train_epochs_run(tr2) == 2
    # a sibling with another config is not resumed across
    tr3 = make("--checkpoint_per_epoch=1", "--resume=true", "--epoch=1")
    tr3.params.optim.lr = 0.0123
    tr3.train()
    assert _train_epochs_run(tr3) == 1 and tr3.global_steps == steps_per_epoch
    # a corrupt newest sibling checkpoint: the next-oldest intact one
    newest = max(tr1.saver.list_checkpoints() + tr2.saver.list_checkpoints(), key=os.path.getmtime)
    with open(newest, "r+b") as f:
        f.truncate(29)
    tr4 = make("--checkpoint_per_epoch=1", "--resume=true", "--epoch=3")
    tr4.initialize()
    cbs.AutoResume().train_begin(tr4)
    assert 0 < tr4.global_steps < 3 * steps_per_epoch
    # an own saver that is all corrupt still reaches an intact sibling
    for cp in tr1.saver.list_checkpoints():
        with open(cp, "r+b") as f:
            f.truncate(17)
    tr5 = make("--checkpoint_per_epoch=1", "--resume=true", "--epoch=3")
    tr5.exp, tr5.saver = tr1.exp, tr1.saver
    tr5.initialize()
    cbs.AutoResume().train_begin(tr5)
    assert tr5.global_steps > 0


def test_global_step_checkpoint_at_k_steps_a_call(make):
    tr = make("--steps_per_call=2", "--batch_count=4", "--epoch=2", "--checkpoint_per_step=3")
    tr.train()
    # global_steps runs 2, 4, 6, 8: the threshold of 3 is crossed at 4 and at 8 (4 + 3 <= 8)
    cps = tr.saver.list_checkpoints()
    assert [os.path.basename(c) for c in cps] == ["checkpoint.00000004.ckpt", "checkpoint.00000008.ckpt"]
    assert [(_meta(c)["eidx"], _meta(c)["epoch_end"]) for c in cps] == [(0, False), (1, False)]


class _StopAt(cbs.Callback):
    """Makes the ``.stop`` file at step ``n`` (``StopByCode`` then finds it)."""

    def __init__(self, n):
        self.n = n

    def train_step_end(self, tr, bidx, mets):
        if tr.global_steps == self.n:
            open(os.path.join(tr.exp.test_dir, ".stop"), "w").close()


def test_mid_epoch_checkpoint_reruns_its_epoch(make):
    tr = make("--checkpoint_per_step=1", "--epoch=2", "--batch_count=3")
    _StopAt(4).hook(tr)  # the first step of epoch 1
    cbs.StopByCode(check_every=1).hook(tr)
    tr.train()
    assert tr.global_steps == 4
    mid = make("--resume=true", "--epoch=2", "--batch_count=3")
    mid.exp, mid.saver = tr.exp, tr.saver
    mid.initialize()
    path = cbs.AutoResume().resume(mid)
    assert path.endswith("checkpoint.00000004.ckpt") and _meta(path)["epoch_end"] is False
    assert (mid.eidx, mid.global_steps) == (1, 4)  # epoch 1 runs again
    end = make("--checkpoint_per_epoch=1", "--batch_count=3")
    end.train()
    nxt = make("--resume=true", "--epoch=2", "--batch_count=3")
    nxt.exp, nxt.saver = end.exp, end.saver
    nxt.initialize()
    cbs.AutoResume().resume(nxt)
    assert (nxt.eidx, nxt.global_steps) == (1, 3)  # the next epoch


class _Interrupt(cbs.Callback):
    def train_step_end(self, tr, bidx, mets):
        if tr.global_steps == 2:
            raise KeyboardInterrupt


def test_key_error_save(make):
    tr = make()
    tr.initialize()
    cbs.KeyErrorSave().exception(tr, KeyboardInterrupt())
    assert tr.saver.latest_checkpoint() is not None
    # end to end: an interrupt during a step leaves a checkpoint and an unfinished record
    run = make("--batch_count=3")
    _Interrupt().hook(run)
    with pytest.raises(KeyboardInterrupt):
        run.train()
    assert run.saver.latest_checkpoint().endswith("checkpoint.00000002.ckpt")
    assert run.exp.load_info("final")["finished"] is False


class _Stub(http.server.BaseHTTPRequestHandler):
    posts: list = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.posts.append(json.loads(body))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture
def stub_server():
    _Stub.posts = []
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/", _Stub.posts
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_exporters(make, stub_server):
    url, posts = stub_server
    tr = make("--tensorboard=true", f"--remote_url={url}", "--epoch=2", "--eval_per_epoch=1", "--eval_first=true")
    history = tr.train()
    events = analyse.load_tb_events(tr.exp.blob_file("", "board"))
    assert [v for _, v in events["train/Lall"]] == pytest.approx([r["Lall"] for r in history], rel=1e-6)
    assert [s for s, _ in events["test/f1"]] == [0, 0, 1]  # EvalFirst's, then each epoch's
    # one train POST an epoch, one test POST a test stage (EvalFirst's included)
    assert [(p["stage"], p["epoch"]) for p in posts] == [("test", 0), ("train", 0), ("test", 0), ("train", 1),
                                                        ("test", 1)]
    assert posts[1]["Lall"] == pytest.approx(history[0]["Lall"])


def test_callbacks_on_equal_off(make, stub_server):
    url, _ = stub_server
    off = make("--epoch=2", "--eval_per_epoch=1")
    on = make("--epoch=2", "--eval_per_epoch=1", "--eval_first=true", "--nan_guard=true", "--checkpoint_per_step=1",
              "--checkpoint_per_epoch=1", "--keypoint_per_epoch=1", "--profile_steps=1", "--tensorboard=true",
              f"--remote_url={url}", "--heartbeat=true")
    a, b = off.train(), on.train()
    for ra, rb in zip(a, b):
        for key in ("Lall", "Acc", "gnorm"):
            assert ra[key] == rb[key], key
        assert ra["test"].keys() == rb["test"].keys()
        for key, v in ra["test"].items():
            np.testing.assert_array_equal(np.asarray(rb["test"][key]), np.asarray(v), err_msg=key)
    for x, y in zip(off.model.parameters(), on.model.parameters()):
        assert torch.equal(x, y)
    assert len(on.saver.list_checkpoints()) == 3 and os.path.exists(on.exp.test_file("heartbeat.json"))
