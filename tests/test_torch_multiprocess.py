"""The port's data-parallel training over real processes, on the CPU (gloo).

``scripts/torch_mp_worker.py`` runs as 1, 2 and 4 OS processes federated
over a localhost coordinator (the trainer's ``--coordinator``,
``--num_processes``, ``--process_id``), case for case against
``tests/test_multiprocess.py`` and at its tolerances (losses within rtol
2e-5 and atol 2e-6 of the single run, ranks within rtol 1e-6 of each other):

- DAG-ERC (``scripts/mp_worker.py``'s settings, dropout 0) at 2 and 4 ranks
  against 1: the shared test name, the strided label slices reassembling
  the global batch, each step's loss, ``test()``'s F1 identical across
  ranks and within 1e-6 of the single run; the federated preemption and
  resume (a 2-rank run of 2 epochs with epoch checkpoints, relaunched with
  ``--resume`` into a fresh test directory: both ranks restore epoch 2 and
  continue the 1-process run's trajectory);
- a last global batch of one dialogue, which leaves the other ranks padding
  rows only, gives the single run's loss at 2 and 4 ranks;
- above dropout 0 the ranks draw masks of their own (rank 0 the single
  run's), also after restoring rank 0's state as a resume does;
- only rank 0 writes the run's files;
- 2 ranks against the JAX package itself: the JAX trainer on one device at
  matmul precision highest and dropout 0, its initial weights converted
  through ``convert.py`` (an ``.npz`` of its variables), on the same global
  batches, for COGMEN (its batch norm over the global batch: the running
  statistics equal across ranks and within tolerance of JAX's), DAG-ERC,
  ``mmin_miss`` (the EMA shadow within rtol 2e-5 and atol 1e-6, as
  ``tests/test_multichip_families.py`` holds JAX's across a mesh) and CIM on
  synthetic-mosei-2 (its multilabel block gathered: the same on both ranks).

In-process: the rules of ``core.device`` (the rank's card, the backend),
``MeshSpec(model > 1)`` refused, ``initialize_distributed``'s argument
checks, a trainer refusing ``--coordinator`` where no group is up, and every collective the identity without a group; a 2-rank
subprocess, started by ``ERC_TPU_DIST=auto`` from a launcher's environment,
holds ``allgather_rows`` with ragged lengths, ``allsum``,
``broadcast_one_to_all``, ``allreduce_`` and ``global_sum`` with its
backward.  The launches start together at the module's first test and run
beside the JAX trainers.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from erc_tpu.models import cim as jcim
from erc_tpu.models import cogmen as jcogmen
from erc_tpu.models import dagerc as jdagerc
from erc_tpu.models import mmin_miss as jmiss
from erc_tpu.parallel import mesh as jmesh
from erc_tpu.train import trainer as jtrainer
from erc_tpu_torch import convert
from erc_tpu_torch.core import device as tdevice
from erc_tpu_torch.parallel import mesh
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_mp_worker.py")
RTOL, ATOL = 2e-5, 2e-6  # tests/test_multiprocess.py's
EMA_ATOL = 1e-6  # tests/test_multichip_families.py's
TIMEOUT = 300

COMMON = ["--device=cpu", "--epoch=1", "--prefetch=false", "--heartbeat=false", "--eval_per_epoch=0",
          "--confusion_matrix=false"]
DAGERC = ["--dataset=synthetic-cogmen-6", "--train.batch_size=8", "--test.batch_size=8", "--max_seq_len=32",
          "--hidden_dim=16", "--gnn_layers=2", "--dropout=0.0"]
PARTIAL = [*DAGERC, "--train.batch_size=17"]  # 120 dialogues: 7 batches of 17, then one of 1
# COGMEN's batch-norm statistics are held after its first step: the biases of
# gcn.conv2's lin_key, lin_value and lin_skip have an exact gradient of 0, and
# Adam turns its rounding noise into lr-sized steps in both packages
# (tests/test_torch_pipeline.py), which moves the later steps' batch means
DUMP_STEP = {"cogmen": 1}
FAMILIES = {  # the JAX comparisons: (the family's flags, dropout switched off in both packages)
    "dagerc": (DAGERC, False),
    "cogmen": (["--dataset=synthetic-cogmen-6", "--hidden_size=16", "--max_seq_len=32", "--graph_impl=dense",
                "--train.batch_size=8", "--test.batch_size=8", "--drop_rate=0.0"], False),
    "cim": (["--dataset=synthetic-mosei-2", "--hidden_size=8", "--max_seq_len=12", "--train.batch_size=8",
             "--test.batch_size=8"], True),
    "mmin_miss": (["--dataset=synthetic-mmin-4", "--max_audio_len=16", "--train.batch_size=8",
                   "--test.batch_size=8"], True),
}
JAX = {"dagerc": (jdagerc.DAGERCParams, jdagerc.DAGERCTrainer), "cogmen": (jcogmen.COGMENParams, jcogmen.COGMENTrainer),
       "cim": (jcim.CIMParams, jcim.CIMTrainer), "mmin_miss": (jmiss.MMINMissParams, jmiss.MMINMissTrainer)}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _job(name, module, args, **kw):
    return {"name": name, "module": module, "args": [*COMMON, *args], **kw}


class _Launch:
    """``n`` ranks of the worker on ``jobs``, started at once; ``result()``
    waits for them and gives each rank's report."""

    def __init__(self, tmp, tag, n, jobs, exproot):
        self.tag, self.outs, self.procs = tag, [], []
        jobs_file = tmp / f"{tag}.jobs.json"
        jobs_file.write_text(json.dumps(jobs))
        env = {**os.environ, "ERC_TPU_EXPROOT": str(exproot), "OMP_NUM_THREADS": "1"}
        port = _free_port()
        for rank in range(n):
            out = tmp / f"{tag}.{rank}.json"
            self.outs.append(out)
            cmd = [sys.executable, WORKER, f"--coordinator=localhost:{port}", f"--num_processes={n}",
                   f"--process_id={rank}", f"--jobs={jobs_file}", f"--out={out}"]
            self.procs.append(subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT))
        self._result = None

    def result(self):
        if self._result is None:
            logs = []
            try:
                for pr in self.procs:
                    logs.append(pr.communicate(timeout=TIMEOUT)[0].decode(errors="replace"))
            finally:
                for pr in self.procs:
                    if pr.poll() is None:
                        pr.kill()
            for pr, log in zip(self.procs, logs):
                assert pr.returncode == 0, f"{self.tag}: a rank failed:\n{log[-4000:]}"
            self._result = [json.loads(o.read_text()) for o in self.outs]
        return self._result


# ------------------------------------------------------------- JAX references
class _Deterministic:
    """A flax module whose every ``apply`` is deterministic (dropout off),
    the train-only branches of the loss kept."""

    def __init__(self, module):
        self.module = module

    def apply(self, *a, **kw):
        kw["deterministic"] = True
        return self.module.apply(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.module, name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(dict(v), f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_file(tmp, module, variables):
    """The JAX variables as an .npz, converted by ``convert.py`` into a port state dict file."""
    npz, pt = tmp / f"{module}.variables.npz", tmp / f"{module}.pt"
    np.savez(npz, **_flat(jax.tree_util.tree_map(np.asarray, variables)))
    convert.main([f"--module={module}", str(npz), str(pt)])
    return str(pt)


class _JaxRun:
    """The JAX trainer of a family on one device: its initial weights as port
    files, then its losses over the first 3 global batches."""

    def __init__(self, name, tmp):
        p_cls, t_cls = JAX[name]
        args, dropout0 = FAMILIES[name]
        self.name, self.dropout0 = name, dropout0
        p = p_cls()
        p.from_args([*args, "--matmul_precision=highest", "--heartbeat=false", "--prefetch=false"])
        p.iparams()
        self.tr = t_cls(p)
        self.tr.initialize()
        if name == "cim":
            self.tr.model = self.tr.model.clone(drop0=0.0, drop1=0.0)
        st = self.tr.state
        self.init = _port_file(tmp, name, {"params": st.params, **dict(st.model_state)})
        self.extra = []
        if name == "mmin_miss":  # the frozen encoder the JAX trainer drew
            self.extra = [f"--pretrain_path={_port_file(tmp, 'mmin_base', {'params': self.tr.pretrained_params})}"]

    def steps(self, n=3):
        tr = self.tr
        if self.dropout0:
            base = type(tr).loss_and_metrics

            def loss_and_metrics(variables, batch, rng, train, _tr=tr):
                module = _tr.model
                _tr.model = _Deterministic(module)
                try:
                    return base(_tr, variables, batch, rng, train)
                finally:
                    _tr.model = module

            tr.loss_and_metrics = loss_and_metrics
        tr._build_step_fns()
        state, losses, states = tr.state, [], []
        for k, b in enumerate(list(tr.make_loader("train"))[:n]):
            state, mets = tr._train_step_fn(state, jmesh.shard_batch(b, tr.mesh), tr.rng.key("d", k))
            losses.append(float(jax.device_get(mets["Lall"])))
            states.append(jax.tree_util.tree_map(np.asarray, {"params": state.params, **dict(state.model_state),
                                                              "ema": state.ema_params}))
        return losses, states


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of the module, started together; the JAX references
    computed while they run."""
    tmp = tmp_path_factory.mktemp("mp")
    exp = tmp_path_factory.mktemp("mp_exp")
    mirror = [_job("dagerc", "dagerc", DAGERC, test=True), _job("partial", "dagerc", PARTIAL, steps=0),
              _job("dropout", "dagerc", [*DAGERC, "--dropout=0.5"], mode="draw")]
    out = {"tmp": tmp}
    for n in (1, 2, 4):
        out[n] = _Launch(tmp, f"mirror{n}", n, mirror, exp / f"mirror{n}")
    resume = [*DAGERC, "--checkpoint_per_epoch=1"]
    out["ctl"] = _Launch(tmp, "ctl", 1, [_job("run", "dagerc", [*resume, "--epoch=3"], mode="train")], exp / "ctl")
    out["phase_a"] = _Launch(tmp, "a", 2, [_job("run", "dagerc", [*resume, "--epoch=2"], mode="train")],
                             exp / "shared")
    prec = jax.config.jax_default_matmul_precision
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ERC_TPU_EXPROOT", str(exp / "jax"))
            make_mesh = jmesh.make_mesh
            mp.setattr(jtrainer.meshlib, "make_mesh", lambda *a, **k: make_mesh(devices=jax.devices()[:1]))
            refs = {name: _JaxRun(name, tmp) for name in FAMILIES}
            jobs = [_job(name, name, [*FAMILIES[name][0], *ref.extra], init=ref.init, dropout0=ref.dropout0,
                         test=True, dump=str(tmp / f"{name}.rank{{rank}}.npz"), dump_step=DUMP_STEP.get(name))
                    for name, ref in refs.items()]
            out["jax_ranks"] = _Launch(tmp, "jax2", 2, jobs, exp / "jax2")
            out["jax"] = {name: ref.steps() for name, ref in refs.items()}
            out["jax_trainers"] = refs
    finally:
        jax.config.update("jax_default_matmul_precision", prec)
    out["phase_a"].result()
    out["phase_b"] = _Launch(tmp, "b", 2, [_job("run", "dagerc", [*resume, "--epoch=3", "--resume"], mode="train")],
                             exp / "shared")
    return out


# ------------------------------------------------------------------- mirror
def _check_mirror(single, ranks):
    n = len(ranks)
    for r in ranks:
        assert r["world"] == n and r["backend"] == "gloo"
        assert r["test_name"] == ranks[0]["test_name"]  # one run directory: rank 0 names it
        np.testing.assert_allclose(r["losses"], ranks[0]["losses"], rtol=1e-6)
        assert r["n_test_rows"] == single["n_test_rows"]
        assert r["test_f1"] == pytest.approx(ranks[0]["test_f1"], abs=0)
        assert r["test_Lall"] == pytest.approx(ranks[0]["test_Lall"], abs=0)
        assert len(r["first_batch_labels"]) > 0
    labels = sorted(sum((r["first_batch_labels"] for r in ranks), []))
    assert labels == sorted(single["first_batch_labels"])  # the strided slices reassemble the global batch
    np.testing.assert_allclose(ranks[0]["losses"], single["losses"], rtol=RTOL, atol=ATOL)
    assert ranks[0]["test_f1"] == pytest.approx(single["test_f1"], abs=1e-6)
    assert ranks[0]["test_Lall"] == pytest.approx(single["test_Lall"], rel=RTOL)


@pytest.mark.multiprocess
def test_two_process_train_matches_single(runs):
    single = runs[1].result()[0]["dagerc"]
    assert single["world"] == 1 and len(single["losses"]) == 3
    _check_mirror(single, [r["dagerc"] for r in runs[2].result()])


@pytest.mark.multiprocess
def test_four_process_train_matches_single(runs):
    _check_mirror(runs[1].result()[0]["dagerc"], [r["dagerc"] for r in runs[4].result()])


@pytest.mark.multiprocess
@pytest.mark.parametrize("n", [2, 4])
def test_padding_only_rank_gives_the_global_loss(runs, n):
    """The epoch's last global batch holds one dialogue: every rank but one
    trains on padding rows only, and the step's loss is still the global one."""
    single = runs[1].result()[0]["partial"]
    ranks = [r["partial"] for r in runs[n].result()]
    assert len(single["losses"]) == 8 and 1 in single["rows"]
    step = single["rows"].index(1)
    assert [r["rows"][step] for r in ranks] == [1] + [0] * (n - 1)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=RTOL, atol=ATOL)
        assert [sum(x) for x in zip(*(q["rows"] for q in ranks))] == single["rows"]


@pytest.mark.multiprocess
@pytest.mark.parametrize("n", [2, 4])
def test_ranks_draw_their_own_dropout_masks(runs, n):
    """Above dropout 0 every rank draws masks of its own, at the start and
    after every rank restored rank 0's state (a resume); rank 0 draws the
    one-process run's."""
    single = runs[1].result()[0]["dropout"]["draws"]
    ranks = [r["dropout"]["draws"] for r in runs[n].result()]
    assert ranks[0] == single
    for k in range(2):
        masks = {tuple(r[k]) for r in ranks}
        assert len(masks) == n, f"draw {k}: two ranks drew the same mask"
        assert all(0 < sum(m) < 256 for m in masks)


@pytest.mark.multiprocess
def test_only_rank_zero_writes(runs):
    """One run directory for both ranks, holding what a one-process run holds
    and, beside rank 0's log, rank 1's empty one."""
    single = runs[1].result()[0]["dagerc"]
    r0, r1 = (r["dagerc"] for r in runs[2].result())
    assert r0["test_dir"] == r1["test_dir"]

    def files(d):
        return sorted(f for f in os.listdir(d) if not f.startswith("log."))

    logs = {f.rsplit(".", 2)[-2]: f for f in os.listdir(r0["test_dir"]) if f.startswith("log.")}  # by rank
    assert sorted(logs) == ["0", "1"]
    assert os.path.getsize(os.path.join(r0["test_dir"], logs["1"])) == 0
    assert os.path.getsize(os.path.join(r0["test_dir"], logs["0"])) > 0
    assert files(r0["test_dir"]) == files(single["test_dir"])


@pytest.mark.multiprocess
def test_federated_preemption_resume(runs):
    """Preemption and resume under two ranks: both restore the same sibling
    checkpoint (epoch 2), and the continued trajectory is the one-process
    run's third epoch."""
    ctl = runs["ctl"].result()[0]["run"]
    a0, a1 = (r["run"] for r in runs["phase_a"].result())
    b0, b1 = (r["run"] for r in runs["phase_b"].result())
    assert ctl["eidx_at_begin"] == 0 and ctl["checkpoints"]
    per_epoch = len(ctl["losses"]) // 3
    assert a0["test_name"] == a1["test_name"] and a0["checkpoints"]
    np.testing.assert_allclose(a0["losses"], a1["losses"], rtol=1e-6)
    np.testing.assert_allclose(a0["losses"], ctl["losses"][: 2 * per_epoch], rtol=RTOL, atol=ATOL)
    assert b0["test_name"] == b1["test_name"] != a0["test_name"]  # a fresh test directory
    for r in (b0, b1):
        assert r["eidx_at_begin"] == 2 and len(r["losses"]) == per_epoch  # no split brain
    np.testing.assert_allclose(b0["losses"], b1["losses"], rtol=1e-6)
    np.testing.assert_allclose(b0["losses"], ctl["losses"][2 * per_epoch:], rtol=RTOL, atol=ATOL)
    assert b0["global_steps"] == ctl["global_steps"]


# --------------------------------------------------------------- vs the JAX package
@pytest.mark.multiprocess
@pytest.mark.parametrize("name", list(FAMILIES))
def test_two_ranks_match_jax(runs, name):
    jlosses, jstates = runs["jax"][name]
    r0, r1 = (r[name] for r in runs["jax_ranks"].result())
    assert r0["world"] == 2 and len(r0["losses"]) == 3
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r1["losses"], r0["losses"], rtol=1e-6)
    assert r0["test_f1"] == pytest.approx(r1["test_f1"], abs=0) and r0["n_test_rows"] == r1["n_test_rows"]
    dumps = [np.load(str(runs["tmp"] / f"{name}.rank{{rank}}.npz").replace("{rank}", str(k))) for k in (0, 1)]
    if name == "cogmen":  # the batch norm's running statistics: the global batch's, the same on both ranks
        want = convert.STATES["cogmen"](jstates[DUMP_STEP[name] - 1])
        for stat in ("gcn.bn.running_mean", "gcn.bn.running_var"):
            np.testing.assert_array_equal(dumps[0][f"model.{stat}"], dumps[1][f"model.{stat}"])
            np.testing.assert_allclose(dumps[0][f"model.{stat}"], want[stat].numpy(), rtol=RTOL, atol=ATOL)
    if name == "mmin_miss":  # the EMA shadow after 3 steps
        want = convert.STATES["mmin_miss"]({"params": jstates[-1]["ema"]})
        for key, w in want.items():
            np.testing.assert_array_equal(dumps[0][f"ema.{key}"], dumps[1][f"ema.{key}"])
            np.testing.assert_allclose(dumps[0][f"ema.{key}"], w.numpy(), rtol=RTOL, atol=EMA_ATOL, err_msg=key)
    if name == "cim":  # the multilabel block over both ranks' rows
        assert r0["test_multilabel"] and r0["test_multilabel"] == r1["test_multilabel"]


# ------------------------------------------------------------- in process
def test_rank_card_and_backend_rules():
    assert tdevice.rank_card(0, 3) == 3 and tdevice.rank_card(None, 1) == 1 and tdevice.rank_card("cuda", 2) == 2
    assert tdevice.rank_card("cuda:0", 3) == "cuda:0" and tdevice.rank_card(2, 3) == 2
    assert tdevice.rank_card("cpu", 1) == "cpu"
    assert tdevice.pick_backend(["h/cuda:0", "h/cuda:1"]) == "nccl"
    assert tdevice.pick_backend(["a/cuda:0", "b/cuda:0"]) == "nccl"  # two hosts, a card each
    assert tdevice.pick_backend(["h/cuda:0", "h/cuda:0"]) == "gloo"  # NCCL refuses two ranks on a card
    assert tdevice.pick_backend(["cpu", "cpu"]) == "gloo" and tdevice.pick_backend(["h/cuda:0", "cpu"]) == "gloo"
    assert tdevice.place_of(torch.device("cpu"), "h") == "cpu"


def test_mesh_spec_and_initialize_checks():
    assert mesh.MeshSpec().resolve(4) == (4, 1) and mesh.MeshSpec(data=2).resolve(2) == (2, 1)
    with pytest.raises(NotImplementedError, match="model axis"):
        mesh.MeshSpec(data=4, model=2).resolve(8)
    with pytest.raises(ValueError):
        mesh.MeshSpec(data=3).resolve(2)
    with pytest.raises(ValueError, match="--num_processes"):
        mesh.initialize_distributed("localhost:1", None, None, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        mesh.initialize_distributed("localhost:1", 2, 2, device="cpu")
    assert not mesh.initialize_distributed(None, 2, 0, device="cpu")  # no coordinator: one process
    assert not mesh.grouped() and mesh.process_count() == 1 and mesh.is_main_process()


def test_trainer_refuses_a_coordinator_without_a_group():
    """The entry point starts the group (``start_group``) before it builds a
    trainer; a trainer built with ``--coordinator`` and no group up refuses."""
    from erc_tpu_torch.models import dagerc

    p = dagerc.DAGERCParams()
    p.finalize([*COMMON, *DAGERC, "--coordinator=localhost:1", "--num_processes=2", "--process_id=0"])
    with pytest.raises(ValueError, match="none is up"):
        dagerc.DAGERCTrainer(p)
    assert not mesh.grouped()


def test_collectives_without_a_group_are_the_identity():
    x = torch.arange(4.0, requires_grad=True)
    assert mesh.global_sum(x) is x
    a = np.arange(6).reshape(3, 2)
    assert mesh.allgather_rows(a) is not None and np.array_equal(mesh.allgather_rows(a), a)
    assert mesh.allsum(2.5) == 2.5 and mesh.allsum(1.0, 2.0) == (1.0, 2.0)
    assert mesh.broadcast_one_to_all("name") == "name"
    g = [torch.ones(3)]
    mesh.allreduce_(g)
    mesh.broadcast_(g)
    assert torch.equal(g[0], torch.ones(3))
    assert mesh.captures_allowed() and mesh.backend() is None


RAGGED = textwrap.dedent("""
    import json
    import numpy as np, torch
    from erc_tpu_torch.parallel import mesh
    rank = mesh.initialize_distributed(device="cpu") and mesh.process_index()  # ERC_TPU_DIST=auto
    rows = mesh.allgather_rows(np.full((rank * 3, 2), rank + 1, np.int64))  # 0 rows and 3 rows
    total, count = mesh.allsum(1.5 * (rank + 1), rank)
    name = mesh.broadcast_one_to_all(f"rank{rank}")
    flat = [torch.full((2,), float(rank + 1)), torch.tensor(float(rank))]
    mesh.allreduce_(flat)
    x = torch.tensor([1.0, 2.0]) * (rank + 1)
    x.requires_grad_(True)
    s = mesh.global_sum(x)
    (s * (rank + 1)).sum().backward()  # each rank weighs the global sum by its own factor
    print(json.dumps({"rows": rows.tolist(), "total": total, "count": count, "name": name,
                      "flat": [t.tolist() for t in flat], "sum": s.tolist(), "grad": x.grad.tolist()}))
    mesh.destroy()
""")


def test_collectives_over_two_ranks():
    env = {**os.environ, "OMP_NUM_THREADS": "1", "ERC_TPU_DIST": "auto", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2"}
    procs = [subprocess.Popen([sys.executable, "-c", RAGGED], cwd=REPO, env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    outs = []
    for pr in procs:
        out, err = pr.communicate(timeout=120)
        assert pr.returncode == 0, err.decode()[-3000:]
        outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    for o in outs:
        assert o["rows"] == [[2, 2]] * 3  # rank 0's none, then rank 1's three
        assert o["total"] == 4.5 and o["count"] == 1.0 and o["name"] == "rank0"
        assert o["flat"] == [[3.0, 3.0], 1.0]
        assert o["sum"] == [3.0, 6.0]
        assert o["grad"] == [3.0, 3.0]  # d/dx_r of Σ_r' (r' + 1)·Σ_k x_k: the weights summed over ranks
