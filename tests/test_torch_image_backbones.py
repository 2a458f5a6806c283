"""The port's CIFAR backbones (``erc_tpu_torch/models/image_backbones.py``)
against the JAX package's (``erc_tpu/models/image_backbones.py``), on the CPU.

``WideResnet(k=2, n=10)`` and ``resnet18`` on 4 × 32 × 32 images (NHWC for
JAX, NCHW for the port), the flax weights through ``convert.py``: eval
features, train-mode features, the running mean and variance after one train
step (flax's BatchNorm tracks the biased batch variance: ``nn.BatchNorm2d``'s
unbiased one would be off by n / (n − 1)), and the gradients of
``(feats ** 2).mean()`` (the flax gradient tree carried through the same
converter), all within 1e-5 of each quantity's largest magnitude where that
exceeds 1, else absolute.  The JAX module runs in float64 (``jax.enable_x64``)
from its float32 weights, the port in float32: JAX's own float32 resnet18
gradients lie up to 1.4e-5 from its float64 ones, the port's 1.7e-7.  The parameter counts of ``wideresnet_28_2``,
``resnet18`` and ``resnet50`` equal the JAX models' (``jax.eval_shape``), and
the truncated-normal kaiming initialisation's std is within 5 % of flax's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.models import image_backbones as jib
from erc_tpu_torch import convert
from erc_tpu_torch.models import image_backbones as tib
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
MODELS = {
    "wrn_10_2": (lambda: jib.WideResnet(k=2, n=10), lambda: tib.WideResnet(k=2, n=10), convert.wideresnet_state),
    "resnet18": (jib.resnet18, tib.resnet18, convert.resnet_cifar_state),
}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max abs diff {err} (scale {scale})"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """The JAX module's eval features and its train step (features, batch
    statistics, gradients) evaluated in float64 from its float32 weights, and
    the port's float32 module with those weights."""
    jmk, tmk, to_state = MODELS[request.param]
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32)
    jm = jmk()
    variables = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))

    def both(params, stats, xx):
        """The eval features, then the train step's gradients, features and statistics: one program."""
        def loss(p):
            feats, upd = jm.apply({"params": p, "batch_stats": stats}, xx, train=True, mutable=["batch_stats"])
            return (feats ** 2).mean(), (feats, upd["batch_stats"])

        evals = jm.apply({"params": params, "batch_stats": stats}, xx, train=False)
        return evals, jax.grad(loss, has_aux=True)(params)

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        eval_feats, (grads, (train_feats, stats)) = jax.jit(both)(v64["params"], v64["batch_stats"],
                                                                  jnp.asarray(x, jnp.float64))
        eval_feats, grads, train_feats, stats = np.asarray(eval_feats), _np(grads), np.asarray(train_feats), _np(stats)
    tm = tmk()
    tm.load_state_dict(to_state(variables["params"], variables["batch_stats"]))
    return {"name": request.param, "x": torch.tensor(x).permute(0, 3, 1, 2).contiguous(), "tm": tm,
            "eval": eval_feats, "train": train_feats, "stats": stats, "grads": grads, "to_state": to_state}


def test_eval_features(pair):
    with torch.no_grad():
        got = pair["tm"].eval()(pair["x"])
    _close(got, pair["eval"], f"{pair['name']} eval features")


def test_train_step_features_running_stats_and_grads(pair):
    tm = pair["tm"]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.train()
    tm.zero_grad()
    with torch.enable_grad():  # another test file may have switched grad mode off at import
        feats = tm(pair["x"])
        (feats ** 2).mean().backward()
    _close(feats.detach(), pair["train"], f"{pair['name']} train features")
    zeros = jax.tree_util.tree_map(np.zeros_like, pair["grads"])
    want_stats = pair["to_state"](zeros, pair["stats"])
    want_grads = pair["to_state"](pair["grads"], pair["stats"])
    state = tm.state_dict()
    n_stats = 0
    for k, w in want_stats.items():
        if k.endswith(("running_mean", "running_var")):
            _close(state[k], w.numpy(), f"{pair['name']} {k}")
            assert not torch.equal(state[k], before[k]), f"{k} did not move in the train step"
            n_stats += 1
    assert n_stats == 2 * sum(isinstance(m, tib.BatchNorm2d) for m in tm.modules())
    for name, p in tm.named_parameters():
        _close(p.grad, want_grads[name].numpy(), f"{pair['name']} gradient of {name}")
    tm.load_state_dict(before)


def test_running_variance_is_the_biased_one():
    """One train step from running statistics (0, 1) at momentum 1: the running
    variance is the batch's biased variance, as flax's BatchNorm keeps it."""
    bn = tib.BatchNorm2d(3, torch_momentum=1.0).train()
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    bn(x)
    torch.testing.assert_close(bn.running_var, x.var((0, 2, 3), unbiased=False), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, x.mean((0, 2, 3)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["wideresnet_28_2", "resnet18", "resnet50"])
def test_parameter_counts_equal_jax(name):
    jm = getattr(jib, name)()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    n_stats = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["batch_stats"]))
    tm = getattr(tib, name)(device="meta")
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert sum(b.numel() for b in tm.buffers()) == n_stats
    assert tm.feature_dim == jm.feature_dim


def test_kaiming_truncated_init_std():
    conv = tib.Conv2d(64, 64, 3, generator=torch.Generator().manual_seed(0))
    want = np.sqrt(2.0 / (64 * 9))  # flax kaiming_normal: variance 2 / fan_in, truncated at ±2 σ
    flax_kernel = np.asarray(jax.nn.initializers.kaiming_normal()(jax.random.PRNGKey(0), (3, 3, 64, 64)))
    std = float(conv.weight.std())
    assert abs(std - want) / want < 0.05 and abs(std - flax_kernel.std()) / flax_kernel.std() < 0.05
    assert float(conv.weight.abs().max()) <= 2 * want / 0.87962566103423978 + 1e-6  # truncated
