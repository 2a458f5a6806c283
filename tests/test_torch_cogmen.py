"""Port's COGMENModule at full width ≡ the JAX package's flax module.

Full width: input 712 (audio 100 + text 100 + visual 512), 2-layer encoder
with 8 heads and a 2048-wide feed-forward, hidden 100, window 5/5, 6
classes; B = 3, L = 16.  Logits agree within 1e-4 (the encoder's 2048-wide
sums run in another order on each side); banded ≡ dense inside the port
within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu.models.cogmen import COGMENModule as JCOGMEN
from erc_tpu_torch import convert
from erc_tpu_torch.models.cogmen import COGMENModule

ATOL = 1e-4
KW = dict(input_size=712, hidden_size=100, num_head=17, n_speakers=2, n_classes=6, wp=5, wf=5)

torch.set_grad_enabled(False)


@pytest.fixture(scope="module")
def batch():
    samples = j_synthetic_erc("iemocap-cogmen", 6, n_train=3, min_len=5, max_len=16, seed=3)
    return JERCBatcher("atv", 6, 2, bucket=16, max_len=16)(samples)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if v is not None}


@pytest.fixture(scope="module", params=["reference", "chained"])
def flax_variables(request, batch):
    """(encoder_mode, variables) with non-trivial BN running statistics."""
    mode = request.param
    model = JCOGMEN(graph_impl="dense", encoder_mode=mode, **KW)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0), batch, deterministic=True)
    )
    rng = np.random.default_rng(1)
    variables["batch_stats"]["gcn"]["bn"] = {
        "mean": rng.normal(0, 0.3, 100).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, 100).astype(np.float32),
    }
    return mode, variables


def _port(mode, graph_impl, variables):
    m = COGMENModule(graph_impl=graph_impl, encoder_mode=mode, **KW)
    m.load_state_dict(convert.cogmen_state(variables["params"], variables["batch_stats"]))
    return m.eval()


@pytest.mark.parametrize("graph_impl", ["dense", "banded", "auto"])
def test_cogmen_logits_match_flax(flax_variables, batch, graph_impl):
    mode, variables = flax_variables
    with jax.default_matmul_precision("highest"):
        want = np.asarray(
            JCOGMEN(graph_impl=graph_impl, encoder_mode=mode, **KW).apply(
                _jnp(variables), batch, deterministic=True
            )
        )
    got = _port(mode, graph_impl, variables)(_t_batch(batch)).numpy()
    assert got.shape == want.shape == (3, 16, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_cogmen_banded_equals_dense_in_port(flax_variables, batch):
    mode, variables = flax_variables
    b = _t_batch(batch)
    banded = _port(mode, "banded", variables)(b)
    dense = _port(mode, "dense", variables)(b)
    np.testing.assert_allclose(banded.numpy(), dense.numpy(), rtol=0, atol=1e-5)


def test_npz_conversion_serves_flax_weights(flax_variables, batch, tmp_path):
    """flax variables → flat npz → `python -m erc_tpu_torch.convert` → a state
    dict the engine loads as its checkpoint."""
    from erc_tpu_torch.serve import InferenceEngine

    mode, variables = flax_variables
    flat = traverse_util.flatten_dict(variables, sep="/")
    np.savez(tmp_path / "vars.npz", **flat)
    convert.main([str(tmp_path / "vars.npz"), str(tmp_path / "cogmen.pt")])
    engine = InferenceEngine.from_module(
        "cogmen", str(tmp_path / "cogmen.pt"), dataset="synthetic-cogmen-6",
        batch_size=3, max_seq_len=16, graph_impl="banded", encoder_mode=mode, device="cpu",
    )
    with jax.default_matmul_precision("highest"):
        want = np.asarray(
            JCOGMEN(graph_impl="banded", encoder_mode=mode, **KW).apply(
                _jnp(variables), batch, deterministic=True
            )
        )
    np.testing.assert_allclose(engine.logits(batch), want, rtol=0, atol=ATOL)
