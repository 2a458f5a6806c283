"""Port's layers ≡ the JAX package's flax modules, weights carried by
erc_tpu_torch.convert.

Tolerance 1e-5 absolute (float32) except the transformer encoder, 1e-4:
its 2048-wide feed-forward sums in another order on each side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.ops import graphs as jgraphs
from erc_tpu.ops.attention import TransformerEncoder as JEncoder
from erc_tpu.ops.gnn import DenseRGCN as JDenseRGCN, DenseTransformerConv as JDenseTConv
from erc_tpu.ops.gnn_banded import BandedRGCN as JBandedRGCN, BandedTransformerConv as JBandedTConv
from erc_tpu.ops.norm import MaskedBatchNorm as JMaskedBatchNorm
from erc_tpu.ops.pallas.banded import band_offsets
from erc_tpu_torch import convert
from erc_tpu_torch.ops import graphs as tgraphs
from erc_tpu_torch.ops.attention import TransformerEncoder
from erc_tpu_torch.ops.gnn import DenseRGCN, DenseTransformerConv
from erc_tpu_torch.ops.gnn_banded import BandedRGCN, BandedTransformerConv, _tap_valid
from erc_tpu_torch.ops.norm import MaskedBatchNorm

ATOL = 1e-5
ATOL_FF = 1e-4

torch.set_grad_enabled(False)


def _graph_inputs(B=2, L=24, D=12, S=2, lengths=(24, 13), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    spk = rng.integers(0, S, (B, L)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    return x, spk, lengths, mask


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


# ------------------------------------------------------------------ graphs
@pytest.mark.parametrize("wp,wf", [(5, 5), (3, 1), (-1, 2), (2, -1), (-1, -1)])
def test_window_adjacency_matches_jax(wp, wf):
    lengths = np.asarray([9, 4, 0], np.int32)
    want = np.asarray(jgraphs.window_adjacency(jnp.asarray(lengths), 11, wp, wf))
    got = tgraphs.window_adjacency(_t(lengths), 11, wp, wf)
    np.testing.assert_array_equal(got.numpy(), want)


def test_length_mask_and_relation_ids_match_jax():
    lengths = np.asarray([5, 0, 7], np.int32)
    np.testing.assert_array_equal(
        tgraphs.length_mask(_t(lengths), 7).numpy(), np.asarray(jgraphs.length_mask(jnp.asarray(lengths), 7))
    )
    spk = np.random.default_rng(0).integers(0, 3, (2, 9)).astype(np.int32)
    want = np.asarray(jgraphs.relation_ids(jnp.asarray(spk), 3))
    got = tgraphs.relation_ids(_t(spk), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_tap_valid_matches_jax():
    from erc_tpu.ops.gnn_banded import _tap_valid as j_tap_valid

    _, _, _, mask = _graph_inputs(L=10, lengths=(10, 4))
    for offs in (band_offsets(5, 5), (-1, 0, 2)):
        want = np.asarray(j_tap_valid(jnp.asarray(mask), offs))
        np.testing.assert_array_equal(_tap_valid(_t(mask), offs).numpy(), want)


# ------------------------------------------------------------------ norm
def test_masked_batch_norm_train_branch_matches_jax():
    """Batch stats over valid rows, unbiased running variance, re-masked output."""
    x, _, _, mask = _graph_inputs(D=6, seed=1)
    jm = JMaskedBatchNorm(6)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    want, updated = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), mutable=["batch_stats"])
    bn = MaskedBatchNorm(6)
    bn.load_state_dict(convert.batch_norm_state(_np_tree(variables["params"]),
                                                _np_tree(variables["batch_stats"])))
    bn.train()
    _close(bn(_t(x), _t(mask)), want)
    _close(bn.running_mean, updated["batch_stats"]["mean"])
    _close(bn.running_var, updated["batch_stats"]["var"])


def test_masked_batch_norm_eval_branch_matches_jax():
    x, _, _, mask = _graph_inputs(D=6, seed=2)
    rng = np.random.default_rng(3)
    params = {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    want = JMaskedBatchNorm(6).apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(x), jnp.asarray(mask), use_running_average=True)
    bn = MaskedBatchNorm(6)
    bn.load_state_dict(convert.batch_norm_state(params, stats))
    bn.eval()
    _close(bn(_t(x), _t(mask)), want)


# ------------------------------------------------------------------ encoder
def test_transformer_encoder_matches_jax_with_all_padding_dialogue():
    """Dialogue 2 is all padding, as in a request padded to the batch size:
    JAX gives it a uniform softmax, so the port must stay finite and equal."""
    B, L, E, H = 3, 10, 16, 4
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, L, E)).astype(np.float32)
    mask = (np.arange(L)[None] < np.asarray([10, 6, 0])[:, None]).astype(np.float32)
    jm = JEncoder(E, H, num_layers=2, dropout=0.0)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))["params"]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    enc = TransformerEncoder(E, H, num_layers=2, dropout=0.0)
    enc.load_state_dict(convert.encoder_state(_np_tree(params)))
    enc.eval()
    got = enc(_t(x), _t(mask))
    assert torch.isfinite(got).all()
    _close(got, want, ATOL_FF)


# ------------------------------------------------------------------ graph layers
@pytest.mark.parametrize("variant", ["mean", "add-bases-edge_norm"])
def test_dense_rgcn_matches_jax(variant):
    B, L, D, S, Dout = 2, 24, 12, 2, 8
    x, spk, lengths, _ = _graph_inputs(B, L, D, S, seed=5)
    R = 2 * S * S
    adj = jgraphs.window_adjacency(jnp.asarray(lengths), L, 5, 5)
    rel = jgraphs.relation_ids(jnp.asarray(spk), S)
    if variant == "mean":
        jm, tm, enorm = JDenseRGCN(Dout, R, aggr="mean"), DenseRGCN(D, Dout, R, aggr="mean"), None
    else:
        jm, tm = JDenseRGCN(Dout, R, num_bases=3, aggr="add"), DenseRGCN(D, Dout, R, 3, aggr="add")
        enorm = np.random.default_rng(6).uniform(0.2, 1.0, (B, L, L)).astype(np.float32)
    args = (jnp.asarray(x), adj, rel) + (() if enorm is None else (jnp.asarray(enorm),))
    params = jm.init(jax.random.PRNGKey(2), *args)["params"]
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": params}, *args)
    tm.load_state_dict(convert.rgcn_state(_np_tree(params)))
    targs = (_t(x), _t(adj), _t(rel)) + (() if enorm is None else (_t(enorm),))
    _close(tm(*targs), want)


def test_dense_transformer_conv_matches_jax():
    B, L, D = 2, 24, 16
    x, _, lengths, _ = _graph_inputs(B, L, D, seed=7)
    adj = jgraphs.window_adjacency(jnp.asarray(lengths), L, 5, 5)
    jm = JDenseTConv(D)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), adj)["params"]
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": params}, jnp.asarray(x), adj)
    tm = DenseTransformerConv(D, D)
    tm.load_state_dict(convert.transformer_conv_state(_np_tree(params)))
    _close(tm(_t(x), _t(adj)), want)


@pytest.mark.parametrize("aggr", ["mean", "add"])
def test_banded_rgcn_matches_jax(aggr):
    """Through the band kernels' plain versions (CPU) vs the Pallas kernels
    in interpret mode; 'add' also carries a per-tap edge norm."""
    B, L, D, S, Dout, wp, wf = 2, 24, 12, 2, 8, 5, 5
    x, spk, _, mask = _graph_inputs(B, L, D, S, seed=8)
    R = 2 * S * S
    K = len(band_offsets(wp, wf))
    enorm = None
    if aggr == "add":
        enorm = np.random.default_rng(9).uniform(0.2, 1.0, (B, L, K)).astype(np.float32)
    jm = JBandedRGCN(Dout, R, S, wp, wf, aggr=aggr)
    args = (jnp.asarray(x), jnp.asarray(spk), jnp.asarray(mask))
    jargs = args + (() if enorm is None else (jnp.asarray(enorm),))
    params = jm.init(jax.random.PRNGKey(4), *jargs)["params"]
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": params}, *jargs)
    tm = BandedRGCN(D, Dout, R, S, wp, wf, aggr=aggr)
    tm.load_state_dict(convert.rgcn_state(_np_tree(params)))
    targs = (_t(x), _t(spk), _t(mask)) + (() if enorm is None else (_t(enorm),))
    _close(tm(*targs), want)


def test_banded_transformer_conv_matches_jax():
    B, L, D = 2, 24, 16
    x, _, _, mask = _graph_inputs(B, L, D, seed=10)
    jm = JBandedTConv(D, 5, 5)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(mask))["params"]
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    tm = BandedTransformerConv(D, D, 5, 5)
    tm.load_state_dict(convert.transformer_conv_state(_np_tree(params)))
    _close(tm(_t(x), _t(mask)), want)


def test_banded_layers_equal_dense_layers_in_port():
    """Inside the port: the banded layers are the dense ones on windowed graphs."""
    B, L, D, S = 2, 24, 12, 2
    x, spk, lengths, mask = _graph_inputs(B, L, D, S, seed=11)
    g = torch.Generator().manual_seed(0)
    banded = BandedRGCN(D, D, 2 * S * S, S, 5, 5, generator=g)
    tconv = BandedTransformerConv(D, D, 5, 5, generator=g)
    adj = tgraphs.window_adjacency(_t(lengths), L, 5, 5)
    rel = tgraphs.relation_ids(_t(spk), S)
    h_b = tconv(banded(_t(x), _t(spk), _t(mask)), _t(mask))
    h_d = DenseTransformerConv.forward(tconv, DenseRGCN.forward(banded, _t(x), adj, rel), adj)
    m = _t(mask)[..., None] > 0
    _close(torch.where(m, h_b, 0.0), torch.where(m, h_d, 0.0).numpy(), 1e-5)
