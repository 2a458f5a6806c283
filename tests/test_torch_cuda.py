"""The port's CUDA kernels and serving path on the card.

Marked ``cuda``: each test skips where no CUDA device is present.  On a GPU
machine (no JAX needed there, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

K1/K2 tolerance 1e-5 absolute (float32, only the summation order differs
from the plain version); K3 1e-4, since its recurrence compounds the
summation order over up to C positions, and bit for bit across repeats in
both variants; K4 1e-4 of max(1, max |plain|) per
gradient, since its weight gradients also sum B·C terms, and bit for bit
across repeats in both variants of its sweep; banded vs dense
and kernel vs eager logits 1e-4; training, kernel vs eager form, 1e-4
relative (gradients: each parameter's difference over its gradient's norm,
floored at 1e-4 of the global norm where the exact gradient is 0).
DialogueGCN's and MMGCN's card vs CPU logits 1e-4 with cuDNN's TF32 flag
on: their LSTM runs cuDNN in full float32 whatever the process-wide flags
say.  MMGCN's structured vs dense logits 1e-4, and its gradients with
checkpointed GCNII trips vs without, at dropout 0.4, 1e-4 relative.
DialogueGCN v2's card vs CPU logits 1e-4 for every base encoder, and its
gradients (the GRU base, the DialogueRNN base, the token track's TextCNN)
1e-4 relative, with cuDNN's TF32 flag on.  CIM's card vs CPU logits of both
heads 1e-4, and its gradients of Lce + Lmulti 1e-4 relative, TF32 flag on.
MMIN's card vs CPU raw and EMA logits 1e-4 and its gradients 1e-4 relative
for each of its three trainers, TF32 flag on.  The bfloat16 train step
(``--compute_dtype``, ``--transfer_dtype``): replayed ≡ eager bit for bit.
K steps a replay (``steps_per_call``): one replay of a group of 4 ≡ 4 eager
steps bit for bit, with 4 x one step's launches (COGMEN banded, DAG-ERC's
kernel form, lars under a Cos schedule); K eval batches a replay ≡ the
batches' single replays bit for bit.  The runtime: ``device_memory_stats``
gives numbers on the card, and ``--profile_steps``' Chrome trace of a
captured COGMEN banded step holds K1, K2 and K1ᵀ as the launch counts
moved; under ``train.profiler.trace`` each replayed DAG-ERC step's
``erc.step.launch`` range starts before its replay's first kernel, and the
port's spans lie within 50 us of their ``erc.*`` ranges.  Feature
extraction (``erc_tpu_torch/preprocess/``) at the CPU
tests' small sizes, with TF32 allowed in cuBLAS and cuDNN's convolutions
around the calls: card ≡ CPU within 1e-4 of max |CPU's| for the TSN
ResNet-50, TSM, X3D and the text encoder, fbank and MFCC within 1e-4 beyond
twice the CPU's own float32 deviation from a float64 evaluation, the STFT
1e-4 of max |X|, the settings restored after each call.  The extras
(``augment_image``, ``models/image_backbones``, ``ops/fusion``, ``contrib``)
at small sizes, card vs the CPU port: RandAugment's integer-path ops and
cutout bit for bit, its blend ops on ≥ 99.9 % of pixels and within 1; the
backbones (TF32 allowed around them) features 1e-4 of max |CPU|, running
statistics 1e-5, gradients in float64 1e-4 of each parameter's gradient
norm, one convolution's float32 gradients 1e-5 of max |CPU|; the
fusion modules 1e-5; the loss zoo, mixup and cutmix given the same draws
1e-6; K1–K4 launched 0 times.
"""

import gc

import numpy as np
import pytest
import torch

from erc_tpu_torch.ops.kernels import banded as kb
from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)

pytestmark = pytest.mark.cuda

CASES = [
    (4, 112, 100, tuple(range(-5, 6))),
    (4, 112, 100, tuple(range(-5, 0))),
    (4, 112, 100, tuple(range(0, 6))),
    (2, 7, 13, tuple(range(-10, 11))),
    (3, 13, 200, (-3, -1, 0, 2)),  # two column tiles in K1
    (1, 1, 1, (0,)),
    (2, 5, 257, (-7, 0, 9)),  # taps past both ends; a 1-wide last column tile
    (256, 112, 100, tuple(range(-5, 6))),  # COGMEN's max-throughput batch at full width
    (2, 40, 100, tuple(range(-32, 32))),  # K = 64, the kernel's limit
    (3, 1, 100, (-1, 0, 1)),  # L = 1 at a 16-byte width
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _randn(g, *shape):
    return torch.randn(*shape, generator=g, device="cuda")


def _variant_taken(name, before):
    (taken,) = [k.split("/")[1] for k, n in kb.variant_launches.items()
                if k.startswith(name + "/") and n == before[k] + 1]
    return taken


@pytest.mark.parametrize("B,L,D,offsets", CASES)
def test_kernels_match_plain_versions(cuda, B, L, D, offsets):
    """Both instantiations: 16-byte where D % 4 == 0 and the layout is
    aligned, 4-byte on a view one float past an aligned base."""
    g = torch.Generator(device=cuda).manual_seed(0)
    K = len(offsets)
    coef, a, b = _randn(g, B, L, K), _randn(g, B, L, D), _randn(g, B, L, D)
    ysel = _randn(g, B, L, 2, 2, D)
    coef_view = _randn(g, B, L, K + 3)[:, :, 2 : 2 + K]  # strided rows, unit last stride
    a_off, b_off = _randn(g, B, L, D + 1)[:, :, 1:], _randn(g, B, L, D + 1)[:, :, 1:]
    aligned = "vec4" if D % 4 == 0 else "scalar"
    for c, src, variant in ((coef, a, aligned), (coef, ysel[:, :, 1, 0, :], aligned),
                            (coef_view, a, aligned), (coef, a_off, "scalar")):
        before = dict(kb.variant_launches)
        got = kb.banded_gather_sum(c, src, offsets)
        torch.cuda.synchronize()
        assert _variant_taken("banded_gather_sum", before) == variant
        torch.testing.assert_close(got, kb.banded_gather_sum_reference(c, src, offsets),
                                   rtol=0, atol=1e-5)
    for x, y, variant in ((a, b, aligned), (ysel[:, :, 0, 0, :], ysel[:, :, 1, 1, :], aligned),
                          (a_off, b_off, "scalar"), (a, b_off, "scalar")):
        before = dict(kb.variant_launches)
        got = kb.banded_dot(x, y, offsets)
        torch.cuda.synchronize()
        assert _variant_taken("banded_dot", before) == variant
        torch.testing.assert_close(got, kb.banded_dot_reference(x, y, offsets), rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,L,D,offsets", CASES)
def test_transposed_gather_sum_matches_plain_version(cuda, B, L, D, offsets):
    """K1ᵀ in both instantiations, on the layouts its callers give it (a
    cotangent, a strided view, an expanded cotangent), bit for bit: it sums
    the taps in order with each product and sum rounded, as the plain
    version does."""
    g = torch.Generator(device=cuda).manual_seed(1)
    K = len(offsets)
    coef, a = _randn(g, B, L, K), _randn(g, B, L, D)
    ysel = _randn(g, B, L, 2, 2, D)
    expanded = _randn(g, 1, 1, D).expand(B, L, D)
    a_off = _randn(g, B, L, D + 1)[:, :, 1:]
    aligned = "vec4" if D % 4 == 0 else "scalar"
    for c, src, variant in ((coef, a, aligned), (coef, ysel[:, :, 0, 1, :], aligned), (coef, expanded, aligned),
                            (coef, a_off, "scalar")):
        before = dict(kb.variant_launches)
        got = kb.banded_gather_sum_t(c, src, offsets)
        torch.cuda.synchronize()
        assert _variant_taken("banded_gather_sum_t", before) == variant
        assert torch.equal(got, kb.banded_gather_sum_t_reference(c, src, offsets))


def _function_vs_plain(fn, ref, inputs, cotangent, needs):
    """Gradients through the kernel's autograd Function and through autograd
    of the plain version, for the inputs flagged in `needs`."""
    out = []
    for f in (fn, ref):
        leaves = [t.detach().clone().requires_grad_(n) for t, n in zip(inputs, needs)]
        with torch.enable_grad():
            f(*leaves).backward(cotangent)
        out.append([t.grad for t in leaves])
    return out


@pytest.mark.parametrize("needs", [(True, True), (False, True), (True, False)], ids=["both", "second", "first"])
def test_band_functions_equal_plain_autograd(cuda, needs):
    """K1's and K2's Functions on COGMEN's layouts: the RGCN's strided Ysel
    views and an expanded cotangent; an input that needs no gradient gets
    none, and its kernel is not launched."""
    g = torch.Generator(device=cuda).manual_seed(2)
    B, L, D = 32, 96, 100
    ysel = _randn(g, B, L, 2, 2, D)
    full, pos = tuple(range(-5, 6)), tuple(range(0, 6))
    gd = _randn(g, 1, 1, D).expand(B, L, D)
    gk = _randn(g, B, L, 11)
    cases = [
        (lambda c, y: kb.banded_gather_sum(c, y[:, :, 1, 1, :], pos),
         lambda c, y: kb.banded_gather_sum_reference(c, y[:, :, 1, 1, :], pos), (_randn(g, B, L, 6), ysel), gd,
         {"banded_gather_sum": 1, "banded_dot": int(needs[0]), "banded_gather_sum_t": int(needs[1])}),
        (lambda a, b: kb.banded_dot(a, b, full), lambda a, b: kb.banded_dot_reference(a, b, full),
         (_randn(g, B, L, D), _randn(g, B, L, D)), gk,
         {"banded_gather_sum": int(needs[0]), "banded_dot": 1, "banded_gather_sum_t": int(needs[1])}),
    ]
    for fn, ref, inputs, cot, launches in cases:
        kb.reset_launches()
        got, want = _function_vs_plain(fn, ref, inputs, cot, needs)
        torch.cuda.synchronize()
        assert kb.launches == launches
        for a, b, n in zip(got, want, needs):
            assert (a is None) == (not n)
            if n:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    x = _randn(g, 2, 5, 4).requires_grad_()
    with torch.enable_grad(), pytest.raises(ValueError, match="no backward"):
        kb.banded_gather_sum_t(_randn(g, 2, 5, 3), x, (0, 1, 2))


def test_kernels_reject_other_dtypes(cuda):
    x = torch.zeros(1, 4, 3, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kb.banded_dot(x, x, (0,))


def test_engine_banded_equals_dense_and_counts_launches(cuda):
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", encoder_mode="chained", batch_size=4)
    banded = InferenceEngine.from_module("cogmen", graph_impl="banded", cuda_graphs=False, **kw)
    dense = InferenceEngine.from_module("cogmen", graph_impl="dense", **kw)
    dense.model.load_state_dict(banded.model.state_dict())
    batch = banded.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=4, max_len=40))
    kb.reset_launches()
    got = banded.logits(batch)
    assert kb.launches == {"banded_gather_sum": 5, "banded_dot": 1, "banded_gather_sum_t": 0}
    # every launch of the full-width (D = 100) path reads 16 bytes at a time
    assert kb.variant_launches == {"banded_gather_sum/vec4": 5, "banded_gather_sum/scalar": 0,
                                   "banded_dot/vec4": 1, "banded_dot/scalar": 0,
                                   "banded_gather_sum_t/vec4": 0, "banded_gather_sum_t/scalar": 0}
    np.testing.assert_allclose(got, dense.logits(batch), rtol=0, atol=1e-4)


# ------------------------------------------------------------------ K3 dag_block
def _dag_inputs(g, B, C, D, prefix=True, pad_rows=0):
    """K3's arguments as DAGStack builds them: a causal within-block mask in
    which i-1 always precedes i, additive -1e30 masks, float32-min columns
    past the dialogue, and `pad_rows` trailing positions with no predecessor
    (padding); batch row 0 is an all-padding dialogue."""
    f32min = torch.finfo(torch.float32).min
    adj = (torch.rand(B, C, C, generator=g, device="cuda") < 0.6).float().tril(-1)
    adj[:, torch.arange(1, C), torch.arange(C - 1)] = 1.0
    adj[0] = 0.0
    colpad = torch.zeros(C, device="cuda")
    if pad_rows:
        adj[:, C - pad_rows :] = 0.0
        colpad[C - pad_rows :] = f32min
    amw = -(1.0 - adj) * 1e30 + colpad
    smw = (torch.rand(B, C, C, generator=g, device="cuda") < 0.5).float()
    r = lambda *s, scale=1.0: _randn(g, *s) * scale  # noqa: E731
    if prefix:
        num01, den_p, mp = r(B, C, D), torch.rand(B, C, generator=g, device="cuda") + 0.5, r(B, C)
    else:
        num01 = torch.zeros(B, C, D, device="cuda")
        den_p = torch.zeros(B, C, device="cuda")
        mp = torch.full((B, C), f32min / 2, device="cuda")
    s = 1.0 / D**0.5
    weights = (r(3, D, D, scale=s), r(3, D, scale=s), r(3, D, D, scale=s), r(3, D, scale=s),
               r(D, D, scale=s), r(D, D, scale=s), r(D, 1, scale=s))
    flag = 0 if prefix else 1
    return (flag, r(B, C), r(B, C, 3, D), r(B, C, 3, D), r(B, C, D), num01, den_p, mp, amw, smw,
            *weights)


K3_CASES = [  # (B, C, D, prefix, pad_rows)
    (32, 16, 300, True, 0),  # DAG-ERC's serving shape, a later block
    (32, 16, 300, False, 0),  # the first block: flag, no prefix
    (32, 16, 300, True, 5),  # a last block whose tail is padding
    (16, 16, 300, True, 0),  # DAG-ERC's training shape
    (3, 5, 13, True, 2),  # ragged: C, D not multiples of 32 or 4; D < 16: ranks 4-15 own no columns
    (2, 1, 7, False, 0),  # C = 1
    (5, 40, 33, True, 3),  # C > 32: more columns than lanes; 4 columns a block, ranks 9-15 none
    (5, 8, 10, True, 1),  # D < 16, not a multiple of 4: 4-byte weight copies, ranks 3-15 own none
    (2, 6, 36, True, 0),  # 16-byte weight copies of 4 columns a block, ranks 9-15 own none
    (13, 16, 300, True, 0),  # B not a multiple of the rows a cluster carries
    (3, 64, 300, True, 0),  # two rows' buffers do not fit in the stream variant; a cluster takes it
    (1, 128, 300, True, 4),  # C = 128: one row per cluster
    (2, 16, 512, True, 0),  # the stream variant: a slice of 32 columns does not fit
]


def _variant(D):
    return "stream" if D > 320 else "cluster"


@pytest.mark.parametrize("B,C,D,prefix,pad_rows", K3_CASES)
def test_dag_block_matches_plain_version(cuda, B, C, D, prefix, pad_rows):
    """Each case in the variant its shape selects, and bit for bit across repeats."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    g = torch.Generator(device=cuda).manual_seed(B * 100 + C)
    args = _dag_inputs(g, B, C, D, prefix, pad_rows)
    kd.reset_launches()
    got = kd.dag_block(*args)
    torch.cuda.synchronize()
    assert kd.launches["dag_block"] == 1
    assert kd.variant_launches[f"dag_block/{_variant(D)}"] == 1
    for name, a, b in zip(("h1", "V0w", "V1w", "Kw"), got, kd.dag_block_reference(*args)):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4, msg=name)
    again = kd.dag_block(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bit for bit


def test_dag_block_takes_one_row_per_block_where_two_do_not_fit(cuda):
    """The stream variant carries 2 rows a block, or 1 where 2 do not fit; the
    cluster variant takes DAG-ERC's shapes on as many clusters as the card
    holds at once (cudaOccupancyMaxActiveClusters)."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    assert kd._pick_rows(kd.stream_smem, 16, 512) == kd.ROWS_PER_BLOCK == 2
    assert kd._pick_rows(kd.stream_smem, 64, 400) == 1
    n_max = kd.max_clusters(cuda, 16, 300)
    assert 1 <= n_max <= 132 // kd.CLUSTER_BLOCKS
    for B in (32, 16):
        p = kd.launch_plan(cuda, B, 16, 300)
        assert p == kd.plan(B, 16, 300, n_max)
        assert p.variant == "cluster" and p.n <= n_max and p.rows == -(-B // min(B, n_max))
    assert kd.launch_plan(cuda, 1, 128, 300).variant == "cluster"
    assert kd.launch_plan(cuda, 2, 16, 512) == kd.Plan("stream", 2, 1, 0)
    with pytest.raises(ValueError, match="shared memory"):
        kd.launch_plan(cuda, 1, 256, 300)


SMEM_CASES = [  # (variant, rows, C, D, cols)
    *((1, r, 16, 300, 19) for r in range(1, 9)),
    (1, 1, 128, 300, 19), (1, 4, 16, 300, 20), (1, 2, 5, 13, 1), (1, 3, 40, 33, 3), (1, 1, 16, 512, 32),
    (0, 1, 16, 300, 0), (0, 2, 16, 300, 0), (0, 2, 64, 400, 0), (0, 1, 3, 7, 0),
]


def test_dag_block_smem_formulas_agree_with_the_kernel(cuda):
    """cluster_smem and stream_smem ≡ the C entry point's need; a plan that
    does not fit, or does not cover the batch, is refused by the kernel's
    entry point and raises."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    lib = kd._library()
    for v, r, C, D, cols in SMEM_CASES:
        want = kd.cluster_smem(r, C, D, cols) if v else kd.stream_smem(r, C, D)
        assert lib.erc_dag_block_smem(v, r, C, D, cols) == want, (v, r, C, D, cols)
    args = _dag_inputs(torch.Generator(device=cuda).manual_seed(4), 2, 16, 300)
    for bad in (kd.Plan("cluster", 8, 1, 19),  # 8 rows do not fit
                kd.Plan("cluster", 1, 1, 19),  # 1 row a cluster, 1 cluster, B = 2
                kd.Plan("cluster", 1, 2, 18)):  # 16 x 18 columns do not cover D = 300
        with pytest.raises(RuntimeError, match="cudaError"):
            kd._forward(args[0], args[1:], plan_=bad)


def test_dag_block_writes_strided_buffer_views(cuda):
    from erc_tpu_torch.ops.kernels import dag_block as kd

    g = torch.Generator(device=cuda).manual_seed(7)
    B, C, D, L, s = 4, 6, 20, 18, 6
    args = _dag_inputs(g, B, C, D)
    bufs = (torch.zeros(B, L, D, device=cuda), torch.zeros(B, L, D, device=cuda),
            torch.zeros(B, L, D, device=cuda), torch.zeros(B, L, device=cuda))
    kd.dag_block(*args, out=tuple(b[:, s : s + C] for b in bufs))
    torch.cuda.synchronize()
    for b, want in zip(bufs, kd.dag_block_reference(*args)):
        torch.testing.assert_close(b[:, s : s + C], want, rtol=0, atol=1e-4)
        assert not b[:, :s].any() and not b[:, s + C :].any()


def test_dag_block_refuses_grad_and_other_dtypes(cuda):
    """With grad, K3 then K4 through the autograd Function (out= refused)."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    args = list(_dag_inputs(torch.Generator(device=cuda).manual_seed(1), 2, 3, 8))
    args[4] = args[4].requires_grad_(True)
    kd.reset_launches()
    with torch.enable_grad():
        out = kd.dag_block(*args)
        with pytest.raises(ValueError, match="out="):
            kd.dag_block(*args, out=tuple(torch.empty_like(o) for o in out))
        out[0].sum().backward()
    torch.cuda.synchronize()
    assert kd.launches == {"dag_block": 1, "dag_block_bwd": 1}
    assert torch.isfinite(args[4].grad).all()
    with torch.no_grad():
        kd.dag_block(*args)  # nothing to differentiate: K3 alone
    args[4] = args[4].detach().double()
    with pytest.raises(TypeError):
        kd.dag_block(*args)
    too_long = _dag_inputs(torch.Generator(device=cuda).manual_seed(2), 1, 256, 300)
    with pytest.raises(ValueError, match="shared memory"):  # fits neither variant
        kd.dag_block(*too_long)


def test_dagerc_engine_kernel_equals_eager_and_counts_launches(cuda):
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.ops.kernels import dag_block as kd
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", batch_size=4)
    kernel = InferenceEngine.from_module("dagerc", cuda_graphs=False, **kw)  # dag_impl=auto: K3 in eval
    eager = InferenceEngine.from_module("dagerc", dag_impl="eager", **kw)
    eager.model.load_state_dict(kernel.model.state_dict())
    batch = kernel.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=3, max_len=40))
    Lp = batch["input_tensor"].shape[1]
    kd.reset_launches()
    got = kernel.logits(batch)
    assert kd.launches["dag_block"] == 4 * -(-Lp // 16)
    assert kd.variant_launches == {"dag_block/cluster": 4 * -(-Lp // 16), "dag_block/stream": 0,
                                   "dag_block_bwd/cluster": 0, "dag_block_bwd/stream": 0,
                                   "dag_block_bwd/global": 0}
    np.testing.assert_allclose(got, eager.logits(batch), rtol=0, atol=1e-4)
    assert kd.launches["dag_block"] == 4 * -(-Lp // 16)  # the eager form launches nothing


# ------------------------------------------------------------------ K4 dag_block_bwd
K4_CASES = [  # (B, C, D, prefix, pad_rows, a forced plan or None)
    (16, 16, 300, True, 0, None),  # DAG-ERC's training shape
    (32, 16, 300, True, 0, None),
    (32, 16, 300, False, 0, None),  # the first block: flag, no prefix
    (32, 16, 300, True, 5, None),  # a last block whose tail is padding
    (3, 5, 13, True, 2, None),  # ragged: D < 16, ranks 4-15 own no rows
    (2, 1, 7, False, 0, None),  # C = 1
    (5, 40, 33, True, 3, None),  # C > 32
    (3, 40, 300, True, 0, None),  # two rows' buffers do not fit the stream variant; the cluster takes it
    (2, 64, 300, True, 4, None),  # --dag_chunk=64: one row a cluster
    (5, 6, 36, True, 0, None),  # 16-byte weight copies of 4 rows a block
    (2, 16, 512, True, 3, None),  # the stream variant: rows of 32 columns do not fit a cluster
    (16, 16, 300, True, 2, "stream"),  # the stream variant forced at the training shape
    (16, 128, 300, True, 3, None),  # --dag_chunk=128: the stream buffers in device memory
    (4, 16, 300, True, 2, "global"),  # the global variant forced at a small shape
]


@pytest.mark.parametrize("B,C,D,prefix,pad_rows,force", K4_CASES)
def test_dag_block_bwd_matches_plain_version(cuda, B, C, D, prefix, pad_rows, force):
    """Each case in the variant its shape selects (or `force`), and bit for bit across repeats."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    g = torch.Generator(device=cuda).manual_seed(B * 100 + C + 1)
    args = _dag_inputs(g, B, C, D, prefix, pad_rows)
    outs = kd._forward(args[0], args[1:], residuals=True)
    for a, b in zip(outs, kd.dag_block_reference(args[0], *args[1:], residuals=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    cts = [_randn(g, *o.shape) for o in outs[:4]]
    plan_ = {None: None, "stream": kd.Plan("stream", kd.ROWS_PER_BLOCK, -(-B // kd.ROWS_PER_BLOCK), 0),
             "global": kd.Plan("global", 1, B, 0)}[force]
    variant = force or ("global" if C > 74 else "stream" if D > 320 else "cluster")
    kd.reset_launches()
    got = kd.dag_block_backward(args[0], *args[1:], *outs, *cts, plan_=plan_)
    torch.cuda.synchronize()
    assert kd.launches["dag_block_bwd"] == 1
    assert kd.variant_launches[f"dag_block_bwd/{variant}"] == 1
    want = kd.dag_block_backward_reference(args[0], *args[1:], *outs, *cts)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), i
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(1.0, b.abs().max().item()), msg=str(i))
    again = kd.dag_block_backward(args[0], *args[1:], *outs, *cts, plan_=plan_)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bit for bit


def test_dag_block_bwd_rows_per_block_and_refusal(cuda):
    """C = 64 at D = 300 runs in the cluster variant, one row a cluster, on as
    many clusters as the card holds at once; C = 128 fits neither shared-
    memory variant and runs in the global one, one row a block; a global
    plan of more rows a block, or of other than B blocks (its workspace is
    sized by the plan's blocks), is refused before any launch."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    n_max = kd.bwd_max_clusters(cuda, 16, 300)
    assert 1 <= n_max <= 132 // kd.CLUSTER_BLOCKS
    assert kd.bwd_launch_plan(cuda, 16, 16, 300) == kd.bwd_plan(16, 16, 300, n_max)
    assert kd.bwd_launch_plan(cuda, 3, 64, 300) == kd.Plan("cluster", 1, 3, 20)
    g = torch.Generator(device=cuda).manual_seed(3)
    args = _dag_inputs(g, 1, 64, 300)
    outs = kd._forward(args[0], args[1:], residuals=True)  # K3 takes C = 64 in a cluster
    kd.reset_launches()
    got = kd.dag_block_backward(args[0], *args[1:], *outs, *[torch.ones_like(o) for o in outs[:4]])
    torch.cuda.synchronize()
    assert kd.variant_launches["dag_block_bwd/cluster"] == 1
    assert all(torch.isfinite(t).all() for t in got)
    args = _dag_inputs(g, 1, 128, 300)
    outs = kd._forward(args[0], args[1:], residuals=True)
    assert kd.bwd_launch_plan(cuda, 1, 128, 300) == kd.Plan("global", 1, 1, 0)
    got = kd.dag_block_backward(args[0], *args[1:], *outs, *[torch.ones_like(o) for o in outs[:4]])
    torch.cuda.synchronize()
    assert kd.variant_launches["dag_block_bwd/global"] == 1
    assert all(torch.isfinite(t).all() for t in got)
    with pytest.raises(RuntimeError, match="cudaError"):
        kd.dag_block_backward(args[0], *args[1:], *outs, *[torch.zeros_like(o) for o in outs[:4]],
                              plan_=kd.Plan("global", 2, 1, 0))
    args = _dag_inputs(g, 3, 128, 300)
    outs = kd._forward(args[0], args[1:], residuals=True)
    cots = [torch.ones_like(o) for o in outs[:4]]
    for n in (1, 2, 4):
        with pytest.raises(RuntimeError, match="cudaError"):
            kd.dag_block_backward(args[0], *args[1:], *outs, *cots, plan_=kd.Plan("global", 1, n, 0))
    assert kd.variant_launches["dag_block_bwd/global"] == 1


BWD_SMEM_CASES = [  # (variant, rows, C, D, cols)
    *((1, r, 16, 300, 20) for r in range(1, 5)),
    (1, 1, 64, 300, 20), (1, 1, 128, 300, 20), (1, 2, 5, 13, 4), (1, 3, 40, 33, 4), (1, 1, 16, 512, 32),
    (0, 1, 16, 300, 0), (0, 2, 16, 300, 0), (0, 1, 16, 512, 0), (0, 2, 4, 400, 0),
]


def test_dag_block_bwd_smem_formulas_agree_with_the_kernel(cuda):
    """bwd_cluster_smem and bwd_stream_smem ≡ the C entry point's need; a plan
    that does not fit, or does not cover the batch, is refused by the
    kernel's entry point and raises."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    lib = kd._library("dag_block_bwd")
    for v, r, C, D, cols in BWD_SMEM_CASES:
        want = kd.bwd_cluster_smem(r, C, D, cols) if v else kd.bwd_stream_smem(r, C, D)
        assert lib.erc_dag_block_bwd_smem(v, r, C, D, cols) == want, (v, r, C, D, cols)
    args = _dag_inputs(torch.Generator(device=cuda).manual_seed(4), 2, 16, 300)
    outs = kd._forward(args[0], args[1:], residuals=True)
    cts = [torch.zeros_like(o) for o in outs[:4]]
    for bad in (kd.Plan("cluster", 4, 1, 20),  # 4 rows do not fit
                kd.Plan("cluster", 1, 1, 20),  # 1 row a cluster, 1 cluster, B = 2
                kd.Plan("cluster", 2, 1, 19),  # 19 columns a block: not a multiple of 4
                kd.Plan("cluster", 2, 1, 16)):  # 16 x 16 rows do not cover D = 300
        with pytest.raises(RuntimeError, match="cudaError"):
            kd.dag_block_backward(args[0], *args[1:], *outs, *cts, plan_=bad)


def _grad_rel(model, other):
    pairs = [(n, a.grad.double(), b.grad.double().to(a.device))
             for (n, a), b in zip(model.named_parameters(), other.parameters())]
    total = torch.sqrt(sum((b ** 2).sum() for _, _, b in pairs)).item()
    return {n: ((a - b).norm() / max(b.norm().item(), 1e-4 * total)).item() for n, a, b in pairs}


def _trainers(B=4, steps_batches=2, chunk=16):
    from erc_tpu_torch.data.loader import to_device
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.models import dagerc

    out = []
    for impl in ("kernel", "eager"):
        p = dagerc.DAGERCParams()
        p.finalize(["--dataset=synthetic-iemocap-6", "--reimplement", f"--dag_impl={impl}", "--device=cuda",
                    f"--dag_chunk={chunk}"])
        t = dagerc.DAGERCTrainer(p)
        t.log = lambda msg: None
        t.initialize()
        out.append(t)
    batcher = out[0].batcher(B)
    # each batch with an all-padding dialogue; dialogues as long as a chunk of 64
    batches = [to_device(batcher(synthetic_erc("iemocap-cogmen", 6, n_train=B - 1, max_len=max(40, chunk), seed=s)),
                         out[0].device) for s in range(steps_batches)]
    return out, batches


def test_function_grads_equal_eager_autograd_at_full_width(cuda):
    from erc_tpu_torch.ops.kernels import dag_block as kd

    (kern, eager), (batch, _) = _trainers()
    kd.reset_launches()
    kern.compute_grads(batch)
    eager.compute_grads(batch)
    torch.cuda.synchronize()
    blocks = -(-batch["input_tensor"].shape[1] // 16)
    assert kd.launches == {"dag_block": 2 * 4 * blocks, "dag_block_bwd": 4 * blocks}  # remat: K3 twice
    assert kd.variant_launches == {"dag_block/cluster": 2 * 4 * blocks, "dag_block/stream": 0,
                                   "dag_block_bwd/cluster": 4 * blocks, "dag_block_bwd/stream": 0,
                                   "dag_block_bwd/global": 0}
    worst = max(_grad_rel(kern.model, eager.model).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst


@pytest.mark.parametrize("chunk", [16, 64])
def test_trainer_two_steps_kernel_equals_eager(cuda, chunk):
    """At dag_chunk 64 K4 takes blocks of up to 64 positions (one row a
    cluster), which its stream variant could not hold at D = 300."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    (kern, eager), batches = _trainers(chunk=chunk)
    kd.reset_launches()
    for b in batches:
        lk, le = kern.train_step(b)["Lall"].item(), eager.train_step(b)["Lall"].item()
        assert abs(lk - le) <= 1e-4 * abs(le), (lk, le)
    assert kd.variant_launches["dag_block_bwd/cluster"] == kd.launches["dag_block_bwd"] > 0
    assert kd.variant_launches["dag_block_bwd/stream"] == 0
    for (name, a), b in zip(kern.model.named_parameters(), eager.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4, msg=name)  # Adam magnifies rounding


def test_trainer_chunk_128_kernel_equals_eager(cuda):
    """At dag_chunk 128 K4 takes its global variant (blocks of C >= 75 at
    D = 300 fit neither shared-memory variant): gradients ≡ the eager form."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    (kern, eager), (batch, _) = _trainers(chunk=128)
    kd.reset_launches()
    kern.compute_grads(batch)
    eager.compute_grads(batch)
    torch.cuda.synchronize()
    L = batch["input_tensor"].shape[1]
    assert kd.variant_launches["dag_block_bwd/global"] == kd.launches["dag_block_bwd"] == 4 * -(-L // 128)
    worst = max(_grad_rel(kern.model, eager.model).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst


# ------------------------------------------------------------------ COGMEN training
def _cogmen_trainer(impl, device="cuda", drop=None, sche=()):
    from erc_tpu_torch.models import cogmen

    p = cogmen.COGMENParams()
    p.finalize(["--dataset=synthetic-cogmen-6", "--encoder_mode=chained", f"--graph_impl={impl}",
                f"--device={device}", "--max_seq_len=96", *sche])
    if drop is not None:
        p.drop_rate = drop
    t = cogmen.COGMENTrainer(p)
    t.log = lambda msg: None
    t.initialize()
    return t


def test_cogmen_banded_training_launches_and_equals_dense(cuda):
    """One banded train step at full width: K1 5 + 1, K2 1 + 1 and K1ᵀ 6
    launches (forward: the RGCN's 4 gather-sums and the graph transformer's
    aggregation and scores; backward: 4 RGCN d src and d v, d k through K1ᵀ,
    d q through K1, d alpha through K2), all 16-byte; gradients ≡ the dense
    graph's (the same dropout masks: the graph draws none) and, at dropout
    0, ≡ a CPU run of the same weights."""
    from erc_tpu_torch.data.loader import to_device

    banded, dense = _cogmen_trainer("banded"), _cogmen_trainer("dense")
    host = next(iter(banded.make_loader("train")))
    batch = to_device(host, banded.device)
    kb.reset_launches()
    banded.compute_grads(batch)
    torch.cuda.synchronize()
    assert kb.launches == {"banded_gather_sum": 6, "banded_dot": 2, "banded_gather_sum_t": 6}
    assert all(n == 0 for k, n in kb.variant_launches.items() if k.endswith("/scalar"))
    dense.compute_grads(batch)
    worst = max(_grad_rel(banded.model, dense.model).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst
    card, cpu = _cogmen_trainer("banded", drop=0.0), _cogmen_trainer("banded", "cpu", drop=0.0)
    card.compute_grads(batch)
    cpu.compute_grads(to_device(host, torch.device("cpu")))
    worst = max(_grad_rel(card.model, cpu.model).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst


# ------------------------------------------------------------------ DialogueGCN
# one banded forward: K1 for the RGCN's 2 speakers x 2 directions (the backward
# taps at K = 10 in the generic instantiation, the forward ones at K = 11) and
# GraphConv's window sum (K = 21); K2 for EdgeAtt's scores (K = 21)
DGCN_FORWARD_TAPS = {"banded_gather_sum/kt0": 2, "banded_gather_sum/kt11": 2, "banded_gather_sum/kt21": 1,
                     "banded_dot/kt21": 1}
# one train step adds K2 for the RGCN's d coef (K = 10, 11), K1 for EdgeAtt's
# d a (K = 21), and K1ᵀ for the RGCN's d src (K = 10, 11) and for GraphConv's
# and EdgeAtt's d src / d b (K = 21)
DGCN_STEP_TAPS = {"banded_gather_sum/kt0": 2, "banded_gather_sum/kt11": 2, "banded_gather_sum/kt21": 2,
                  "banded_dot/kt0": 2, "banded_dot/kt11": 2, "banded_dot/kt21": 1,
                  "banded_gather_sum_t/kt0": 2, "banded_gather_sum_t/kt11": 2, "banded_gather_sum_t/kt21": 2}


def _nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def test_dgcn_engine_banded_equals_dense_and_counts_launches(cuda):
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.serve import InferenceEngine

    kw = dict(dataset="synthetic-cogmen-6", batch_size=4)
    banded = InferenceEngine.from_module("dgcn", graph_impl="banded", cuda_graphs=False, **kw)
    dense = InferenceEngine.from_module("dgcn", graph_impl="dense", **kw)
    dense.model.load_state_dict(banded.model.state_dict())
    batch = banded.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=3, max_len=60))  # and a padding row
    kb.reset_launches()
    got = banded.logits(batch)
    assert kb.launches == {"banded_gather_sum": 5, "banded_dot": 1, "banded_gather_sum_t": 0}
    assert _nonzero(kb.variant_launches) == {"banded_gather_sum/vec4": 5, "banded_dot/vec4": 1}
    assert _nonzero(kb.tap_launches) == DGCN_FORWARD_TAPS
    np.testing.assert_allclose(got, dense.logits(batch), rtol=0, atol=1e-4)


def test_dgcn_card_equals_cpu_with_cudnn_tf32_on(cuda):
    """cuDNN's TF32 flag on (torch's default) for the whole test: the LSTM
    still runs in full float32, so the card's logits equal the CPU's."""
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.serve import InferenceEngine

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        kw = dict(dataset="synthetic-cogmen-6", batch_size=4, graph_impl="banded")
        card = InferenceEngine.from_module("dgcn", **kw)
        cpu = InferenceEngine.from_module("dgcn", device="cpu", **kw)
        cpu.model.load_state_dict(card.model.state_dict())
        batch = card.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=4, max_len=110))
        np.testing.assert_allclose(card.logits(batch), cpu.logits(batch), rtol=0, atol=1e-4)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("D,offsets", [(100, tuple(range(-10, 0))), (100, tuple(range(1, 11))),
                                       (200, tuple(range(-10, 11)))], ids=["K10-D100", "K10-negated-D100", "K21-D200"])
def test_band_kernels_at_dgcn_shapes(cuda, D, offsets):
    """K1, K2 and K1ᵀ at DialogueGCN's shapes: the RGCN's backward taps
    (K = 10, the generic instantiation, kt0) and EdgeAtt's band (K = 21)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, L, K = 4, 112, len(offsets)
    coef, a, b = _randn(g, B, L, K), _randn(g, B, L, D), _randn(g, B, L, D)
    kt = f"kt{K if K in kb.UNROLLED_TAPS else 0}"
    assert kt == ("kt0" if K == 10 else "kt21")
    for name, fn, ref, x, y in (
            ("banded_gather_sum", kb.banded_gather_sum, kb.banded_gather_sum_reference, coef, a),
            ("banded_dot", kb.banded_dot, kb.banded_dot_reference, a, b),
            ("banded_gather_sum_t", kb.banded_gather_sum_t, kb.banded_gather_sum_t_reference, coef, a)):
        kb.reset_launches()
        got = fn(x, y, offsets)
        torch.cuda.synchronize()
        assert _nonzero(kb.tap_launches) == {f"{name}/{kt}": 1}
        assert _nonzero(kb.variant_launches) == {f"{name}/vec4": 1}
        torch.testing.assert_close(got, ref(x, y, offsets), rtol=0, atol=1e-5)


def _dgcn_trainer(impl, device="cuda", drop=None):
    from erc_tpu_torch.models import dgcn

    p = dgcn.DGCNParams()
    p.finalize(["--dataset=synthetic-cogmen-6", f"--graph_impl={impl}", f"--device={device}", "--max_seq_len=96"])
    if drop is not None:
        p.drop_rate = drop
    t = dgcn.DGCNTrainer(p)
    t.log = lambda msg: None
    t.initialize()
    return t


def test_dgcn_banded_training_launches_and_equals_dense(cuda):
    """One banded train step at full width: K1 5 + 1, K2 1 + 4 and K1ᵀ 6
    launches, all 16-byte, by instantiation as DGCN_STEP_TAPS; gradients ≡
    the dense graph's (the same dropout masks) by the floor rule."""
    from erc_tpu_torch.data.loader import to_device

    banded, dense = _dgcn_trainer("banded"), _dgcn_trainer("dense")
    batch = to_device(next(iter(banded.make_loader("train"))), banded.device)
    kb.reset_launches()
    banded.compute_grads(batch)
    torch.cuda.synchronize()
    assert kb.launches == {"banded_gather_sum": 6, "banded_dot": 5, "banded_gather_sum_t": 6}
    assert all(n == 0 for k, n in kb.variant_launches.items() if k.endswith("/scalar"))
    assert _nonzero(kb.tap_launches) == DGCN_STEP_TAPS
    dense.compute_grads(batch)
    worst = max(_grad_rel(banded.model, dense.model).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst


def _mmgcn_trainer(*extra, device="cuda", drop=None):
    from erc_tpu_torch.models import mmgcn

    p = mmgcn.MMGCNParams()
    p.finalize(["--dataset=synthetic-cogmen-6", f"--device={device}", "--max_seq_len=96", *extra])
    if drop is not None:
        p.drop_rate = drop
    t = mmgcn.MMGCNTrainer(p)
    t.log = lambda msg: None
    t.initialize()
    return t


@pytest.mark.parametrize("lstm_mode", ["packed", "unpacked"])
def test_mmgcn_card_equals_cpu_with_cudnn_tf32_on_and_structured_equals_dense(cuda, lstm_mode):
    """MMGCN at full width (64 GCNII layers of 200) launches none of the
    hand-written kernels; with cuDNN's TF32 flag on the card's logits equal
    the CPU's, and the structured adjacency's equal the dense one's, with the
    text LSTM packed or run over the padding."""
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.serve import InferenceEngine

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        kw = dict(dataset="synthetic-cogmen-6", batch_size=4, lstm_mode=lstm_mode)
        card = InferenceEngine.from_module("mmgcn", **kw)
        structured = InferenceEngine.from_module("mmgcn", adj_impl="structured", **kw)
        cpu = InferenceEngine.from_module("mmgcn", device="cpu", **kw)
        structured.model.load_state_dict(card.model.state_dict())
        cpu.model.load_state_dict(card.model.state_dict())
        batch = card.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=3, max_len=110))  # and a padding row
        from erc_tpu_torch.ops.kernels import dag_block as kd

        kb.reset_launches()
        kd.reset_launches()
        got = card.logits(batch)
        assert not any(kb.launches.values()) and not any(kd.launches.values())
        np.testing.assert_allclose(got, cpu.logits(batch), rtol=0, atol=1e-4)
        np.testing.assert_allclose(structured.logits(batch), got, rtol=0, atol=1e-4)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_mmgcn_remat_gradients_equal_off_with_dropout(cuda, remat):
    """Dropout 0.4 from one generator seed: checkpointed GCNII trips give the
    gradients of the run without checkpoints (the masks are drawn before each
    trip, so the recompute does not draw new ones)."""
    from erc_tpu_torch.data.loader import to_device

    off, other = _mmgcn_trainer("--gcn_remat=off"), _mmgcn_trainer(f"--gcn_remat={remat}")
    assert off.params.drop_rate == 0.4
    batch = to_device(next(iter(off.make_loader("train"))), off.device)
    off.compute_grads(batch)
    other.compute_grads(batch)
    worst = max(_grad_rel(other.model, off.model).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst


@pytest.mark.parametrize("base_model,lstm_mode", [("DialogRNN", "packed"), ("LSTM", "unpacked"), ("GRU", "packed"),
                                                  ("GRU", "unpacked"), ("None", "packed")])
def test_dgcnv2_card_equals_cpu_with_cudnn_tf32_on(cuda, base_model, lstm_mode):
    """DialogueGCN v2 at full width launches none of the hand-written
    kernels, and with cuDNN's TF32 flag on the card's logits equal the CPU's
    for every base encoder (the biGRU runs cuDNN in full float32 as the
    biLSTM does)."""
    from erc_tpu_torch.data.synthetic import synthetic_erc
    from erc_tpu_torch.ops.kernels import dag_block as kd
    from erc_tpu_torch.serve import InferenceEngine

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        kw = dict(dataset="synthetic-cogmen-6", batch_size=4, base_model=base_model, lstm_mode=lstm_mode)
        card = InferenceEngine.from_module("dgcnv2", **kw)
        cpu = InferenceEngine.from_module("dgcnv2", device="cpu", **kw)
        cpu.model.load_state_dict(card.model.state_dict())
        batch = card.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=3, max_len=110))  # and a padding row
        kb.reset_launches()
        kd.reset_launches()
        got = card.logits(batch)
        assert not any(kb.launches.values()) and not any(kd.launches.values())
        np.testing.assert_allclose(got, cpu.logits(batch), rtol=0, atol=1e-4)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _dgcnv2_trainer(daily, *extra, device="cuda"):
    from erc_tpu_torch.models import dgcnv2
    from erc_tpu_torch.ops.dropout import Dropout

    p = dgcnv2.DGCNV2DailyParams() if daily else dgcnv2.DGCNV2Params()
    p.finalize([f"--dataset=synthetic-{'daily-token-7' if daily else 'cogmen-6'}", f"--device={device}",
                "--train.batch_size=4", *extra])
    t = (dgcnv2.DGCNV2DailyTrainer if daily else dgcnv2.DGCNV2Trainer)(p)
    t.log = lambda msg: None
    t.initialize()
    for m in t.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return t


@pytest.mark.parametrize("daily,extra", [(False, ("--base_model=GRU",)), (False, ("--base_model=DialogRNN",)),
                                         (True, ())], ids=["GRU", "DialogRNN", "daily"])
def test_dgcnv2_gradients_card_equal_cpu_with_cudnn_tf32_on(cuda, daily, extra):
    """One training batch at full width and dropout 0, cuDNN's TF32 flag on:
    the gradients on the card equal the CPU's (the biGRU's and the TextCNN
    convolutions' backward run cuDNN in full float32; the embedding's
    gradient included)."""
    from erc_tpu_torch.data.loader import to_device

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card, cpu = _dgcnv2_trainer(daily, *extra), _dgcnv2_trainer(daily, *extra, device="cpu")
        host = next(iter(card.make_loader("train")))
        card.compute_grads(to_device(host, card.device))
        cpu.compute_grads(to_device(host, cpu.device))
        worst = max(_grad_rel(card.model, cpu.model).items(), key=lambda kv: kv[1])
        assert worst[1] <= 1e-4, worst
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("dataset", ["synthetic-cogmen-6", "synthetic-mosei-2"])
def test_cim_card_equals_cpu_with_cudnn_tf32_on(cuda, dataset):
    """CIM at full width launches none of the hand-written kernels, and with
    cuDNN's TF32 flag on the card's logits of both heads equal the CPU's
    (every position, the padding row's included), and so do the gradients of
    Lce + Lmulti at dropout 0 (the biGRUs run cuDNN in full float32 forward
    and backward)."""
    from erc_tpu_torch.data.loader import to_device
    from erc_tpu_torch.models import cim
    from erc_tpu_torch.ops.kernels import dag_block as kd

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        trainers = []
        for device in ("cuda", "cpu"):
            p = cim.CIMParams()
            p.finalize([f"--dataset={dataset}", f"--device={device}", "--train.batch_size=4"])
            t = cim.CIMTrainer(p)
            t.log = lambda msg: None
            t.initialize()
            t.model.drop0.p = t.model.drop1.p = 0.0
            trainers.append(t)
        card, cpu = trainers
        host = next(iter(card.make_loader("train")))
        host = {k: (None if v is None else v.copy()) for k, v in host.items()}
        host["text_length"][-1] = 0  # a padding row
        for key in ("attention_mask", "text_feature", "audio_feature", "visual_feature"):
            host[key][-1] = 0.0
        kb.reset_launches()
        kd.reset_launches()
        with torch.inference_mode():
            got = [t.float().cpu().numpy() for t in card.model.eval()(to_device(host, card.device))]
            want = [t.numpy() for t in cpu.model.eval()(to_device(host, cpu.device))]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        mets = card.compute_grads(to_device(host, card.device))
        assert not any(kb.launches.values()) and not any(kd.launches.values())
        assert ("Lmulti" in mets) == (dataset == "synthetic-mosei-2")
        cpu.compute_grads(to_device(host, cpu.device))
        worst = max(_grad_rel(card.model, cpu.model).items(), key=lambda kv: kv[1])
        assert worst[1] <= 1e-4, worst
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("module,trainer", [("mmin_base", "MMINBaseTrainer"), ("mmin_miss", "MMINMissTrainer"),
                                            ("mmin_miss2", "MMINMiss2Trainer")])
def test_mmin_card_equals_cpu_with_cudnn_tf32_on(cuda, module, trainer):
    """MMIN at full width (synthetic-mmin-4, batch 4) launches none of the
    hand-written kernels, and with cuDNN's TF32 flag on the card's raw and EMA
    eval logits equal the CPU's, and so do the gradients of each family's loss
    at dropout 0 on a Missing-augmented batch (the LSTMs and the TextCNN's
    convolutions run cuDNN in full float32 forward and backward)."""
    import importlib

    from erc_tpu_torch.data.loader import to_device
    from erc_tpu_torch.ops.dropout import Dropout
    from erc_tpu_torch.ops.kernels import dag_block as kd

    mod = importlib.import_module(f"erc_tpu_torch.models.{module}")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        trainers = []
        for device in ("cuda", "cpu"):
            p = mod.ParamsType()
            p.finalize(["--dataset=synthetic-mmin-4", f"--device={device}", "--train.batch_size=4"])
            t = getattr(mod, trainer)(p)
            t.log = lambda msg: None
            t.initialize()
            for m in t.model.modules():
                if isinstance(m, Dropout):
                    m.p = 0.0
            trainers.append(t)
        card, cpu = trainers
        host = next(iter(card.make_loader("train")))
        assert ("audio_feature_reverse" in host) == (module != "mmin_base")
        kb.reset_launches()
        kd.reset_launches()
        with torch.inference_mode():
            got = card.to_logits(to_device(host, card.device))
            want = cpu.to_logits(to_device(host, cpu.device))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(g.float().cpu().numpy(), w.numpy(), rtol=0, atol=1e-4)
        card.compute_grads(to_device(host, card.device))
        assert not any(kb.launches.values()) and not any(kd.launches.values())
        cpu.compute_grads(to_device(host, cpu.device))
        worst = max(_grad_rel(card.model, cpu.model).items(), key=lambda kv: kv[1])
        assert worst[1] <= 1e-4, worst
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ------------------------------------------------------------------ the captured eval step
def _bucketed_batches(engine):
    """Batches of 3 dialogues (and a padding row) in three length buckets."""
    from erc_tpu_torch.data.synthetic import synthetic_erc

    return [engine.batcher(synthetic_erc("iemocap-cogmen", 6, n_train=3, min_len=hi - 10, max_len=hi, seed=i))
            for i, hi in enumerate((14, 40, 100))]


def _counted(fn, *args):
    """fn(*args), and the launch counts of the kernel wrappers it moved."""
    from erc_tpu_torch.ops.kernels import dag_block as kd

    kb.reset_launches()
    kd.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {**kb.launches, **kb.tap_launches, **kd.launches}


def _traced_kernels(fn) -> dict:
    """K1, K2 and K3 as a device trace of fn() counts their executions."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {name: sum(kernel in n for n in names) for name, kernel in (
        ("banded_gather_sum", "banded_gather_sum_kernel"), ("banded_dot", "banded_dot_kernel"),
        ("dag_block", "dag_block_cluster_kernel"))}


@pytest.mark.parametrize("module,kw", [("cogmen", dict(graph_impl="banded", encoder_mode="chained")),
                                       ("dagerc", {}), ("dgcn", dict(graph_impl="banded")), ("cim", {})],
                         ids=["cogmen", "dagerc", "dgcn", "cim"])
def test_engine_replay_equals_eager_and_counts_the_same_launches(cuda, module, kw):
    """The engine's captured forward ≡ the eager one (``cuda_graphs=False``)
    bit for bit in three length buckets, one graph and one replay each; a
    bucket's first batch counts its eager warm-up and its replay, and a
    replayed forward counts the launches the eager one makes, which a device
    trace of the replay finds; the graphs' static inputs are the keys the
    model reads, without the raw modality features, the labels or the
    speaker tensor (for COGMEN, DAG-ERC and DialogueGCN)."""
    from erc_tpu_torch.serve import InferenceEngine

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        graphs = InferenceEngine.from_module(module, dataset="synthetic-cogmen-6", batch_size=4, **kw)
        eager = InferenceEngine.from_module(module, dataset="synthetic-cogmen-6", batch_size=4, cuda_graphs=False,
                                            **kw)
        eager.model.load_state_dict(graphs.model.state_dict())
        batches = _bucketed_batches(graphs)
        for batch in batches:
            _, first = _counted(graphs.logits, batch)
            _, once = _counted(eager.logits, batch)
            assert first == {k: 2 * n for k, n in once.items()}
        assert graphs.captured.captures == 3 and graphs.captured.replays == 3
        for batch in batches:
            replayed, counts = _counted(graphs.logits, batch)
            out, eager_counts = _counted(eager.logits, batch)
            assert counts == eager_counts
            assert np.array_equal(replayed, out)
        traced = _traced_kernels(lambda: graphs.logits(batches[-1]))
        assert traced == {k: counts[k] for k in traced}
        assert graphs.captured.captures == 3 and graphs.captured.replays == 7
        if module != "cim":
            read = {"input_tensor", "text_length", "speaker_ids"}
            assert read <= graphs.captured.keys <= read | {"attention_mask"}
            assert any(traced.values())
        staged = {k for bucket in graphs.captured._buckets.values() for k in bucket.staging}
        assert staged == graphs.captured.keys
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _two_bucket_batches(trainer, lengths=((10, 20), (30, 40)), B=4):
    """Host batches in two shape buckets: B dialogues of each length range, padded to the batch's L."""
    from erc_tpu_torch.data.synthetic import synthetic_erc

    batcher = trainer.batcher(B)
    return [batcher(synthetic_erc("iemocap-cogmen", 6, n_train=B, min_len=lo, max_len=hi, seed=i))
            for i, (lo, hi) in enumerate(lengths)]


def _steps(trainer, batches, replayed):
    """Steps on host batches, replayed or eager, the LR halved in place after the first; the losses, gnorms,
    and every tensor the captured step reads or writes, and the generator state, after them."""
    trainer.train_graphs = replayed
    out = []
    for i, b in enumerate(batches):
        if i == 1:
            trainer.optimizer.param_groups[0]["lr"].mul_(0.5)
        m = trainer.train_batch(b)
        out += [m["Lall"].clone(), m["gnorm"].clone()]
    trainer.train_graphs = True
    torch.cuda.synchronize()
    return out + [t.detach().clone() for t in trainer._step_tensors()] + [trainer._dropout_rng.get_state()]


@pytest.mark.parametrize("module", ["cogmen", "dagerc"])
def test_train_step_replay_equals_eager_over_buckets_and_an_lr_change(cuda, module):
    """COGMEN banded (K1, K2, K1ᵀ) and DAG-ERC's kernel form (K3, K4) at
    their dropout: 3 replayed steps over two shape buckets, with the LR tensor
    changed in place between, ≡ 3 eager steps from the same state bit for bit
    (losses, gnorm, parameters, gradients, optimizer state, LR, generator
    state), one capture a bucket and one replay a step."""
    trainer = _cogmen_trainer("banded") if module == "cogmen" else _trainers()[0][0]
    a, b = _two_bucket_batches(trainer)
    trainer.train_batch(a)
    trainer.train_batch(b)
    graphs = trainer.captured_step
    assert graphs.captures == 2 and graphs.replays == 0
    torch.cuda.synchronize()
    saved = [t.detach().clone() for t in trainer._step_tensors()], trainer._dropout_rng.get_state()

    def restore():
        with torch.no_grad():
            torch._foreach_copy_(trainer._step_tensors(), saved[0])
        trainer._dropout_rng.set_state(saved[1])

    eager = _steps(trainer, [a, b, a], replayed=False)
    restore()
    replayed = _steps(trainer, [a, b, a], replayed=True)
    assert graphs.captures == 2 and graphs.replays == 3
    assert len(eager) == len(replayed)
    for i, (x, y) in enumerate(zip(eager, replayed)):
        assert torch.equal(x, y), i


def test_load_state_tree_drops_the_captured_step(cuda):
    """``load_state_tree`` (``--resume``) drops the captured step's graphs;
    the next batch captures again, its LR a tensor on the card; a parameter
    replaced behind the trainer's back makes the next replay raise."""
    t = _dgcn_trainer("banded")
    a, b = _two_bucket_batches(t)
    t.train_batch(a)
    t.train_batch(b)
    t.train_batch(a)
    assert t.captured_step.captures == 2 and t.captured_step.replays == 1
    tree = t.state_tree()
    t.load_state_tree(tree)
    assert not t.captured_step._buckets
    lr = t.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.is_cuda and t.optimizer.param_groups[0]["capturable"]
    t.train_batch(a)
    t.train_batch(a)
    assert t.captured_step.captures == 3 and t.captured_step.replays == 2
    with torch.no_grad():
        t.model.clf_lin2.weight = torch.nn.Parameter(t.model.clf_lin2.weight.clone())
    with pytest.raises(RuntimeError, match="replaced"):
        t.train_batch(a)


def test_no_collection_runs_while_a_step_is_captured(cuda):
    """A trainer dropped in a reference cycle holds captured graphs, which
    only the cyclic collector frees; freed while another trainer's step is
    captured, they break that capture (CUDA refuses to destroy a graph while
    a stream captures).  With the collector made to run at every allocation,
    none runs during a capture, and the next trainer captures and replays."""
    old = _dgcn_trainer("banded")
    a, _ = _two_bucket_batches(old)
    old.train_batch(a)
    assert old.captured_step.captures == 1
    old.cycle = old
    del old
    t = _dgcn_trainer("banded")
    seen = []

    def on_collect(phase, info):
        if phase == "start":
            seen.append(torch.cuda.is_current_stream_capturing())

    threshold = gc.get_threshold()
    gc.callbacks.append(on_collect)
    gc.set_threshold(1, 1, 1)
    try:
        t.train_batch(a)
        t.train_batch(a)
    finally:
        gc.callbacks.remove(on_collect)
        gc.set_threshold(*threshold)
    gc.collect()
    torch.cuda.synchronize()
    assert t.captured_step.captures == 1 and t.captured_step.replays == 1
    assert seen and not any(seen)


def test_trainer_test_stage_replays_and_load_state_tree_drops_the_graphs(cuda):
    """DialogueGCN's test stage replays one graph a batch and gives the eager
    stage's record; ``load_state_tree`` drops the graphs, and a parameter
    replaced behind the trainer's back makes the next replay raise."""
    t = _dgcn_trainer("banded")
    t.params.batch_count = 1
    n_test = len(list(t.make_loader("test")))
    replayed = t.test()
    assert t.captured.replays == n_test and t.captured.captures >= 1
    t.eval_graphs = False
    eager = t.test()
    t.eval_graphs = True
    assert replayed.keys() == eager.keys()
    for k in replayed:
        assert np.array_equal(np.asarray(replayed[k]), np.asarray(eager[k])), k
    t.load_state_tree(t.state_tree())
    assert not t.captured._buckets
    t.test()
    assert t.captured.replays == 2 * n_test
    with torch.no_grad():
        t.model.clf_lin2.weight = torch.nn.Parameter(t.model.clf_lin2.weight.clone())
    with pytest.raises(RuntimeError, match="replaced"):
        t.test()


@pytest.mark.parametrize("module", ["cogmen", "dgcn"])
def test_bf16_train_step_replay_equals_eager_and_stages_bf16(cuda, module):
    """--compute_dtype=bfloat16 with --transfer_dtype=bfloat16 (COGMEN's dense
    graph; DialogueGCN's dense graph, its biLSTM a bfloat16 cuDNN call): 3
    replayed steps over two buckets, the LR changed in place between, ≡ 3
    eager steps bit for bit; the masters stay float32 and every floating
    staging buffer is bfloat16."""
    from erc_tpu_torch.models import cogmen, dgcn

    mod, name = {"cogmen": (cogmen, "COGMEN"), "dgcn": (dgcn, "DGCN")}[module]
    p = getattr(mod, f"{name}Params")()
    p.finalize(["--dataset=synthetic-cogmen-6", "--graph_impl=dense", "--device=cuda", "--max_seq_len=96",
                "--compute_dtype=bfloat16", "--transfer_dtype=bfloat16"])
    trainer = getattr(mod, f"{name}Trainer")(p)
    trainer.log = lambda msg: None
    trainer.initialize()
    a, b = _two_bucket_batches(trainer)
    trainer.train_batch(a)
    trainer.train_batch(b)
    graphs = trainer.captured_step
    torch.cuda.synchronize()
    saved = [t.detach().clone() for t in trainer._step_tensors()], trainer._dropout_rng.get_state()
    eager = _steps(trainer, [a, b, a], replayed=False)
    with torch.no_grad():
        torch._foreach_copy_(trainer._step_tensors(), saved[0])
    trainer._dropout_rng.set_state(saved[1])
    replayed = _steps(trainer, [a, b, a], replayed=True)
    assert graphs.captures == 2 and graphs.replays == 3
    for i, (x, y) in enumerate(zip(eager, replayed)):
        assert torch.equal(x, y), i
    assert all(t.dtype == torch.float32 for t in trainer.model.parameters())
    staged = [t for bucket in graphs._buckets.values() for t in bucket.staging.values() if t.is_floating_point()]
    assert staged and all(t.dtype == torch.bfloat16 for t in staged)


# ------------------------------------------------------------ K steps a replay
def _group(trainer, k=4, B=4):
    """k host batches of one shape bucket (lengths 10..20, padded to the bucket's L) and their stacked group."""
    from erc_tpu_torch.data.loader import StackedGroup
    from erc_tpu_torch.data.synthetic import synthetic_erc

    batcher = trainer.batcher(B)
    batches = [batcher(synthetic_erc("iemocap-cogmen", 6, n_train=B, min_len=10, max_len=20, seed=10 + i))
               for i in range(k)]
    return batches, StackedGroup(batches)


def _all_counts():
    from erc_tpu_torch.ops.kernels import dag_block as kd

    torch.cuda.synchronize()
    return {**kb.launches, **kd.launches}


@pytest.mark.parametrize("module", ["cogmen", "dagerc", "cogmen-lars-cos"])
def test_k_step_replay_equals_k_eager_steps(cuda, module):
    """steps_per_call = 4: one replay of the group's graph ≡ 4 eager steps
    from the same state bit for bit (each step's losses and gnorm, every
    tensor the captured step reads or writes, the generator), its launch
    counts 4 x one step's (COGMEN banded: K1/K2/K1ᵀ; DAG-ERC's kernel form:
    K3/K4); under lars and a Cos schedule too, whose count advances by 4."""
    from erc_tpu_torch.data.loader import to_device

    if module == "dagerc":
        trainer = _trainers()[0][0]
    elif module == "cogmen":
        trainer = _cogmen_trainer("banded")
    else:
        trainer = _cogmen_trainer("dense", sche=["--optim.name=lars", "--optim.sche.name=Cos",
                                                 "--optim.sche.start=0.01", "--optim.sche.end=0.001",
                                                 "--optim.sche.right=40"])
    batches, stacked = _group(trainer)
    graphs = trainer.captured_step
    trainer.train_group(stacked, 4)  # 4 eager steps, then the capture
    assert graphs.captures == 1 and trainer.global_steps == 4
    torch.cuda.synchronize()
    saved = [t.detach().clone() for t in trainer._step_tensors()], trainer._dropout_rng.get_state()

    def state():
        torch.cuda.synchronize()
        return [t.detach().clone() for t in trainer._step_tensors()] + [trainer._dropout_rng.get_state()]

    counts, eager = [], []
    for b in batches:
        before = _all_counts()
        m = trainer.train_step(to_device(b, trainer.device))
        counts.append({k: v - before[k] for k, v in _all_counts().items() if v != before[k]})
        eager += [m["Lall"].clone(), m["gnorm"].clone()]
    eager += state()
    with torch.no_grad():
        torch._foreach_copy_(trainer._step_tensors(), saved[0])
    trainer._dropout_rng.set_state(saved[1])
    before = _all_counts()
    mets = graphs.group(stacked, 4)
    moved = {k: v - before[k] for k, v in _all_counts().items() if v != before[k]}
    replayed = [x for i in range(4) for x in (mets["Lall"][i].clone(), mets["gnorm"][i].clone())] + state()
    assert graphs.captures == 1 and graphs.replays == 1
    assert all(c == counts[0] for c in counts) and moved == {k: 4 * v for k, v in counts[0].items()}
    if module != "cogmen-lars-cos":
        assert moved, "no kernel launched"
    assert len(eager) == len(replayed)
    for i, (x, y) in enumerate(zip(eager, replayed)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("module", ["cogmen", "dagerc"])
def test_k_eval_replay_equals_single_batches(cuda, module):
    """eval_steps_per_call = 4: the group's outputs, stacked, ≡ each batch's
    replayed eval forward bit for bit, with 4 x one batch's launches."""
    trainer = _trainers()[0][0] if module == "dagerc" else _cogmen_trainer("banded")
    trainer.model.eval()
    batches, stacked = _group(trainer)
    singles = [trainer.captured(b) for b in batches]
    before = _all_counts()
    trainer.captured(batches[0])
    one = {k: v - before[k] for k, v in _all_counts().items() if v != before[k]}
    group = trainer.captured.group(stacked, 4)
    before = _all_counts()
    group = trainer.captured.group(stacked, 4)
    moved = {k: v - before[k] for k, v in _all_counts().items() if v != before[k]}
    assert group.shape[0] == 4 and moved == {k: 4 * v for k, v in one.items()} and moved
    for i, s in enumerate(singles):
        np.testing.assert_array_equal(group[i], s)


def test_device_memory_stats_on_the_card(cuda):
    """The caching allocator's counters under the JAX function's keys: numbers,
    not None, in use no more than the peak and below the card's memory."""
    from erc_tpu_torch.core import memstat

    x = torch.empty(1 << 20, device=cuda)
    stats = memstat.device_memory_stats(cuda)
    assert stats is not None and stats["bytes_in_use"] >= x.numel() * 4
    assert stats["bytes_in_use"] <= stats["peak_bytes_in_use"] < stats["bytes_limit"] <= \
        torch.cuda.get_device_properties(cuda).total_memory
    assert stats["largest_alloc_size"] >= x.numel() * 4 and "MiB" in memstat.memory_report()


def test_profiled_captured_step_trace_holds_the_band_kernels(cuda, tmp_path, monkeypatch):
    """--profile_steps=3 over COGMEN banded training: the bucket's eager first
    step, its capture and two replays in the window; the Chrome trace holds
    K1, K2 and K1ᵀ as many times as the launch counts moved over it."""
    import json

    from erc_tpu_torch.train import callbacks as cbs

    monkeypatch.setenv("ERC_TPU_EXPROOT", str(tmp_path))
    trainer = _cogmen_trainer("banded", sche=("--profile_steps=3", "--batch_count=4", "--length_bucket=96",
                                              "--epoch=1", "--eval_per_epoch=0"))
    seen = {}

    class Window(cbs.Callback):
        def train_begin(self, tr):
            seen["before"] = _all_counts()

        def train_step_end(self, tr, bidx, mets):
            if tr.global_steps == 3:
                seen["after"] = _all_counts()

    Window().hook(trainer)
    trainer.train()
    assert trainer.captured_step.replays == 3
    trace = json.load(open(tmp_path / "blob" / trainer.exp.exp_name / trainer.exp.test_name / "profile" /
                           "trace.pt.trace.json"))
    names = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    moved = {k: seen["after"][k] - seen["before"][k] for k in ("banded_gather_sum", "banded_dot",
                                                               "banded_gather_sum_t")}
    traced = {"banded_gather_sum": sum("banded_gather_sum_kernel<" in n and "true>" not in n for n in names),
              "banded_dot": sum("banded_dot_kernel<" in n for n in names),
              "banded_gather_sum_t": sum("banded_gather_sum_kernel<" in n and "true>" in n for n in names)}
    assert traced == moved and all(moved.values()), (traced, moved)


def test_replayed_steps_spans_precede_their_kernels_and_lie_on_their_ranges(cuda, tmp_path):
    """Replayed DAG-ERC steps (the kernel form) under ``train.profiler.trace``:
    each ``erc.step.launch`` range starts before its replay's first kernel
    (the replays' kernels taken in turn, as many a replay), and each span of
    the in-memory record, mapped onto the trace's clock by a span on both
    (the first step's: its range's start less its host start), lies within
    50 us of its ``erc.*`` range at both ends."""
    import json
    import time

    from erc_tpu_torch.core import tracing
    from erc_tpu_torch.train import profiler

    trainer = _trainers()[0][0]
    batch = _two_bucket_batches(trainer)[0]
    trainer.train_batch(batch)  # the bucket's eager step and its capture
    trainer.train_batch(batch)
    torch.cuda.synchronize()
    replays = 4
    t0 = time.perf_counter()
    with profiler.trace(str(tmp_path)):
        for _ in range(replays):
            trainer.train_batch(batch)
    events = json.load(open(tmp_path / profiler.TRACE_FILE))["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(tracing.PREFIX):
            ranges.setdefault(e["name"][len(tracing.PREFIX):], []).append((e["ts"], e["ts"] + e["dur"]))
    kernels = sorted(e["ts"] for e in events if e.get("cat") == "kernel")
    assert kernels and len(kernels) % replays == 0, len(kernels)
    launches = sorted(ranges["step.launch"])
    assert len(launches) == replays
    for i, (start, _) in enumerate(launches):
        assert start < kernels[i * len(kernels) // replays], i

    recorded = {}
    for sp in tracing.spans(t0):
        recorded.setdefault(sp.name, []).append(sp)
    assert {n: len(v) for n, v in recorded.items()} == {n: replays for n in (
        "step", "step.wait", "step.stage", "step.launch")}
    assert [sp.step for sp in recorded["step"]] == list(range(2, 2 + replays))
    # the first range that the profiler records opens late: a later one is the anchor
    offset = min(ranges["step"])[0] - 1e6 * min(sp.start for sp in recorded["step"])
    for name, spans in recorded.items():
        mapped = sorted((1e6 * sp.start + offset, 1e6 * sp.end + offset) for sp in spans)
        for (a, b), (lo, hi) in zip(mapped, sorted(ranges[name])):
            assert abs(a - lo) <= 50 and abs(b - hi) <= 50, (name, a - lo, b - hi)


# ------------------------------------------------------------------ feature extraction
@pytest.fixture
def tf32_allowed(cuda):
    """TF32 allowed for float32 in cuBLAS and cuDNN's convolutions: the extractors must override it."""
    backends = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    before = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "tf32"
    yield
    assert [b.fp32_precision for b in backends] == ["tf32", "tf32"]  # nothing the extractors set leaked
    for b, v in zip(backends, before):
        b.fp32_precision = v


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("feature", ["fbank", "mfcc", "stft"])
def test_acoustic_card_equals_cpu(cuda, tf32_allowed, feature):
    from chip_smoke import _float64_features
    from erc_tpu_torch.preprocess import acoustic as ac

    sig = np.clip(np.random.default_rng(0).normal(size=(2, 16000)) * 0.1, -1, 1).astype(np.float32)
    fn = {"fbank": ac.wav_to_fb, "mfcc": ac.wav_to_mfcc, "stft": ac.wav_to_stft}[feature]
    got = fn(sig).cpu().numpy()
    want = fn(sig, device="cpu").numpy()
    if feature == "stft":
        assert _rel(got, want) <= 1e-4
        return
    own = max(float(np.abs(want[b] - _float64_features(sig[b], feature)).max()) for b in range(2))
    assert float(np.abs(got - want).max()) <= 1e-4 + 2 * own


def test_video_extractors_card_equal_cpu(cuda, tf32_allowed):
    from erc_tpu_torch.preprocess import video
    from erc_tpu_torch.preprocess.tsm import TSMRecognizer
    from erc_tpu_torch.preprocess.x3d import X3D

    rng = np.random.default_rng(1)
    clips = rng.integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8)
    card, cpu = (video.TSNExtractor(n_segments=2, crop_size=32, seed=2, device=d) for d in ("cuda", "cpu"))
    assert _rel(card.extract_batch(clips), cpu.extract_batch(clips)) <= 1e-4
    frames = rng.integers(0, 256, (6, 48, 64, 3), dtype=np.uint8)
    assert _rel(card.extract(frames), cpu.extract(frames)) <= 1e-4
    small = dict(gamma_w=0.5, gamma_b=2.0, gamma_d=0.2, base_channels=16, stage_blocks=(1, 1, 1, 1))
    card, cpu = (video.X3DExtractor(n_frames=4, crop_size=16, model=X3D(**small), seed=3, device=d)
                 for d in ("cuda", "cpu"))
    clips = rng.integers(0, 256, (2, 4, 16, 16, 3), dtype=np.uint8)
    assert _rel(card.extract_batch(clips), cpu.extract_batch(clips)) <= 1e-4
    from erc_tpu_torch.preprocess import full_fp32

    model = video.init_weights(TSMRecognizer(5, 2), torch.Generator().manual_seed(4)).eval()
    x = torch.from_numpy(rng.normal(size=(2, 2, 3, 32, 32)).astype(np.float32))
    with torch.inference_mode(), full_fp32():
        want = model(x).numpy()
        got = model.cuda()(x.cuda()).cpu().numpy()
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("mode", ["sbert", "robert"])
def test_text_encoder_card_equals_cpu(cuda, tf32_allowed, monkeypatch, mode):
    import copy

    import chip_smoke
    from erc_tpu_torch.preprocess.lexical import TextEncoder

    monkeypatch.setitem(chip_smoke.TEXT_WIDTHS, "vocab", 1000)
    monkeypatch.setitem(chip_smoke.TEXT_WIDTHS, "layers", 2)
    model = chip_smoke._stand_in_encoder(5)
    sentences = [" ".join(f"w{i * j % 97}" for j in range(3 + i % 40)) for i in range(10)]
    kw = dict(mode=mode, max_tokens=32, batch_size=4)
    want = TextEncoder(copy.deepcopy(model), chip_smoke._StandInTokenizer(), device="cpu", **kw).encode(sentences)
    got = TextEncoder(model, chip_smoke._StandInTokenizer(), device="cuda", **kw).encode(sentences)
    assert got.shape == (10, 768) and _rel(got, want) <= 1e-4


# ------------------------------------------------------------------ the extras
INTEGER_OPS = {"autocontrast", "equalize", "identity", "posterize", "rotate", "shear_x", "shear_y", "solarize",
               "translate_x", "translate_y"}


def _zero_launches():
    from erc_tpu_torch.ops.kernels import dag_block as kd

    kb.reset_launches()
    kd.reset_launches()
    return lambda: {**kb.launches, **kd.launches}


def test_randaugment_card_equals_cpu(cuda):
    from erc_tpu_torch import augment_image as aug

    launches = _zero_launches()
    g = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (32, 32, 32, 3), generator=g, dtype=torch.uint8)
    u = torch.rand(32, generator=g)
    for op, lo, hi in aug.AUGMENT_LIST:
        v = lo + (hi - lo) * u
        d = (op(imgs.cuda(), v.cuda()).cpu().int() - op(imgs, v).int()).abs()
        if op.__name__ in INTEGER_OPS:
            assert int(d.max()) == 0, op.__name__
        else:
            assert float((d == 0).float().mean()) >= 0.999 and int(d.max()) <= 1, op.__name__
    cut = [torch.rand(32, generator=g) * 0.5, torch.rand(32, generator=g), torch.rand(32, generator=g)]
    assert torch.equal(aug.cutout_apply(imgs.cuda(), *(c.cuda() for c in cut)).cpu(), aug.cutout_apply(imgs, *cut))
    draws = aug.randaugment_draw(32, 2, generator=g)
    d = (aug.randaugment_apply(imgs.cuda(), {k: v.cuda() for k, v in draws.items()}).cpu().int()
         - aug.randaugment_apply(imgs, draws).int()).abs()
    assert float((d == 0).float().mean()) >= 0.999 and int(d.max()) <= 1
    out = aug.randaugment(imgs.cuda(), 2, generator=torch.Generator(device="cuda").manual_seed(0))
    assert out.is_cuda and out.dtype == torch.uint8 and out.shape == imgs.shape
    assert not any(launches().values())


@pytest.mark.parametrize("name", ["wideresnet_28_2", "resnet18"])
def test_image_backbone_card_equals_cpu(cuda, tf32_allowed, name):
    """Float32 features and running statistics; the gradients in float64 on both sides (in float32 the batch
    norms' gradients are ill-conditioned, the CPU's own against float64 up to 7e-3 of their norms)."""
    from erc_tpu_torch.models import image_backbones as ib

    launches = _zero_launches()
    cpu = getattr(ib, name)(generator=torch.Generator().manual_seed(1))
    card = getattr(ib, name)().cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(8, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want, got = cpu.eval()(x), card.eval()(x.cuda()).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())

    def train_pass(m, inp):
        m.train()
        m.zero_grad(set_to_none=True)
        with torch.enable_grad():
            f = m(inp)
            (f ** 2).mean().backward()
        return (f.detach().cpu(), {k: v.cpu() for k, v in m.state_dict().items()},
                {k: p.grad.cpu() for k, p in m.named_parameters()})

    (f_cpu, st_cpu, _), (f_card, st_card, _) = train_pass(cpu, x), train_pass(card, x.cuda())
    assert float((f_card - f_cpu).abs().max()) <= 1e-4 * float(f_cpu.abs().max())
    for k, v in st_cpu.items():
        if k.endswith(("running_mean", "running_var")):
            assert float((st_card[k] - v).abs().max()) <= 1e-5 * max(1.0, float(v.abs().max())), k
    state = cpu.state_dict()
    for m in (cpu, card):
        m.double().load_state_dict(state)
    g_cpu, g_card = train_pass(cpu, x.double())[2], train_pass(card, x.double().cuda())[2]
    for k, v in g_cpu.items():
        assert float((g_card[k] - v).abs().max()) <= 1e-4 * float(v.norm()), k
    assert not any(launches().values())


def test_backbone_convolution_backward_in_full_float32(cuda, tf32_allowed):
    """A backbone convolution's float32 input and weight gradients with TF32 allowed: the backward's guard."""
    from erc_tpu_torch.models import image_backbones as ib

    cpu = ib.Conv2d(32, 32, 3, generator=torch.Generator().manual_seed(3))
    card = ib.Conv2d(32, 32, 3).cuda()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    x, w = torch.randn(16, 32, 16, 16, generator=g), torch.randn(16, 32, 16, 16, generator=g)
    grads = []
    for m, xx, ww in ((cpu, x, w), (card, x.cuda(), w.cuda())):
        xx = xx.clone().requires_grad_(True)
        with torch.enable_grad():
            (m(xx) * ww).sum().backward()
        grads.append((xx.grad.cpu(), m.weight.grad.cpu()))
    for a, b in zip(*grads):
        assert float((b - a).abs().max()) <= 1e-5 * float(a.abs().max())


def test_fusion_and_contrib_card_equal_cpu(cuda):
    from erc_tpu_torch import contrib
    from erc_tpu_torch.ops import fusion

    launches = _zero_launches()
    g = torch.Generator().manual_seed(3)
    M, x, mask = torch.randn(4, 9, 16, generator=g), torch.randn(4, 16, generator=g), torch.ones(4, 9)
    mask[0, 5:] = 0

    def same(mod, *args, tol=1e-5):
        mod.eval()
        with torch.no_grad():
            want = mod(*args)
            got = mod.cuda()(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in args))
        for w, c in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
            assert float((c.cpu() - w).abs().max()) <= tol * max(1.0, float(w.abs().max()))

    same(fusion.SimpleAttention(16, generator=g), M, mask)
    for att in ("dot", "general", "general2", "concat"):
        same(fusion.MatchingAttention(16, 16, 8, att, generator=g), M, x, mask)
    for modals in ("atv", "av", "at", "vt"):
        same(fusion.MMGatedAttention(16, 8, modals=modals, generator=g), M[:, 0], M[:, 1], M[:, 2], modals)
    logits, labels = torch.randn(4, 9, 5, generator=g), torch.randint(0, 5, (4, 9), generator=g)
    imgs, y = torch.randn(6, 8, 8, 3, generator=g), contrib.onehot(torch.randint(0, 3, (6,), generator=g), 3)
    perm, lam = contrib.mixup_draw(6, 0.75, g)
    cdraw = contrib.cutmix_draw(6, 8, 8, 1.0, g)
    for fn in (lambda d: (contrib.ce_loss(d(logits), d(labels), d(mask)),),
               lambda d: (contrib.kl_loss(d(logits), d(logits.flip(0))),),
               lambda d: (contrib.contrastive_loss(d(M[:, 0]), d(M[:, 1])),),
               lambda d: contrib.mixup_apply(d(imgs), d(y), d(perm), d(lam)),
               lambda d: contrib.cutmix_apply(d(imgs), d(y), *(d(t) for t in cdraw))):
        for w, c in zip(fn(lambda t: t), fn(lambda t: t.cuda())):
            assert float((c.cpu() - w).abs().max()) <= 1e-6 * max(1.0, float(w.abs().max()))
    assert not any(launches().values())
