"""The port's video backbones and extractors (``erc_tpu_torch/preprocess/
video.py``, ``tsm.py``, ``x3d.py``) held against the JAX package's on the
CPU, at full ResNet-50 widths with a 32-pixel crop and X3D at the small
configuration of the JAX package's own tests.

Weights: the JAX modules' variables drawn with numpy from their
``jax.eval_shape`` shapes (BN statistics and scales away from 0 and 1),
carried to the port by ``erc_tpu_torch.convert``, or an mmaction-named
``state_dict`` read by both packages' checkpoint paths.  JAX runs at
``matmul_precision="highest"``, each module jitted once per module-scoped
fixture.  Tolerances: ``temporal_shift`` and the frame preprocessing
exactly; features and logits 1e-4 of max |JAX's| (float32: only the
convolutions' summation order differs).
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erc_tpu.preprocess import tsm as jtsm
from erc_tpu.preprocess import video as jvideo
from erc_tpu.preprocess import x3d as jx3d
from erc_tpu_torch import convert
from erc_tpu_torch.preprocess import tsm as ttsm
from erc_tpu_torch.preprocess import video as tvideo
from erc_tpu_torch.preprocess import x3d as tx3d

CROP, NSEG = 32, 2
SMALL_X3D = dict(gamma_w=0.5, gamma_b=2.0, gamma_d=0.2, base_channels=16, stage_blocks=(1, 1, 1, 1))
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _highest_precision_one_torch_thread():
    """JAX at "highest"; torch on one intra-op thread for the module (restored
    after): under the test run's parallel workers torch's own threads only
    contend with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_num_threads(n)


def _draw(model, x, seed):
    """flax variables of ``model`` for input ``x``, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _jax_tsm(**kw):
    """(the JAX TSMRecognizer, its jitted eval apply): one compile per head setting."""
    jm = jtsm.TSMRecognizer(**kw)
    return jm, jax.jit(lambda v, x: jm.apply(v, x, train=False))


def _same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.fixture(scope="module")
def tsn():
    """(JAX TSNExtractor, port TSNExtractor) with the same ResNet-50 weights."""
    v = _draw(jvideo.ResNet50(), np.zeros((1, CROP, CROP, 3), np.float32), 0)
    jex = jvideo.TSNExtractor(v, n_segments=NSEG, crop_size=CROP)
    tex = tvideo.TSNExtractor(convert.resnet50_state(v["params"], v["batch_stats"]), n_segments=NSEG,
                              crop_size=CROP, device="cpu")
    return jex, tex


@pytest.fixture(scope="module")
def x3d():
    model = jx3d.X3D(**SMALL_X3D)
    v = _draw(model, np.zeros((1, 4, 16, 16, 3), np.float32), 1)
    jex = jvideo.X3DExtractor(v, n_frames=4, crop_size=16, model=model)
    tex = tvideo.X3DExtractor(convert.x3d_state(v["params"], v["batch_stats"]), n_frames=4, crop_size=16,
                              model=tx3d.X3D(**SMALL_X3D), device="cpu")
    return jex, tex


@pytest.mark.parametrize("n_seg,n_div,c", [(4, 8, 16), (3, 8, 17), (2, 4, 8), (1, 8, 64)])
def test_temporal_shift_equals_jax(n_seg, n_div, c):
    x = np.random.default_rng(0).normal(size=(2 * n_seg, c, 3, 5)).astype(np.float32)
    want = np.asarray(jvideo.temporal_shift(jnp.asarray(x.transpose(0, 2, 3, 1)), n_seg, n_div)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(tvideo.temporal_shift(torch.from_numpy(x), n_seg, n_div).numpy(), want)


def test_resnet50_equals_jax(tsn):
    """2 clips × 2 segments through the unshifted backbone."""
    jex, tex = tsn
    x = np.random.default_rng(2).normal(size=(2 * NSEG, CROP, CROP, 3)).astype(np.float32)
    want = np.asarray(jex._fwd(jex.variables, x))
    with torch.no_grad():
        got = tex.model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (4, 2048)
    _close(got, want)


def test_shifted_resnet50_equals_jax():
    model = jvideo.ResNet50(n_segment=NSEG)
    x = np.random.default_rng(3).normal(size=(2 * NSEG, CROP, CROP, 3)).astype(np.float32)
    v = _draw(model, x, 4)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(v, x))
    port = tvideo.ResNet50(n_segment=NSEG).eval()
    port.load_state_dict(convert.resnet50_state(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        unshifted = tvideo.ResNet50().eval()
        unshifted.load_state_dict(port.state_dict())
        other = unshifted(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    _close(got, want)
    assert np.abs(other - got).max() > 1e-2 * np.abs(got).max()  # the shift takes effect


@pytest.mark.parametrize("consensus,before_softmax", [("avg", True), ("avg", False), ("identity", True)])
def test_tsm_recognizer_equals_jax(consensus, before_softmax):
    kw = dict(num_class=5, n_segment=NSEG, consensus=consensus, before_softmax=before_softmax)
    jm, apply = _jax_tsm(**kw)
    x = np.random.default_rng(5).normal(size=(2, NSEG, CROP, CROP, 3)).astype(np.float32)
    v = _draw(jm, x, 6)
    want = np.asarray(apply(v, x))
    port = ttsm.TSMRecognizer(**kw).eval()
    port.load_state_dict(convert.tsm_state(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).numpy()
    _close(got, want)
    with pytest.raises(ValueError, match="avg consensus"):
        ttsm.TSMRecognizer(5, NSEG, consensus="identity", before_softmax=False).eval()(torch.zeros(1, NSEG, 3, 8, 8))


def test_x3d_equals_jax(x3d):
    jex, tex = x3d
    x = np.random.default_rng(7).normal(size=(2, 4, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jex._fwd(jex.variables, x))
    with torch.no_grad():
        got = tex.model(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).numpy()
    assert got.shape == (2, tex.model.feat_dim) == (2, 128)
    _close(got, want)


def test_x3d_m_arithmetic_equals_jax():
    """X3D-M's blocks [3, 5, 11, 7], feature 432, depthwise and SE widths:
    every parameter's shape against the JAX module's (no forward)."""
    port = tx3d.X3D()
    assert port.blocks == [3, 5, 11, 7] and port.feat_dim == jx3d.X3D().feat_dim == 432
    assert tx3d._round_width(24, 1.0) == jx3d._round_width(24, 1.0) == 24
    for w, m in ((54, 1 / 16), (10, 0.5), (100, 1.3), (7, 0)):
        assert tx3d._round_width(w, m) == jx3d._round_width(w, m)
    shapes = jax.eval_shape(lambda: jx3d.X3D().init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 32, 3)),
                                                     train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in convert.x3d_state(zeros["params"], zeros["batch_stats"]).items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert port.layer2[0].conv2.conv.groups == 108 and port.conv1_t.conv.groups == 24
    assert port.layer3[0].se_module is not None and port.layer3[1].se_module is None
    assert port.layer1[0].se_module.fc1.bias is not None


def test_tsn_extract_and_extract_batch_equal_jax(tsn):
    jex, tex = tsn
    frames = _frames(8, (12, 48, 64, 3))
    np.testing.assert_array_equal(tex.sample_segments(40), jex.sample_segments(40))
    _close(tex.extract(frames), jex.extract(frames))
    clips = _frames(9, (3, NSEG, CROP, CROP, 3))
    got = tex.extract_batch(clips)
    _close(got, jex.extract_batch(clips))
    np.testing.assert_allclose(got[1], tex.extract(np.repeat(clips[1], 1, axis=0)), rtol=0,
                               atol=1e-5 * np.abs(got).max())


def test_x3d_extract_and_extract_batch_equal_jax(x3d):
    jex, tex = x3d
    _close(tex.extract(_frames(10, (9, 40, 30, 3))), jex.extract(_frames(10, (9, 40, 30, 3))))
    clips = _frames(11, (2, 4, 16, 16, 3))
    _close(tex.extract_batch(clips), jex.extract_batch(clips))


@pytest.mark.parametrize("cv2_present", [True, False], ids=["cv2", "no cv2"])
def test_preprocess_frames_branches_equal_jax(tsn, monkeypatch, cv2_present):
    jex, tex = tsn
    if not cv2_present:
        monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    for shape in ((3, 480, 720, 3), (2, 40, 30, 3), (2, 20, 20, 3)):
        frames = _frames(12, shape)
        got = tex.preprocess_frames(frames)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jex.preprocess_frames(frames))
    crop = _frames(13, (480, 720, 3))
    for spk in ("M", "F"):
        np.testing.assert_array_equal(tvideo.crop_speaker_half(crop, spk), jvideo.crop_speaker_half(crop, spk))


def test_from_torch_checkpoint_equals_jax_port(tsn, x3d, tmp_path):
    """mmaction checkpoints (``state_dict`` under ``backbone.``, a head and a
    meta entry beside it) read by both packages: JAX's ``port_torch_*`` gives
    back the fixture's flax variables exactly, and the port's
    ``from_torch_checkpoint`` the fixture's features bit for bit (which
    match JAX's)."""
    jex, tex = tsn
    sd = {f"backbone.{k}": v for k, v in tex.model.state_dict().items() if not k.endswith("num_batches_tracked")}
    sd["cls_head.fc_cls.weight"] = torch.zeros(6, 2048)
    torch.save({"state_dict": sd, "meta": {"epoch": 3}}, tmp_path / "tsn.pth")
    _same_tree(jvideo.TSNExtractor.from_torch_checkpoint(str(tmp_path / "tsn.pth"), n_segments=NSEG,
                                                         crop_size=CROP).variables, jex.variables)
    tnew = tvideo.TSNExtractor.from_torch_checkpoint(str(tmp_path / "tsn.pth"), n_segments=NSEG, crop_size=CROP,
                                                     device="cpu")
    clips = _frames(14, (3, NSEG, CROP, CROP, 3))
    np.testing.assert_array_equal(tnew.extract_batch(clips), tex.extract_batch(clips))
    _close(tnew.extract_batch(clips), jex.extract_batch(clips))

    jx, tx = x3d
    sd = {f"backbone.{k}": v for k, v in tx.model.state_dict().items()}
    torch.save(sd, tmp_path / "x3d.pth")
    _same_tree(jx3d.port_torch_x3d(torch.load(tmp_path / "x3d.pth"), "backbone.", jx3d.X3D(**SMALL_X3D)),
               jx.variables)
    tnew = tvideo.X3DExtractor.from_torch_checkpoint(str(tmp_path / "x3d.pth"), model=tx3d.X3D(**SMALL_X3D),
                                                     n_frames=4, crop_size=16, device="cpu")
    clips = _frames(15, (2, 4, 16, 16, 3))
    np.testing.assert_array_equal(tnew.extract_batch(clips), tx.extract_batch(clips))
    _close(tnew.extract_batch(clips), jx.extract_batch(clips))
    with pytest.raises(KeyError, match="backbone.conv1.weight"):
        tvideo.port_torch_resnet({}, "backbone.")


@pytest.mark.parametrize("layout", ["new_fc", "module. and base_model.fc"])
def test_port_torch_tsm_equals_jax(layout):
    """A torch TSN/TSM checkpoint (TemporalShift's ``conv1.net`` nesting) into
    both recognizers."""
    port = ttsm.TSMRecognizer(num_class=5, n_segment=NSEG)
    tvideo.init_weights(port, torch.Generator().manual_seed(8))
    sd = {}
    for k, v in port.state_dict().items():
        k = k.replace(".conv1.", ".conv1.net.") if "layer" in k else k
        if layout != "new_fc":
            k = "module." + k.replace("new_fc.", "base_model.fc.")
        sd[k] = v
    _, apply = _jax_tsm(num_class=5, n_segment=NSEG, consensus="avg", before_softmax=True)
    got = ttsm.TSMRecognizer(num_class=5, n_segment=NSEG).eval()
    got.load_state_dict(ttsm.port_torch_tsm(sd))
    x = np.random.default_rng(16).normal(size=(2, NSEG, CROP, CROP, 3)).astype(np.float32)
    want = np.asarray(apply(jtsm.port_torch_tsm(sd), x))
    with torch.no_grad():
        _close(got(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).numpy(), want)
    with pytest.raises(KeyError, match="classifier missing"):
        ttsm.port_torch_tsm({k: v for k, v in sd.items() if "fc." not in k})


def test_extractors_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvideo.X3DExtractor(model=tx3d.X3D(**SMALL_X3D))


@pytest.mark.parametrize("module", ["x3d", "tsm"])
def test_convert_cli_writes_the_video_state_dicts(tmp_path, module):
    """``python -m erc_tpu_torch.convert --module=x3d|tsm`` from a flat npz of
    the flax tree: the state dict the port's module loads, strictly."""
    if module == "x3d":
        jm, port = jx3d.X3D(**SMALL_X3D), tx3d.X3D(**SMALL_X3D)
        x = np.zeros((1, 4, 16, 16, 3), np.float32)
    else:
        jm, port = jtsm.TSMRecognizer(num_class=3, n_segment=NSEG), ttsm.TSMRecognizer(3, NSEG)
        x = np.zeros((1, NSEG, CROP, CROP, 3), np.float32)
    v = _draw(jm, x, 17)
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(v)[0]}
    np.savez(tmp_path / "v.npz", **flat)
    convert.main([f"--module={module}", str(tmp_path / "v.npz"), str(tmp_path / "sd.pt")])
    port.load_state_dict(torch.load(tmp_path / "sd.pt"))
    want = convert.STATES[module](v)
    for k, t in port.state_dict().items():
        assert torch.equal(t, want[k]), k
