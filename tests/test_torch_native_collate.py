"""The port's native batch packer (``csrc/collate.cpp``) ≡ the JAX package's.

- ``pack_rows``, ``pack_labels`` and ``fill_mask`` of ``erc_tpu_torch.data.
  native`` against ``erc_tpu.native``'s and against the plain numpy
  ``data.collate._pack``, bit for bit: rows of None, lengths past L, fewer
  rows than threads, ``out=``; a row shorter than its length, or a None row
  with a length, raises instead of being read past its end or left
  unwritten.
- ``ERCBatcher`` (native) against the JAX package's ``ERCBatcher`` and the
  port's numpy one (``native=False``), bit for bit in every array, dtype and
  shape: IEMOCAP-COGMEN geometry padded to more rows than dialogues, one-hot
  speakers, and MOSEI's multitask labels with its one-entry speaker rows.
- The build: four processes that build the library at once into one empty
  build directory all load it, and leave only the library there (each
  compiles to a file of its own and renames it into place); a source that
  does not compile raises with the compiler's output.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from erc_tpu import native as jnative
from erc_tpu.data.collate import ERCBatcher as JERCBatcher
from erc_tpu.data.synthetic import synthetic_erc as j_synthetic_erc
from erc_tpu_torch.data import native
from erc_tpu_torch.data.collate import ERCBatcher, _pack
from erc_tpu_torch.data.synthetic import synthetic_mosei
from erc_tpu_torch.ops.kernels import build

ROOT = Path(__file__).resolve().parents[1]


def _rows(seed, B, D=None, dtype=np.float32):
    r = np.random.default_rng(seed)
    lens = r.integers(0, 30, size=B).astype(np.int32)
    rows = []
    for n in lens:
        shape = (n,) if D is None else (n, D)
        rows.append((r.normal(size=shape) if dtype == np.float32 else r.integers(-5, 9, size=shape)).astype(dtype))
    rows[1], lens[1] = None, 0  # padding
    return rows, lens


@pytest.mark.parametrize("B, L, threads", [(9, 20, 4), (3, 32, 4), (12, 8, 1)])
def test_pack_rows_matches_jax_and_numpy(B, L, threads):
    rows, lens = _rows(B, B, D=7)
    got = native.pack_rows(rows, lens, L, 7, n_threads=threads)
    want = jnative.pack_rows(rows, lens, L, 7, n_threads=threads)
    plain = _pack([np.zeros((0, 7)) if r is None else r for r in rows], np.minimum(lens, L), (B, L, 7), np.float32, 0.0)
    assert got.dtype == np.float32 and got.shape == (B, L, 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    out = np.full((B, L, 7), np.nan, np.float32)
    assert native.pack_rows(rows, lens, L, 7, out=out) is out
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("fill", [-1, 0])
def test_pack_labels_and_fill_mask_match_jax_and_numpy(fill):
    rows, lens = _rows(3, 10, dtype=np.int32)
    L = 16
    got = native.pack_labels(rows, lens, L, fill)
    np.testing.assert_array_equal(got, jnative.pack_labels(rows, lens, L, fill))
    plain = _pack([np.zeros(0, np.int32) if r is None else r for r in rows], np.minimum(lens, L), (10, L), np.int32,
                  fill)
    np.testing.assert_array_equal(got, plain)
    assert got.dtype == np.int32
    mask = native.fill_mask(lens, L)
    np.testing.assert_array_equal(mask, jnative.fill_mask(lens, L))
    np.testing.assert_array_equal(mask, (np.arange(L)[None] < np.minimum(lens, L)[:, None]).astype(np.float32))


def test_a_short_row_raises():
    with pytest.raises(ValueError, match="row 0"):
        native.pack_rows([np.zeros((3, 4), np.float32)], np.array([5]), 8, 4)
    with pytest.raises(ValueError, match="row 0"):
        native.pack_rows([np.zeros((5, 3), np.float32)], np.array([5]), 8, 4)
    with pytest.raises(ValueError, match="row 0"):
        native.pack_labels([np.zeros(2, np.int32)], np.array([4]), 8)
    with pytest.raises(ValueError, match="row 1 is None"):
        native.pack_labels([np.zeros(2, np.int32), None], np.array([2, 1]), 8)


def _same_batches(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        assert (v is None) == (b[k] is None), k
        if v is not None:
            assert v.dtype == b[k].dtype and v.shape == b[k].shape, k
            np.testing.assert_array_equal(v, b[k], err_msg=k)


@pytest.mark.parametrize("onehot", [False, True])
def test_batcher_matches_jax_and_numpy(onehot):
    samples = j_synthetic_erc("iemocap-cogmen", 6, "train", n_train=7, min_len=4, max_len=60, seed=2)
    kw = dict(speaker_onehot=onehot, bucket=16, max_len=48, pad_batch_to=10)
    got = ERCBatcher(**kw)(samples)
    _same_batches(got, JERCBatcher(**kw)(samples))
    _same_batches(got, ERCBatcher(native=False, **kw)(samples))


def test_mosei_batch_matches_jax_and_numpy():
    samples = synthetic_mosei(6, "train", n_train=5, seed=3)
    kw = dict(n_speakers=1, bucket=16, max_len=32, pad_batch_to=6)
    got = ERCBatcher(**kw)(samples)
    assert "emo_label" in got
    _same_batches(got, JERCBatcher(**kw)(samples))
    _same_batches(got, ERCBatcher(native=False, **kw)(samples))


def test_concurrent_builds_land_whole(tmp_path):
    code = ("import sys; from pathlib import Path; from erc_tpu_torch.ops.kernels import build\n"
            "build.BUILD_ROOT = Path(sys.argv[1])\n"
            "lib = build.load_host('collate'); print(build.build_host('collate'))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    built = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    assert built == ["libcollate.so"], built


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        build.build_host("broken")
    assert not list((tmp_path / "_build").rglob("*.so"))
