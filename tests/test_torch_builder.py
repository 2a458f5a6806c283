"""The port's ``DatasetBuilder`` (``erc_tpu_torch/data/builder.py``) against the
JAX package's (``erc_tpu/data/builder.py``): the cases of
``tests/test_pipeline_extras.py``, and the transforms, modes and pseudo-sizing
beside them, run on both builders over the same samples (exact equality).
"""

import pytest

from erc_tpu.data.builder import DatasetBuilder as JaxBuilder
from erc_tpu_torch.data.builder import DatasetBuilder as TorchBuilder


def _double(d):
    return {"v": d["v"] * 2}


def _chain_transforms(B, samples):
    return B().add_input("all", samples).add_output("all", "all").add_output_transform("all", _double).chain()


def _zip(B, samples):
    return B().add_input("a", samples).add_output("a", "x").zip()


def _repeat(B, samples):
    return B().add_input("all", samples).add_output("all", "all").chain().repeat(3)


def _scaled(B, samples):
    return _repeat(B, samples).scale_to_size(7)


def _subset(B, samples):
    return B().add_input("all", samples).add_output("all", "all").chain().subset([2, 3])


def _everything(B, samples):
    """Two inputs of unequal length (the shortest sets the base), input, output
    and global transforms, zip mode, a subset and a pseudo-size that wraps."""
    return (B().add_input("a", samples).add_input("b", samples[:3])
            .add_output("a", "x").add_output("b", "y")
            .add_input_transform("a", lambda d: {"v": d["v"] + 1})
            .add_output_transform("y", _double)
            .add_global_transform(lambda out: {**out, "n": len(out)})
            .zip().subset([2, 0, 1]).scale_to_size(8))


def _no_outputs(B, samples):
    """No declared output: every input under its own name; chain of one input."""
    return B().add_input("only", samples).chain()


CASES = {"chain_transforms": _chain_transforms, "zip": _zip, "repeat": _repeat, "scale_to_size": _scaled,
         "subset": _subset, "everything": _everything, "no_outputs": _no_outputs}


@pytest.mark.parametrize("case", list(CASES))
def test_builder_matches_jax(case):
    samples = [{"v": i} for i in range(5)]
    jb, tb = CASES[case](JaxBuilder, samples), CASES[case](TorchBuilder, samples)
    assert len(tb) == len(jb)
    assert [tb.map_index(i) for i in range(2 * len(jb))] == [jb.map_index(i) for i in range(2 * len(jb))]
    assert tb.samples() == jb.samples()
    assert tb._base_len() == jb._base_len()


def test_pipeline_extras_cases():
    """``tests/test_pipeline_extras.py``'s builder assertions, on the port."""
    samples = [{"v": i} for i in range(5)]
    ds = _chain_transforms(TorchBuilder, samples)
    assert len(ds) == 5 and ds[2] == {"v": 4}
    assert _zip(TorchBuilder, samples)[1] == {"x": {"v": 1}}
    nums = list(range(4))
    ds = TorchBuilder().add_input("all", nums).add_output("all", "all").chain()
    ds.repeat(3)
    assert len(ds) == 12 and ds[5] == nums[1]
    ds.scale_to_size(7)
    assert len(ds) == 7
    ds2 = TorchBuilder().add_input("all", nums).add_output("all", "all").chain().subset([2, 3])
    assert len(ds2) == 2 and ds2[0] == 2
    assert len(TorchBuilder()) == 0 and TorchBuilder().map_index(3) == 0


def test_extras_modules_load_no_jax():
    """Importing the five modules of the extras and calling each once on the
    CPU loads nothing of JAX, flax, optax or the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import importlib, sys, torch\n"
        "mods = {m: importlib.import_module('erc_tpu_torch.' + m) for m in\n"
        "        ('augment_image', 'contrib', 'data.builder', 'models.image_backbones', 'ops.fusion')}\n"
        "img = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)\n"
        "mods['augment_image'].randaugment(img, 2, torch.Generator().manual_seed(0))\n"
        "mods['contrib'].mixup(torch.ones(4, 3), torch.ones(4, 2), generator=torch.Generator().manual_seed(0))\n"
        "mods['data.builder'].DatasetBuilder().add_input('a', [1, 2]).samples()\n"
        "mods['models.image_backbones'].WideResnet(k=1, n=10).eval()(torch.zeros(1, 3, 8, 8))\n"
        "mods['ops.fusion'].MatchingAttention(4, 4)(torch.zeros(1, 3, 4), torch.zeros(1, 4))\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'erc_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
