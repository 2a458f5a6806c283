"""A temporary experiment root for the port's tests.

Every trainer, the port's and the JAX package's, writes its run under the
experiment root (``ERC_TPU_EXPROOT``, else the machine config's, else
``~/.erc_tpu``).  A test file that builds trainers imports both fixtures:

    from torch_exproot import exproot_per_module, exproot_per_test  # noqa: F401 (autouse fixtures)

Runs of the module's shared fixtures then go to one temporary root and each
test's own runs to another, so nothing is written to ``HOME`` and
``AutoResume`` finds no sibling run of another test or of an earlier run of
the suite.
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def exproot_per_module(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ERC_TPU_EXPROOT", str(tmp_path_factory.mktemp("exproot")))
        yield


@pytest.fixture(autouse=True)
def exproot_per_test(exproot_per_module, tmp_path_factory, monkeypatch):
    monkeypatch.setenv("ERC_TPU_EXPROOT", str(tmp_path_factory.mktemp("exproot")))
