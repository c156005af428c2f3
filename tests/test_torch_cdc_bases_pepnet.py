"""One CDC epoch on the PEPNet and EPNet bases against the JAX package's
CDCTrainer (tests/test_torch_cdc_bases.py runs PLE and STAR; the file is
split to keep each under about a minute on one worker)."""

import pytest
import torch

from test_torch_cdc_bases import data, epoch_matches_tpurec  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("base", ["pepnet", "epnet"])
def test_cdc_epoch_matches_tpurec(data, monkeypatch, base):  # noqa: F811
    epoch_matches_tpurec(data, monkeypatch, base)
