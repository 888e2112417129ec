"""Fixtures of the harness's CPU tests: two intra-op threads a test (the
tests run beside others), a ``TMPDIR`` of the test's own for the weights
and stores a run writes, and the card for the cases marked ``cuda``,
looked for inside the fixture."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "python -m pytest perfbench/tests -m cuda -q")
    return torch.device("cuda")
