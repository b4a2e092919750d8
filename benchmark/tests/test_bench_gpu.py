"""On the card: the control of the first cell's check fails it, and
sound runs pass it (one seed; benchmark/control.py runs more)."""

import pytest

from benchmark import control, core


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_the_control_fails_the_check(card):
    for row in control.measure("mistral-7b.chat-fp8kv", [20261018], 40.0):
        assert all(row["program"][k] <= v < row["control"][k] for k, v in row["limits"].items())
    assert core.forbidden_modules() == []
