"""A run with the timed path broken underneath comes out not correct.

The tiny cells run the whole harness on the CPU (the harness's look for a
card is the only step skipped; the port runs its kernels' plain
versions). The fault a served cell can have is a token altered where it
is produced; a training cell's are a step that leaves its state
unchanged and half of the batch left out (``benchmark/faults.py``)."""

import pytest

from benchmark import faults
from benchmark.tests import tiny


def test_a_sound_run_is_correct():
    out = tiny.run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["widest_logit_gap"]["value"] <= 0.5


def test_an_altered_token_is_caught():
    with faults.altered_token():
        out = tiny.run()
    assert not out["correct"]
    assert out["checks"]["widest_logit_gap"]["value"] > 0.5


def test_a_sound_training_run_is_correct():
    out = tiny.run(seconds=1.0, name=tiny.TRAIN)
    assert out["correct"], out["checks"]
    assert out["metrics"]["train_tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_a_training_fault_is_caught(fault):
    with faults.FAULTS[fault]():
        out = tiny.run(seconds=1.0, name=tiny.TRAIN)
    assert not out["correct"]
