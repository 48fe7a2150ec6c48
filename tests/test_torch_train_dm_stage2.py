"""One stage-2 DM training step of the port against dawn_tpu's DMTrainer on
the CPU: frame 0 split off as the reference, 4 of 5 frames diffused, the
condition rows from frame 1 with their deltas against frame 0, the mouth
landmarks sliced :T-1 as the reference does. Setup, draws and tolerances are
those of tests/test_torch_train_dm.py (its docstring states them); the JAX
train step compiles once here.
"""

import pytest

from test_torch_train_dm import check_cached_teacher, check_train_step, run_jax_step
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def stage2_run():
    return run_jax_step(2)


def test_stage2_train_step_matches_jax(stage2_run):
    check_train_step(stage2_run)


def test_stage2_cached_teacher_loss_equals_uncached(stage2_run):
    check_cached_teacher(stage2_run)
