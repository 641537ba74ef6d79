"""Two ``make_train_step`` steps with gradient accumulation
(``accum_steps=2``: two micro-batches of one sequence each, gradients
averaged) against the JAX package's, on the CPU, for each of the ten
reduced configs; checks and tolerances as in
``tests/test_torch_train_steps.py``.
"""

import pytest

pytest.importorskip("torch")

from test_torch_train import ARCHS, Case  # noqa: E402
from test_torch_train_steps import check_train_steps  # noqa: E402


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def test_train_steps_with_accumulation_equal_reference(case):
    check_train_steps(case, accum=2)
