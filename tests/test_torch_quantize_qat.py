"""Two QAT steps of vipers_torch against the JAX package's on the CPU,
observers updating, BatchNorm training (``test_torch_quantize_train.check_two_qat_steps``:
the model, the data, the f64 run and the tolerances). One variant a file:
each compiles its own JAX step (~20 s)."""

import pytest

import torch_explain_fixtures as fx
from test_torch_quantize_train import check_two_qat_steps


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.mark.parametrize("variant", [(True, False)], ids=["observe"])
def test_two_qat_steps_match_jax(variant):
    check_two_qat_steps(variant)
