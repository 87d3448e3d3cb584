"""The explain path through a narrow Swin-V2 (embed 24, heads 3/3/6/6,
10 classes) at 256 x 256 against the JAX package on the CPU, on the same
weights (``tests/torch_explain_fixtures.py``): the tap on the final map
(the port alone; GradCAM's parity places it),
epsilon-LRP (every Dense/Conv but ``attn.qkv``) at eps 1e-2 and at the
default eps, and ``compute_heatmaps``' GradCAM and Guided-GradCAM.
Tolerances as in ``test_torch_explain_models.py``.
"""

import pytest

from tests import torch_explain_fixtures as fx


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def test_tap_moves_the_final_map():
    # where the JAX Swin adds it is held by compute_heatmaps' GradCAM below
    fx.check_tap("swin", against_jax=False)


def test_lrp_attribution_matches_jax():
    fx.check_lrp_matches_jax("swin")


def test_lrp_at_the_default_eps():
    fx.check_lrp_default_eps("swin")


def test_compute_heatmaps_matches_jax():
    fx.check_compute_heatmaps("swin")
