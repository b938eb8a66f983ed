"""LambdaRank at MS-LTR's width (136 features) on float waves, both
packages fed the JAX package's own lambdas through ``fobj``
(``tests/test_torch_rank_wave.py`` states how): the splits are identical
and leaf values, model text and raw predictions are held as
``tests/test_torch_slice.py`` holds them.  The JAX package may turn its
routed pass off at this width (``routed_chunk_ok``) while the port always
routes; routing carries no semantics, so the trees must agree either
way.  Its own file: the JAX package's compile at 136 features takes most
of a worker's minute.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_rank_wave import same_gradients_same_trees  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_same_gradients_same_trees_136_features():
    same_gradients_same_trees(
        "float waves", {"wave_splits": True, "hist_refinement": False}, 136,
        30, 3)
