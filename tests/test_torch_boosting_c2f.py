"""Training with row sampling on coarse-to-fine waves: the port against
the JAX package (``JAX_PLATFORMS=cpu``).

bench.py's ``wave255`` tier at a small row count (28 features x 255 bins
resolve ``refine_shift = 4`` and two-column passes on both sides), in
every mode of ``tests/test_torch_boosting.py``, under that file's
contract: the masks recorded at every iteration equal (or, where the two
packages' gradients differ in the last ulp, the port's weight function fed
the JAX gradients gives the JAX mask), and the contract of
``tests/test_torch_slice.py`` on 6 trees.  A file of its own: the JAX
package's compile of this loop takes most of its time.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_boosting import (  # noqa: E402
    MODES, check_training_matches_jax)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", list(MODES))
def test_sampled_c2f_training_matches_jax(mode):
    check_training_matches_jax("two-column c2f waves", mode)
