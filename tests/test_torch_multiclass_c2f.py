"""Multiclass training of the port on float coarse-to-fine waves against
the JAX package: ``tests/test_torch_multiclass.py``'s first contract on
one more loop, kept apart because the JAX package's coarse-to-fine
compile dominates its time.

28 features (the refinement gate needs 28 x 256 bins), 255 bins, 4,000
rows, 4 classes, 15 leaves, 3 iterations; softmax and one-vs-all:
identical trees, model text and predictions within the contract's
tolerances (``refine_shift`` 4 on both).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402

from test_torch_multiclass import _one_thread, hold_config  # noqa: E402,F401


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_trees_match_jax_on_c2f_waves(objective):
    hold_config(objective, "float c2f waves",
                {"wave_splits": True, "max_bin": 255}, 28, 4)
