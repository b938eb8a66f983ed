"""``train``: the boosting loop behind the public API.

Counterpart of ``lightgbm_tpu/engine.py``'s ``train`` for this slice:
parameters, a training ``Dataset`` and a number of rounds.  Validation
sets, callbacks, early stopping, custom objectives and checkpoints are
not part of the slice.
"""
from __future__ import annotations

from typing import Any, Dict

from .basic import Booster, Dataset
from .utils.log import Log

__all__ = ["train"]

# canonical name first, then aliases (Config resolution order)
_ROUND_ALIASES = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                  "num_trees", "num_round", "num_rounds", "num_boost_round",
                  "n_estimators", "max_iter")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100) -> Booster:
    """Train a booster for ``num_boost_round`` iterations (or until no
    leaf can split); a rounds alias in ``params`` wins, as in the JAX
    package."""
    params = dict(params)
    seen = [(a, params.pop(a)) for a in _ROUND_ALIASES if a in params]
    if seen:
        num_boost_round = int(seen[0][1])
        for a, v in seen[1:]:
            if int(v) != num_boost_round:
                Log.warning("%s is set with %s=%d, %s=%s will be ignored",
                            seen[0][0], seen[0][0], num_boost_round, a, v)
    booster = Booster(params=params, train_set=train_set)
    # the booster's horizon: a fused super-step sizes its tail block by it
    booster._gbdt.config.num_iterations = num_boost_round
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
