"""Numerical-health guard of the boosting loop.

Counterpart of ``lightgbm_tpu/utils/health.py``: training whose labels,
gradients, leaf values or scores go non-finite raises
:class:`NumericalHealthError` instead of growing a NaN model.  The checks
read what the host already fetches: each tree's packed record row carries
the minimum and maximum of its gradients, hessians, leaf values and score
row, computed inside the tree's CUDA graph (``models/gbdt.py``
``_health``), and the host tree's leaf values are checked after
``records_to_tree``.  No check adds a device call.

The JAX package also emits a ``continual`` telemetry record and a counter
here; the port has no telemetry yet (``telemetry_file`` is refused), so
that waits for the port's ``obs/`` module (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from .log import Log

__all__ = ["NumericalHealthError", "abort_nonfinite"]


class NumericalHealthError(RuntimeError):
    """Training produced non-finite gradients, leaf values or scores."""

    def __init__(self, iteration: int, phase: str, detail: str = ""):
        self.iteration = int(iteration)
        self.phase = str(phase)
        self.detail = str(detail)
        msg = (f"non-finite training state at iteration {iteration} "
               f"({phase})")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def abort_nonfinite(iteration: int, phase: str, detail: str = "") -> None:
    """Log a warning and raise :class:`NumericalHealthError`."""
    Log.warning("numerical health: non-finite training state at "
                "iteration %d (%s)%s — aborting instead of training a "
                "NaN model", iteration, phase,
                f": {detail}" if detail else "")
    raise NumericalHealthError(iteration, phase, detail)
