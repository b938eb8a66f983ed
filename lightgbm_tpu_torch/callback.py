"""Training callbacks.

Counterpart of ``lightgbm_tpu/callback.py`` (``python-package/lightgbm/
callback.py`` in the reference): periodic metric printing, metric
recording, per-iteration parameter schedules, and validation-based early
stopping, as small callback classes over a shared :class:`CallbackEnv`
snapshot.  The env tuple and the ``order`` / ``before_iteration``
attributes are the protocol the training loop (``engine.train``) sorts
and dispatches on.  (``record_telemetry`` waits for the port's
observability plane.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from .utils.log import Log


@dataclasses.dataclass(frozen=True)
class CallbackEnv:
    """Per-iteration snapshot handed to every callback."""
    model: Any
    params: Dict[str, Any]
    iteration: int
    begin_iteration: int
    end_iteration: int
    evaluation_result_list: Optional[List[Tuple]]

    # tuple-style access kept for callbacks written against the
    # namedtuple form of the protocol (plain references, no copying)
    def __getitem__(self, i):
        return (self.model, self.params, self.iteration,
                self.begin_iteration, self.end_iteration,
                self.evaluation_result_list)[i]


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(entry, show_stdv: bool = True) -> str:
    """Render one eval tuple: (data, metric, value, higher_better[, stdv])."""
    data, metric, value = entry[0], entry[1], entry[2]
    if len(entry) == 5 and show_stdv:
        return f"{data}'s {metric}: {value:g} + {entry[4]:g}"
    if len(entry) in (4, 5):
        return f"{data}'s {metric}: {value:g}"
    raise ValueError(f"Wrong metric value {entry}")


class _PrintEvaluation:
    order = 10
    before_iteration = False

    def __init__(self, period: int, show_stdv: bool):
        self.period = period
        self.show_stdv = show_stdv

    def __call__(self, env: CallbackEnv) -> None:
        if self.period <= 0 or not env.evaluation_result_list:
            return
        if (env.iteration + 1) % self.period == 0:
            Log.info("[%d]\t%s", env.iteration + 1,
                     "\t".join(_format_eval_result(e, self.show_stdv)
                               for e in env.evaluation_result_list))


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    return _PrintEvaluation(period, show_stdv)


class _RecordEvaluation:
    order = 20
    before_iteration = False

    def __init__(self, eval_result: Dict):
        if not isinstance(eval_result, dict):
            raise TypeError("eval_result must be a dict")
        eval_result.clear()
        self.store = eval_result

    def __call__(self, env: CallbackEnv) -> None:
        for entry in env.evaluation_result_list or []:
            data, metric, value = entry[0], entry[1], entry[2]
            self.store.setdefault(data, {}).setdefault(metric, []).append(
                value)


def record_evaluation(eval_result: Dict) -> Callable:
    return _RecordEvaluation(eval_result)


class _ResetParameter:
    order = 10
    before_iteration = True

    def __init__(self, schedules: Dict[str, Any]):
        self.schedules = schedules

    def __call__(self, env: CallbackEnv) -> None:
        updates = {}
        for key, sched in self.schedules.items():
            if callable(sched):
                updates[key] = sched(env.iteration - env.begin_iteration)
            else:
                if not isinstance(sched, (list, tuple)):
                    raise ValueError(
                        f"reset_parameter: {key!r} must be a list of "
                        f"per-iteration values or a callable "
                        f"iteration -> value, got {type(sched).__name__}")
                values = list(sched)
                if len(values) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"length of list {key!r} must equal num_boost_round")
                updates[key] = values[env.iteration - env.begin_iteration]
        if "learning_rate" in updates:
            lr = float(updates["learning_rate"])
            # the booster writes the device rate before its next tree
            env.model._gbdt.shrinkage_rate = lr
            env.model._gbdt.config.learning_rate = lr
        env.params.update(updates)


def reset_parameter(**kwargs) -> Callable:
    """Per-iteration parameter schedules: each kwarg is a list (one value
    per round) or a callable iteration -> value.  ``learning_rate`` is
    applied to the booster's shrinkage."""
    return _ResetParameter(kwargs)


@dataclasses.dataclass
class _MetricState:
    """Best-so-far tracker for one (dataset, metric) eval stream."""
    higher_better: bool
    best_value: float = None
    best_round: int = 0
    best_snapshot: Optional[List[Tuple]] = None

    def improved(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return value > self.best_value if self.higher_better \
            else value < self.best_value


class _EarlyStopping:
    order = 30
    before_iteration = False

    def __init__(self, patience: int, first_metric_only: bool, verbose: bool):
        self.patience = patience
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.states: Optional[List[_MetricState]] = None
        self.active = True

    def _start(self, env: CallbackEnv) -> None:
        # DART reweights past trees every iteration, so "best iteration"
        # is not well-defined and early stopping is disabled
        boosting = next((env.params[a] for a in
                         ("boosting", "boosting_type", "boost")
                         if a in env.params), "gbdt")
        if boosting == "dart":
            self.active = False
            Log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if self.verbose:
            Log.info("Training until validation scores don't improve for "
                     "%d rounds.", self.patience)
        self.states = [_MetricState(higher_better=bool(entry[3]))
                       for entry in env.evaluation_result_list]

    def _finish(self, state: _MetricState, reason: str) -> None:
        if self.verbose:
            Log.info("%s, best iteration is:\n[%d]\t%s", reason,
                     state.best_round + 1,
                     "\t".join(_format_eval_result(e)
                               for e in state.best_snapshot))
        raise EarlyStopException(state.best_round, state.best_snapshot)

    def __call__(self, env: CallbackEnv) -> None:
        if self.states is None and self.active:
            self._start(env)
        if not self.active:
            return
        for state, entry in zip(self.states, env.evaluation_result_list):
            if state.improved(entry[2]):
                state.best_value = entry[2]
                state.best_round = env.iteration
                state.best_snapshot = env.evaluation_result_list
            if entry[0] == "training":
                continue  # train metric never stops training
            if env.iteration - state.best_round >= self.patience:
                self._finish(state, "Early stopping")
            if env.iteration == env.end_iteration - 1:
                self._finish(state, "Did not meet early stopping. Best "
                                    "iteration")
            if self.first_metric_only:
                break


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Stop when no validation metric improves for ``stopping_rounds``
    consecutive rounds (training metrics are tracked but never trigger)."""
    return _EarlyStopping(stopping_rounds, first_metric_only, verbose)
