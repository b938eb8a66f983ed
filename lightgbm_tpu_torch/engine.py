"""Training and cross-validation entry points.

Counterpart of ``lightgbm_tpu/engine.py`` (``train`` :156 and ``cv``
:501-695): ``train`` with validation sets, custom objectives (``fobj``)
and metrics (``feval``), callbacks, early stopping, ``evals_result`` and
``learning_rates``; ``cv`` with stratified, shuffled and query-group
folds (whole queries, for ranking) and ``CVBooster``.  ``init_model``, a
device mesh and checkpoint resume (``resume_from``) are not ported yet
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .io.dataset import group_ids, subset_group
from .utils.log import Log

__all__ = ["train", "cv", "CVBooster"]

# canonical name first, then aliases (Config resolution order)
_ROUND_ALIASES = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                  "num_trees", "num_round", "num_rounds", "num_boost_round",
                  "n_estimators", "max_iter")
_EARLY_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                       "early_stopping", "n_iter_no_change")


def _not_ported(**kwargs) -> None:
    for name, value in kwargs.items():
        if value is not None:
            raise NotImplementedError(
                f"{name} is not implemented by lightgbm_tpu_torch yet")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
          init_model=None, feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int] = True, learning_rates=None,
          keep_training_booster: bool = True,
          callbacks: Optional[List[Callable]] = None, mesh=None,
          resume_from: Optional[str] = None) -> Booster:
    """Train a booster for ``num_boost_round`` iterations (a rounds alias
    in ``params`` wins), evaluating the metrics on ``valid_sets`` after
    every iteration (``vs is train_set`` names the training data) and
    running the callbacks; stops early when a tree cannot split or a
    callback raises ``EarlyStopException``."""
    _not_ported(init_model=init_model, mesh=mesh, resume_from=resume_from)
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    params = dict(params)
    seen = [(a, params.pop(a)) for a in _ROUND_ALIASES if a in params]
    if seen:
        num_boost_round = int(seen[0][1])
        for a, v in seen[1:]:
            if int(v) != num_boost_round:
                Log.warning("%s is set with %s=%d, %s=%s will be ignored",
                            seen[0][0], seen[0][0], num_boost_round, a, v)
    if fobj is not None:
        params["objective"] = params.get("objective", "none")
        if params["objective"] not in ("none", "custom"):
            Log.warning("Using custom fobj; 'objective' parameter used only "
                        "for score transform")
    for alias in _EARLY_STOP_ALIASES:
        if alias in params and early_stopping_rounds is None:
            early_stopping_rounds = int(params.pop(alias))
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if params.get("objective") in ("none", "custom") and fobj is None:
        Log.fatal("objective=none requires a custom fobj")
    if fobj is not None:
        params["objective"] = "none"
    booster = Booster(params=params, train_set=train_set)

    valid_sets = list(valid_sets) if valid_sets else []
    valid_names = list(valid_names) if valid_names else []
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            booster.config.is_provide_training_metric = True
            booster._gbdt.config.is_provide_training_metric = True
            continue
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        booster.add_valid(vs, name)

    cbs = list(callbacks) if callbacks else []
    if evals_result is not None:
        cbs.append(callback_mod.record_evaluation(evals_result))
    if verbose_eval is True:
        cbs.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        cbs.append(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback_mod.early_stopping(
            early_stopping_rounds,
            first_metric_only=params.get("first_metric_only", False)))
    if learning_rates is not None:
        cbs.append(callback_mod.reset_parameter(
            learning_rate=learning_rates))
    cbs_before = [c for c in cbs if getattr(c, "before_iteration", False)]
    cbs_after = [c for c in cbs if not getattr(c, "before_iteration", False)]
    cbs_before.sort(key=lambda c: getattr(c, "order", 0))
    cbs_after.sort(key=lambda c: getattr(c, "order", 0))

    gbdt = booster._gbdt
    # the booster's horizon: a fused super-step sizes its tail block by it
    gbdt.config.num_iterations = num_boost_round
    if learning_rates is not None:
        # the rate changes between serves: a block dispatched ahead would
        # be built at a stale rate and dropped on arrival
        gbdt.config.superstep_pipeline_depth = 0
    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(CallbackEnv(booster, params, i, 0, num_boost_round, None))
        should_stop = booster.update(fobj=fobj)
        evaluation_result_list = []
        if gbdt.metrics and (gbdt.valid_sets or
                             gbdt.config.is_provide_training_metric):
            evaluation_result_list = booster.eval_set()
        if feval is not None:
            evaluation_result_list.extend(
                _run_feval(feval, booster, train_set, valid_sets,
                           valid_names))
        try:
            for cb in cbs_after:
                cb(CallbackEnv(booster, params, i, 0, num_boost_round,
                               evaluation_result_list))
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for item in e.best_score:
                booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
            break
        if should_stop:
            break
    if booster.best_iteration <= 0:
        for item in (booster.eval_set() if gbdt.metrics else []):
            booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    return booster


def _run_feval(feval, booster, train_set, valid_sets, valid_names):
    """A custom metric on the training data and every validation set: it
    gets the raw float64 score as a host array and the ``Dataset``."""
    out = []

    def one(name, raw_score, dataset):
        res = feval(raw_score.cpu().numpy().astype(np.float64), dataset)
        if res is None:
            return
        if isinstance(res, tuple):
            res = [res]
        for metric_name, value, hb in res:
            out.append((name, metric_name, value, hb))

    gbdt = booster._gbdt
    one("training", gbdt.train_score_tensor(), train_set)
    vs_by_name = {vs.name: vs for vs in gbdt.valid_sets}
    for i, ds in enumerate(valid_sets or []):
        if ds is train_set:
            continue
        name = valid_names[i] if valid_names and i < len(valid_names) \
            else f"valid_{i}"
        if name in vs_by_name:
            one(name, vs_by_name[name].score, ds)
    return out


class CVBooster:
    """Container of per-fold boosters (reference ``engine.py``
    _CVBooster)."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


def _make_folds(train_set: Dataset, nfold: int, stratified: bool,
                shuffle: bool, seed: int, folds=None):
    """(train rows, test rows) of each fold: ``folds`` as given (a
    splitter, called with each row's query id as ``groups``, or a list),
    else whole queries when the data has groups (permuted by ``seed``
    when shuffled, cut with ``array_split``), else stratified by label or
    plain, shuffled by ``seed`` (``lightgbm_tpu/engine.py:500-563``)."""
    n = train_set.num_data()
    group = train_set.get_group()
    if folds is not None:
        if hasattr(folds, "split"):
            return list(folds.split(np.zeros(n), train_set.get_label(),
                                    groups=group_ids(group, n)))
        return list(folds)
    rng = np.random.RandomState(seed)
    if group is not None:
        order = rng.permutation(len(group)) if shuffle \
            else np.arange(len(group))
        bounds = np.concatenate([[0], np.cumsum(group)])
        out = []
        for qs in np.array_split(order, nfold):
            test_idx = np.concatenate(
                [np.arange(bounds[q], bounds[q + 1]) for q in qs]) \
                if len(qs) else np.array([], dtype=np.int64)
            mask = np.ones(n, bool)
            mask[test_idx] = False
            out.append((np.nonzero(mask)[0], test_idx))
        return out
    if stratified:
        y = train_set.get_label()
        out_test = [[] for _ in range(nfold)]
        for cls in np.unique(y):
            idx = np.nonzero(y == cls)[0]
            if shuffle:
                idx = idx[rng.permutation(len(idx))]
            for k, part in enumerate(np.array_split(idx, nfold)):
                out_test[k].append(part)
        out = []
        for k in range(nfold):
            test_idx = np.sort(np.concatenate(out_test[k]))
            mask = np.ones(n, bool)
            mask[test_idx] = False
            out.append((np.nonzero(mask)[0], test_idx))
        return out
    idx = rng.permutation(n) if shuffle else np.arange(n)
    out = []
    for part in np.array_split(idx, nfold):
        mask = np.ones(n, bool)
        mask[part] = False
        out.append((np.nonzero(mask)[0], np.sort(part)))
    return out


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None, fpreproc=None,
       verbose_eval=None, show_stdv: bool = True, seed: int = 0,
       callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """K-fold cross-validation: one booster a fold, each with its
    held-out rows as the validation set "valid" (with their queries when
    the data has groups), trained in lockstep, ``fobj`` giving each
    iteration's gradients when set; the per-iteration mean and standard
    deviation of each metric over the folds
    (``lightgbm_tpu/engine.py:564``)."""
    _not_ported(init_model=init_model)
    if categorical_feature != "auto":
        # the JAX package's cv ignores the argument; here it names the
        # categorical features as train's does
        train_set.categorical_feature = categorical_feature
    params = dict(params)
    if metrics is not None:
        params["metric"] = metrics
    objective = params.get("objective", "regression")
    if stratified and not str(objective).startswith(("binary", "multiclass")):
        stratified = False
    if feature_name != "auto":
        train_set.feature_name = feature_name
    train_set.construct()
    raw = train_set.raw_mat
    label = train_set.get_label()
    weight = train_set.get_weight()
    group = train_set.get_group()
    n = train_set.num_data()

    folds_idx = _make_folds(train_set, nfold, stratified, shuffle, seed,
                            folds)
    cvbooster = CVBooster()
    fold_data = []
    for tr_idx, te_idx in folds_idx:
        tr = Dataset(raw[tr_idx], label=label[tr_idx],
                     weight=None if weight is None else weight[tr_idx],
                     group=subset_group(group, tr_idx, n),
                     params=dict(train_set.params),
                     categorical_feature=train_set.categorical_feature)
        te = tr.create_valid(
            raw[te_idx], label=label[te_idx],
            weight=None if weight is None else weight[te_idx],
            group=subset_group(group, te_idx, n))
        if fpreproc is not None:
            tr, te, params = fpreproc(tr, te, dict(params))
        fold_data.append((tr, te))

    results = collections.defaultdict(list)
    boosters = []
    for tr, te in fold_data:
        bst = Booster(params=params, train_set=tr)
        bst.add_valid(te, "valid")
        if eval_train_metric:
            bst.config.is_provide_training_metric = True
            bst._gbdt.config.is_provide_training_metric = True
        boosters.append(bst)
        cvbooster.append(bst)

    es_cb = None
    if early_stopping_rounds:
        es_cb = callback_mod.early_stopping(early_stopping_rounds,
                                            verbose=False)
    for i in range(num_boost_round):
        should_stop_all = True
        for bst in boosters:
            should_stop_all = bst.update(fobj=fobj) and should_stop_all
        merged = _agg_cv_result(boosters, feval, fold_data)
        for name, metric, mean, hb, std in merged:
            results[f"{name} {metric}-mean"].append(mean)
            results[f"{name} {metric}-stdv"].append(std)
        if verbose_eval:
            Log.info("[%d]\t%s", i + 1,
                     "\t".join(callback_mod._format_eval_result(
                         (n, m, v, h, s), show_stdv)
                         for n, m, v, h, s in merged))
        if es_cb is not None:
            try:
                es_cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round,
                                  merged))
            except EarlyStopException as e:
                cvbooster.best_iteration = e.best_iteration + 1
                for key in list(results.keys()):
                    results[key] = results[key][:cvbooster.best_iteration]
                break
        if callbacks:
            for cb in callbacks:
                cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round,
                               merged))
        if should_stop_all:
            break
    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out


def _agg_cv_result(boosters, feval, fold_data):
    """(data name, metric, mean over folds, higher_better, std)."""
    by_key = collections.OrderedDict()
    for bst, (tr, te) in zip(boosters, fold_data):
        for name, metric, value, hb in bst.eval_set():
            by_key.setdefault((name, metric, hb), []).append(value)
        if feval is not None:
            # the custom metric on this fold's held-out set
            score = bst._gbdt.valid_sets[0].score.cpu().numpy()
            res = feval(score.astype(np.float64), te)
            if res is not None:
                if isinstance(res, tuple):
                    res = [res]
                for name, value, hb in res:
                    by_key.setdefault(("valid", name, hb), []).append(value)
    return [(name, metric, float(np.mean(vals)), hb, float(np.std(vals)))
            for (name, metric, hb), vals in by_key.items()]
