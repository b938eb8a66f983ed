"""Feature binning: raw values -> small integer bins.

Capability parity with the reference's ``BinMapper``
(``include/LightGBM/bin.h:61-209``, ``src/io/bin.cpp``): equal-frequency
("greedy") numerical binning built from a row sample with
``min_data_in_bin``, missing-value types {None, Zero, NaN}, and
categorical bins ordered by frequency.

A numpy copy of the JAX package's ``io/binning.py`` (its pure-Python
path) without the mapper serialization: the bin boundaries and category
tables, and so the binned matrix, come out byte-identical.  The binned matrix itself is built on the device by
:func:`lightgbm_tpu_torch.io.dataset.bin_rows`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.log import Log


KZERO = 1e-35

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1


def _find_boundaries(distinct: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int,
                     min_data_in_bin: int) -> List[float]:
    """Equal-frequency boundaries over (distinct value, count) pairs.

    Returns upper bounds; bin b holds values <= bounds[b]; the final bound
    is +inf.  A distinct value never straddles two bins, each bin holds at
    least ``min_data_in_bin`` samples (when feasible), and zero is kept in
    its own ±1e-35 band like the reference so sparse semantics survive.
    """
    n_distinct = len(distinct)
    if n_distinct == 0:
        return [np.inf]
    if n_distinct <= max_bin:
        # one bin per distinct value, but merge values whose counts are
        # below min_data_in_bin into their neighbor (bin.cpp GreedyFindBin
        # only closes a bin once it holds >= min_data_in_bin samples)
        bounds = []
        cur = 0
        for i in range(n_distinct - 1):
            cur += int(counts[i])
            if cur >= min_data_in_bin:
                bounds.append(_midpoint(distinct[i], distinct[i + 1]))
                cur = 0
        bounds.append(np.inf)
        return bounds
    # Greedy equal-frequency with "big value" handling (GreedyFindBin,
    # src/io/bin.cpp:74): a distinct value whose count exceeds the mean
    # bin size gets a bin of its own; a bin in progress is closed early
    # (at half the mean size) when the next value is big, so the big
    # value never absorbs its small-count neighbors; the mean target is
    # renewed as small-value bins close.
    if min_data_in_bin > 0:
        max_bin = max(min(max_bin, total_cnt // min_data_in_bin), 1)
    mean_size = total_cnt / max_bin
    is_big = counts >= mean_size
    rest_bins = max_bin - int(is_big.sum())
    rest_total = int(counts[~is_big].sum())
    mean_size = rest_total / max(rest_bins, 1)

    bounds = []
    cur = 0
    for i in range(n_distinct - 1):
        if not is_big[i]:
            rest_total -= int(counts[i])
        cur += int(counts[i])
        if (is_big[i] or cur >= mean_size or
                (is_big[i + 1] and cur >= max(1.0, mean_size * 0.5))):
            bounds.append(_midpoint(distinct[i], distinct[i + 1]))
            if len(bounds) >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bins -= 1
                mean_size = rest_total / max(rest_bins, 1)
    bounds.append(np.inf)
    return bounds


def _midpoint(a: float, b: float) -> float:
    m = (float(a) + float(b)) / 2.0
    # keep zero separable: never place a boundary strictly inside the
    # zero band
    if -KZERO < m < KZERO:
        m = -KZERO if b <= 0 else KZERO
    return m


class BinMapper:
    """Maps one raw feature column to integer bins."""

    def __init__(self):
        self.num_bin = 1
        self.bin_type = BIN_NUMERICAL
        self.missing_type = MISSING_NONE
        self.is_trivial = True
        self.sparse_rate = 0.0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        # categorical: category code -> bin, and bin -> code (bin 0, the
        # "other" bin of rare and unseen categories, holds -1)
        self.categorical_2_bin: Dict[int, int] = {}
        self.bin_2_categorical: List[int] = []
        self.min_val = 0.0
        self.max_val = 0.0
        self.default_bin = 0  # bin of value 0.0 (GetDefaultBin, bin.h)

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int = 3,
                 min_split_data: int = 0, use_missing: bool = True,
                 zero_as_missing: bool = False,
                 bin_type: int = BIN_NUMERICAL) -> None:
        """Build the mapping from a sample of raw values.

        ``values`` may include NaN; zeros may be omitted by sparse callers
        in which case ``total_sample_cnt`` > ``len(values)`` and the
        difference is counted as zeros (reference ``BinMapper::FindBin``
        signature, ``bin.cpp``).
        """
        values = np.asarray(values, dtype=np.float64)
        na_cnt = int(np.isnan(values).sum())
        vals = values[~np.isnan(values)]
        zero_cnt = int(total_sample_cnt - len(vals) - na_cnt)
        self.bin_type = bin_type

        if zero_as_missing:
            self.missing_type = MISSING_ZERO
            na_cnt += zero_cnt + int((np.abs(vals) <= KZERO).sum())
            vals = vals[np.abs(vals) > KZERO]
            zero_cnt = 0
        elif not use_missing:
            self.missing_type = MISSING_NONE
            vals = np.concatenate([vals, np.zeros(na_cnt)])  # NaN -> 0
            na_cnt = 0
        elif na_cnt > 0:
            self.missing_type = MISSING_NAN
        else:
            self.missing_type = MISSING_NONE

        if bin_type == BIN_CATEGORICAL:
            self._find_bin_categorical(vals, zero_cnt, max_bin, na_cnt)
        else:
            self._find_bin_numerical(vals, zero_cnt, max_bin, na_cnt,
                                     min_data_in_bin, total_sample_cnt)
        nonzero = int((np.abs(vals) > KZERO).sum())
        self.sparse_rate = (1.0 - nonzero / total_sample_cnt
                            if total_sample_cnt > 0 else 0.0)

    def _find_bin_numerical(self, vals, zero_cnt, max_bin, na_cnt,
                            min_data_in_bin, total_sample_cnt):
        if len(vals):
            self.min_val = float(vals.min())
            self.max_val = float(vals.max())
        if zero_cnt > 0:
            vals = np.concatenate([vals, np.zeros(zero_cnt)])
        eff_max_bin = max_bin - 1 if self.missing_type == MISSING_NAN else max_bin
        eff_max_bin = max(eff_max_bin, 1)
        if len(vals) == 0:
            self.bin_upper_bound = np.array([np.inf])
        else:
            svals = np.sort(vals)  # values only — no permutation needed
            distinct, counts = _unique_with_counts(svals)
            bounds = _find_boundaries(distinct, counts, eff_max_bin,
                                      len(vals), min_data_in_bin)
            self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        self.num_bin = len(self.bin_upper_bound)
        if self.missing_type == MISSING_NAN:
            self.num_bin += 1  # last bin holds NaN
        if self.missing_type == MISSING_ZERO:
            # dedicated zero/missing bin appended last
            self.num_bin += 1
        self.is_trivial = (self.num_bin <= 1)
        if not self.is_trivial:
            if self.missing_type == MISSING_ZERO:
                self.default_bin = self.num_bin - 1  # zeros live in the
                # missing bin — keep GetDefaultBin consistent with
                # value_to_bin
            else:
                self.default_bin = int(np.searchsorted(
                    self.bin_upper_bound, 0.0, side="left"))

    def _find_bin_categorical(self, vals, zero_cnt, max_bin, na_cnt):
        """Categories by count, most frequent first (ties in code order):
        bin ``i + 1`` holds the i-th; negative codes count as missing; the
        rarest are cut at 99% of the mass and at ``max_bin - 1``
        categories into bin 0, the "other" bin; NaN (or zero, under
        ``zero_as_missing``) gets a last bin of its own."""
        cats = vals.astype(np.int64)
        if np.any(cats < 0):
            Log.warning("negative categorical value found; treated as missing")
            cats = cats[cats >= 0]
        if zero_cnt > 0:
            cats = np.concatenate([cats, np.zeros(zero_cnt, dtype=np.int64)])
        if len(cats) == 0:
            self.num_bin = 1
            self.is_trivial = True
            return
        uniq, counts = np.unique(cats, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        uniq, counts = uniq[order], counts[order]
        cum = np.cumsum(counts)
        keep_n = int(min(len(uniq), max_bin - 1))
        cut = np.searchsorted(cum, cum[-1] * 0.99, side="left") + 1
        keep_n = int(min(keep_n, max(cut, 1)))
        self.categorical_2_bin = {int(uniq[i]): i + 1 for i in range(keep_n)}
        self.bin_2_categorical = [-1] + [int(c) for c in uniq[:keep_n]]
        self.num_bin = keep_n + 1
        # zero_as_missing keeps MISSING_ZERO; else NaN decides
        if self.missing_type != MISSING_ZERO:
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE
        if self.missing_type in (MISSING_NAN, MISSING_ZERO):
            self.num_bin += 1
        self.is_trivial = keep_n <= 1

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Raw values of a categorical column -> bins on the host
        (``BinMapper::ValueToBin``; the binned matrix of both kinds of
        column is made on the device, ``io/dataset.py`` ``_value_to_bin``).
        A category's code is the value truncated toward zero; an unseen
        code, a negative one and an infinite value go to bin 0, NaN to the
        missing bin (infinite values too under ``MISSING_NAN``)."""
        if self.bin_type != BIN_CATEGORICAL:
            raise ValueError("numerical columns are binned on the device")
        values = np.asarray(values, dtype=np.float64)
        out = np.zeros(values.shape, dtype=np.int32)
        nan = ~np.isfinite(values)
        iv = np.where(nan, -1, values).astype(np.int64)
        for cat, b in self.categorical_2_bin.items():
            out[iv == cat] = b
        if self.missing_type == MISSING_NAN:
            out[nan] = self.num_bin - 1
        elif self.missing_type == MISSING_ZERO:
            out[nan | (np.abs(values) <= KZERO)] = self.num_bin - 1
        return out

    @property
    def missing_bin(self) -> int:
        """Bin index holding missing values, or -1."""
        if self.missing_type in (MISSING_NAN, MISSING_ZERO):
            return self.num_bin - 1
        return -1

    def bin_to_value(self, bin_idx: int) -> float:
        """Real threshold for a bin (``BinMapper::BinToValue``): the bin's
        upper bound, which prediction compares with ``value <= thr``; a
        categorical bin's category code."""
        if self.bin_type == BIN_CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        if bin_idx >= len(self.bin_upper_bound):
            return np.inf
        return float(self.bin_upper_bound[bin_idx])

    def feature_info(self) -> str:
        """feature_infos entry in the model file ([min:max], or the
        categories in code order joined by ``:``)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_CATEGORICAL:
            return ":".join(str(c) for c in sorted(
                c for c in self.bin_2_categorical if c >= 0))
        return f"[{self.min_val:g}:{self.max_val:g}]"


def _unique_with_counts(sorted_vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """np.unique on an ALREADY-SORTED array without the re-sort."""
    n = len(sorted_vals)
    if n == 0:
        return sorted_vals, np.zeros(0, np.int64)
    edges = np.flatnonzero(sorted_vals[1:] != sorted_vals[:-1]) + 1
    starts = np.concatenate([[0], edges])
    counts = np.diff(np.concatenate([starts, [n]]))
    return sorted_vals[starts], counts


def sample_rows(num_data: int, sample_cnt: int, seed: int) -> np.ndarray:
    """Row sample for bin construction (``Random::Sample`` equivalent)."""
    if num_data <= sample_cnt:
        return np.arange(num_data)
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    return np.sort(rng.choice(num_data, size=sample_cnt, replace=False))


def find_bin_mappers(X: np.ndarray, max_bin: int, min_data_in_bin: int,
                     sample_cnt: int, seed: int,
                     categorical_features: Sequence[int] = (),
                     use_missing: bool = True,
                     zero_as_missing: bool = False) -> List[BinMapper]:
    """Build one ``BinMapper`` per column of a dense matrix; the columns
    in ``categorical_features`` are categorical."""
    num_data, num_feat = X.shape
    idx = sample_rows(num_data, sample_cnt, seed)
    # materialize the sample once: per-feature fancy indexing into a
    # wide row-major matrix costs O(sample × features) random reads
    Xs = X[idx] if len(idx) < num_data else X
    cat = set(int(c) for c in categorical_features)
    mappers: List[Optional[BinMapper]] = [None] * num_feat

    def one(f: int) -> None:
        m = BinMapper()
        m.find_bin(Xs[:, f], Xs.shape[0], max_bin, min_data_in_bin,
                   use_missing=use_missing, zero_as_missing=zero_as_missing,
                   bin_type=BIN_CATEGORICAL if f in cat else BIN_NUMERICAL)
        mappers[f] = m

    if num_feat >= 64:
        # the heavy per-feature ops (sort, unique, boundary search)
        # release the GIL — thread the loop like the reference's
        # OMP-parallel FindBin (dataset_loader.cpp:791)
        import concurrent.futures as cf
        import os as _os
        workers = min(16, _os.cpu_count() or 4)
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(one, range(num_feat)))
    else:
        for f in range(num_feat):
            one(f)
    return mappers
