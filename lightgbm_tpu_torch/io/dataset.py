"""Constructed (binned) dataset + metadata, device-resident.

Counterpart of ``lightgbm_tpu/io/dataset.py`` (``TpuDataset`` with its
dense and sparse constructors, ``Metadata`` with query boundaries,
``bin_rows``).  The binned matrix is
held feature-major, (F, N), on the chosen device: uint8 when every used
feature has at most 256 bins, int16 above.  Labels and weights ride
along as float32 device tensors, query boundaries as a host array.  Bin
mappers come from the numpy copy of the JAX package's binning
(``io/binning.py``), and rows are binned on the device: a numerical
column with ``torch.searchsorted``, the same left-side search the numpy
path does, a categorical one by looking its codes up in the mapper's
sorted categories, so the matrix is byte-identical to
``TpuDataset.binned.T``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.log import Log
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, KZERO, MISSING_NAN, \
    MISSING_ZERO, BinMapper, find_bin_mappers, sample_rows

__all__ = ["Metadata", "TorchDataset", "bin_rows", "group_ids",
           "subset_group"]


def _category_to_bin(col: torch.Tensor, m: BinMapper) -> torch.Tensor:
    """The categorical ``BinMapper.value_to_bin`` for one float64 column:
    a finite value's code is the value truncated toward zero (numpy's
    ``astype(int64)``), looked up among the mapper's categories; an unseen
    or negative code and an infinite value go to bin 0; a non-finite
    value (NaN, infinity) to the missing bin under ``MISSING_NAN``, and
    zero too under ``MISSING_ZERO``."""
    dev = col.device
    cats = sorted(m.categorical_2_bin)
    keys = torch.as_tensor(cats, dtype=torch.float64, device=dev)
    bins = torch.as_tensor([m.categorical_2_bin[c] for c in cats],
                           dtype=torch.int64, device=dev)
    fin = torch.isfinite(col)
    code = torch.where(fin, torch.trunc(col), torch.full_like(col, -1.0))
    out = torch.zeros(col.shape, dtype=torch.int64, device=dev)
    if len(cats):
        pos = torch.searchsorted(keys, code).clamp(max=len(cats) - 1)
        hit = keys[pos] == code
        out = torch.where(hit, bins[pos], out)
    if m.missing_type == MISSING_NAN:
        out = out.masked_fill(~fin, m.num_bin - 1)
    elif m.missing_type == MISSING_ZERO:
        out = out.masked_fill(~fin | (torch.abs(col) <= KZERO),
                              m.num_bin - 1)
    return out


def _value_to_bin(col: torch.Tensor, m: BinMapper) -> torch.Tensor:
    """``BinMapper.value_to_bin`` for one float64 column on the device."""
    if m.bin_type == BIN_CATEGORICAL:
        return _category_to_bin(col, m)
    ub = torch.as_tensor(m.bin_upper_bound, dtype=torch.float64,
                         device=col.device)
    nan = torch.isnan(col)
    if m.missing_type == MISSING_NAN:
        out = torch.searchsorted(ub, torch.where(nan, 0.0, col))
        out = torch.clamp(out, max=m.num_bin - 2)
        return out.masked_fill(nan, m.num_bin - 1)
    if m.missing_type == MISSING_ZERO:
        zero = (torch.abs(col) <= KZERO) | nan
        out = torch.searchsorted(ub, torch.where(zero, 0.0, col))
        out = torch.clamp(out, max=m.num_bin - 2)
        return out.masked_fill(zero, m.num_bin - 1)
    out = torch.searchsorted(ub, torch.where(nan, 0.0, col))
    return torch.clamp(out, max=m.num_bin - 1)


def _bin_dtype(mappers: List[BinMapper], used: Sequence[int]) -> torch.dtype:
    """uint8 when every used feature has at most 256 bins, else int16."""
    widest = max((mappers[i].num_bin for i in used), default=1)
    if widest > 32767:
        raise NotImplementedError("more than 32767 bins per feature")
    return torch.uint8 if widest <= 256 else torch.int16


def bin_rows(X: np.ndarray, mappers: List[BinMapper], used: Sequence[int],
             dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Bin raw rows against fixed mappers -> (len(used), rows) on
    ``device``."""
    Xd = torch.as_tensor(np.ascontiguousarray(X), device=device)
    out = torch.empty(len(used), X.shape[0], dtype=dtype, device=device)
    for j, f in enumerate(used):
        col = Xd[:, f].to(torch.float64).contiguous()
        out[j] = _value_to_bin(col, mappers[f]).to(dtype)
    return out


class Metadata:
    """label / weight / query container (``dataset.h:36-248``)."""

    def __init__(self, num_data: int):
        self.num_data = int(num_data)
        self.label = np.zeros(num_data, dtype=np.float32)
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None

    def set_label(self, label) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            Log.fatal("label length %d != num_data %d", len(label),
                      self.num_data)
        self.label = label

    def set_weight(self, weight) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            Log.fatal("weight length %d != num_data %d", len(weight),
                      self.num_data)
        self.weight = weight

    def set_query(self, group) -> None:
        """``group`` is per-query counts; stored as boundaries
        (``Metadata::SetQuery``)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        if group.sum() != self.num_data:
            Log.fatal("sum of query counts (%d) != num_data (%d)",
                      int(group.sum()), self.num_data)
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(group)]).astype(np.int64)

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else \
            len(self.query_boundaries) - 1


def group_ids(group, n: int) -> Optional[np.ndarray]:
    """Each row's query index from per-query counts (None without
    queries; ``lightgbm_tpu/engine.py`` ``_group_ids``)."""
    if group is None:
        return None
    return np.repeat(np.arange(len(group), dtype=np.int64),
                     np.asarray(group, np.int64))[:n]


def subset_group(group, idx: np.ndarray, n: int) -> Optional[np.ndarray]:
    """The per-query counts of the rows ``idx`` of a dataset of ``n`` rows
    whose queries are ``group``: the count of each query id present, in
    ascending id order (``lightgbm_tpu/engine.py:657-664``
    ``_subset_group``; a fold of whole queries keeps each query's rows
    together)."""
    if group is None:
        return None
    _, counts = np.unique(group_ids(group, n)[idx], return_counts=True)
    return counts


class TorchDataset:
    """Binned dataset ready for training, resident on ``device``."""

    def __init__(self, mappers: List[BinMapper], binned: torch.Tensor,
                 metadata: Metadata, device: torch.device,
                 feature_names: Optional[Sequence[str]] = None):
        self.mappers = mappers
        self.device = device
        self.num_total_features = len(mappers)
        # features that carry information (>= 2 bins)
        self.used_features = [i for i, m in enumerate(mappers)
                              if not m.is_trivial]
        if not self.used_features:
            Log.warning("dataset has no informative features")
        self.binned = binned  # (num_used_features, num_data) on device
        self.metadata = metadata
        self.num_data = metadata.num_data
        self.feature_names = (list(feature_names) if feature_names else
                              [f"Column_{i}" for i in
                               range(self.num_total_features)])
        self.num_bins = np.array(
            [mappers[i].num_bin for i in self.used_features], dtype=np.int32)
        self.max_bin_count = int(self.num_bins.max()) if len(self.num_bins) \
            else 1
        self.label = torch.as_tensor(metadata.label, dtype=torch.float32,
                                     device=device)
        self.weight = None if metadata.weight is None else torch.as_tensor(
            metadata.weight, dtype=torch.float32, device=device)

    @classmethod
    def from_raw(cls, X: np.ndarray, label, config, device: torch.device,
                 weight=None, feature_names=None,
                 mappers: Optional[List[BinMapper]] = None, group=None,
                 categorical_features: Sequence[int] = ()
                 ) -> "TorchDataset":
        """Bin a raw dense matrix on ``device``; the columns in
        ``categorical_features`` are categorical.  Passing ``mappers``
        aligns this dataset with a reference (train) dataset."""
        X = np.ascontiguousarray(X)
        num_data = X.shape[0]
        if mappers is None:
            mappers = find_bin_mappers(
                X, max_bin=config.max_bin,
                min_data_in_bin=config.min_data_in_bin,
                sample_cnt=config.bin_construct_sample_cnt,
                seed=config.data_random_seed,
                categorical_features=categorical_features,
                use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing)
        used = [i for i, m in enumerate(mappers) if not m.is_trivial]
        dtype = _bin_dtype(mappers, used)
        binned = bin_rows(X, mappers, used, dtype, device)
        meta = Metadata(num_data)
        meta.set_label(label if label is not None else np.zeros(num_data))
        meta.set_weight(weight)
        meta.set_query(group)
        return cls(mappers, binned, meta, device, feature_names)

    @classmethod
    def from_sparse(cls, X_sp, label, config, device: torch.device,
                    weight=None, feature_names=None,
                    mappers: Optional[List[BinMapper]] = None, group=None,
                    categorical_features: Sequence[int] = ()
                    ) -> "TorchDataset":
        """Bin a scipy CSR, CSC or COO matrix without densifying it
        (``lightgbm_tpu/io/dataset.py:198-250``): each column's mapper from
        its sampled non-zeros, the zeros implied by the sample size (the
        same row sample as the dense path's), or ``mappers`` of a reference
        dataset; then the (F, N) matrix on ``device`` filled column by
        column, every row at the column's bin of zero and its non-zeros
        binned from the CSC slice.  Byte-identical to the JAX package's
        ``TpuDataset.from_sparse`` (transposed).  Host memory: the CSC
        copy and the bin-construction sample; the values go to the device
        once."""
        X = X_sp.tocsc()
        num_data, num_feat = X.shape
        cat = set(int(c) for c in categorical_features)
        if mappers is None:
            idx = sample_rows(num_data, min(config.bin_construct_sample_cnt,
                                            num_data),
                              config.data_random_seed)
            Xs = X_sp.tocsr()[idx].tocsc()
            mappers = []
            for j in range(num_feat):
                vals = np.asarray(Xs.data[Xs.indptr[j]:Xs.indptr[j + 1]],
                                  np.float64)
                m = BinMapper()
                m.find_bin(vals, len(idx), config.max_bin,
                           min_data_in_bin=config.min_data_in_bin,
                           use_missing=config.use_missing,
                           zero_as_missing=config.zero_as_missing,
                           bin_type=BIN_CATEGORICAL if j in cat
                           else BIN_NUMERICAL)
                mappers.append(m)
        used = [i for i, m in enumerate(mappers) if not m.is_trivial]
        dtype = _bin_dtype(mappers, used)
        binned = torch.empty(len(used), num_data, dtype=dtype, device=device)
        data = torch.as_tensor(X.data, device=device)
        rows = torch.as_tensor(X.indices, device=device)
        zero = torch.zeros(1, dtype=torch.float64, device=device)
        for jj, f in enumerate(used):
            m = mappers[f]
            binned[jj].fill_(int(_value_to_bin(zero, m)[0]))
            lo, hi = int(X.indptr[f]), int(X.indptr[f + 1])
            if hi > lo:
                col = data[lo:hi].to(torch.float64)
                binned[jj].index_put_((rows[lo:hi].to(torch.int64),),
                                      _value_to_bin(col, m).to(dtype))
        meta = Metadata(num_data)
        meta.set_label(label if label is not None else np.zeros(num_data))
        meta.set_weight(weight)
        meta.set_query(group)
        return cls(mappers, binned, meta, device, feature_names)

    def check_align(self, other: "TorchDataset") -> bool:
        """Train/valid bin compatibility (``Dataset::CheckAlign``)."""
        if self.num_total_features != other.num_total_features:
            return False
        for a, b in zip(self.mappers, other.mappers):
            if a.num_bin != b.num_bin or a.bin_type != b.bin_type:
                return False
        return True

    def real_feature_index(self, inner: int) -> int:
        return self.used_features[inner]

    def feature_infos(self) -> List[str]:
        return [m.feature_info() for m in self.mappers]
