"""Exclusive Feature Bundling (EFB).

Counterpart of ``lightgbm_tpu/io/bundle.py``: the greedy conflict-bounded
grouping (``find_bundles``, the reference's ``FindGroups``,
``src/io/dataset.cpp:66-135``) and the bundle layout are the JAX
package's, copied in numpy, so the groups, offsets and maps are the same.
The bundled matrix is made on the booster's device from the (F, N) binned
matrix (:meth:`FeatureBundles.bundle_columns`), byte for byte the numpy
``bundle_matrix`` transposed, and :class:`BundleMaps` holds the four maps
growth reads there.

Bundle layout: bin 0 = "every member at its default"; member ``j``
occupies ``num_bin_j - 1`` slots ``[offset_j, offset_j + num_bin_j - 1)``
holding its non-default bins in order (its default bin is skipped and
rebuilt from leaf totals at split time, like ``FixHistogram``,
``dataset.h:411``).  A bundle of one feature keeps that feature's bins.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

__all__ = ["FeatureBundles", "BundleMaps", "find_bundles"]


@dataclasses.dataclass
class FeatureBundles:
    """Static bundling description over inner (used) feature indices."""
    groups: List[List[int]]        # inner feature ids per bundle
    group_id: np.ndarray           # (F,) bundle owning each feature
    offsets: np.ndarray            # (F,) bundle-bin offset of each feature
    default_bin: np.ndarray        # (F,) each feature's skipped bin
    group_num_bins: np.ndarray     # (G,) total bins per bundle
    is_singleton: np.ndarray       # (G,) group holds exactly one feature

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def to_bundle_map(self, B: int, num_bins: np.ndarray) -> np.ndarray:
        """(F, B) feature-bin -> bundle-bin; -1 for the skipped default
        bin and bins beyond the feature's own range."""
        F = len(self.group_id)
        out = np.full((F, B), -1, np.int32)
        for f in range(F):
            g = self.group_id[f]
            if self.is_singleton[g]:
                out[f] = np.arange(B)
                continue
            db = int(self.default_bin[f])
            off = int(self.offsets[f])
            for b in range(min(int(num_bins[f]), B)):
                if b == db:
                    continue
                out[f, b] = off + b - (b > db)
        return out

    def from_bundle_map(self, B: int, num_bins: np.ndarray) -> np.ndarray:
        """(F, B) bundle-bin -> feature-bin; positions outside the
        feature's slot range (including bundle bin 0 and other members'
        slots) resolve to the feature's default bin."""
        F = len(self.group_id)
        out = np.zeros((F, B), np.int32)
        for f in range(F):
            g = self.group_id[f]
            if self.is_singleton[g]:
                out[f] = np.arange(B)
                continue
            db = int(self.default_bin[f])
            off = int(self.offsets[f])
            nb = int(num_bins[f])
            out[f, :] = db
            for s in range(nb - 1):
                b = s if s < db else s + 1
                if off + s < B:
                    out[f, off + s] = b
        return out

    def fix_default_map(self, B: int) -> np.ndarray:
        """(F, B) float32 one-hot of each bundled feature's skipped
        default bin; zero rows for features alone in their group."""
        F = len(self.group_id)
        fix = np.zeros((F, B), np.float32)
        for f in range(F):
            if not self.is_singleton[self.group_id[f]]:
                fix[f, self.default_bin[f]] = 1.0
        return fix

    def bundle_matrix(self, binned: np.ndarray) -> np.ndarray:
        """(N, F) binned -> (N, G) bundled columns (numpy)."""
        N = binned.shape[0]
        out = np.zeros((N, self.num_groups), dtype=binned.dtype)
        for g, feats in enumerate(self.groups):
            if self.is_singleton[g]:
                out[:, g] = binned[:, feats[0]]
                continue
            col = np.zeros(N, np.int32)
            for f in feats:
                b = binned[:, f].astype(np.int32)
                db = int(self.default_bin[f])
                nz = b != db
                val = self.offsets[f] + b - (b > db)
                # later members overwrite on (rare) conflicts, like the
                # reference's per-feature Push into a shared column
                col[nz] = val[nz]
            out[:, g] = col.astype(binned.dtype)
        return out

    def bundle_columns(self, xt: torch.Tensor) -> torch.Tensor:
        """(F, N) binned on any device -> (G, N) bundled columns there, of
        the same dtype: :meth:`bundle_matrix` as tensor code, the same
        bytes (transposed), later members overwriting on conflicts."""
        N = xt.shape[1]
        out = torch.empty((self.num_groups, N), dtype=xt.dtype,
                          device=xt.device)
        for g, feats in enumerate(self.groups):
            if self.is_singleton[g]:
                out[g] = xt[feats[0]]
                continue
            col = torch.zeros(N, dtype=torch.int32, device=xt.device)
            for f in feats:
                b = xt[f].to(torch.int32)
                db = int(self.default_bin[f])
                val = int(self.offsets[f]) + b - (b > db).to(torch.int32)
                col = torch.where(b != db, val, col)
            out[g] = col.to(xt.dtype)
        return out

    def device_maps(self, B: int, num_bins: np.ndarray,
                    device) -> "BundleMaps":
        """The maps growth reads, on ``device``, at committed width B."""
        i64 = torch.int64
        return BundleMaps(
            group=torch.as_tensor(self.group_id, dtype=i64, device=device),
            to_bundle=torch.as_tensor(self.to_bundle_map(B, num_bins),
                                      dtype=i64, device=device),
            from_bundle=torch.as_tensor(self.from_bundle_map(B, num_bins),
                                        dtype=i64, device=device),
            fix=torch.as_tensor(self.fix_default_map(B), device=device),
            num_groups=self.num_groups)


@dataclasses.dataclass
class BundleMaps:
    """The JAX package's ``bundle_maps`` on the device: ``group`` (F,)
    each feature's bundle column, ``to_bundle`` (F, B) its bins' bundle
    bins (-1: the skipped default bin and bins past its range),
    ``from_bundle`` (F, B) each bundle bin's bin of the feature (its
    default bin outside its slots) and ``fix`` (F, B) float32, the
    one-hot of the default bin a histogram rebuilds."""
    group: torch.Tensor
    to_bundle: torch.Tensor
    from_bundle: torch.Tensor
    fix: torch.Tensor
    num_groups: int

    def translate(self, feature: torch.Tensor, left_mask: torch.Tensor):
        """Split records over logical features -> over bundle columns:
        ``feature`` (S,) integer ids -> (S,) int32 bundle columns,
        ``left_mask`` (S, B) feature-bin masks -> (S, B) bundle-bin masks
        (``mask[from_bundle[feature]]``, the JAX package's ``route_rows``
        and ``goes_left_of``)."""
        f = feature.to(torch.int64)
        fb = self.from_bundle.index_select(0, f)
        return (self.group.index_select(0, f).to(torch.int32),
                torch.gather(left_mask, 1, fb))


def _bundle_sample(binned, sample_cnt: int, seed: int) -> np.ndarray:
    """(S, F) host sample of the rows conflicts are counted on: every row
    up to ``sample_cnt``, else ``RandomState(seed & 0x7FFFFFFF).choice``
    of them.  ``binned`` is the (N, F) numpy matrix or the (F, N) tensor
    (gathered on its device, then copied)."""
    is_t = torch.is_tensor(binned)
    N = binned.shape[1] if is_t else binned.shape[0]
    rows = None
    if N > sample_cnt:
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        rows = rng.choice(N, size=sample_cnt, replace=False)
    if not is_t:
        return binned if rows is None else binned[rows]
    if rows is not None:
        binned = binned.index_select(
            1, torch.as_tensor(rows, dtype=torch.int64,
                               device=binned.device))
    return binned.T.cpu().numpy()


def find_bundles(binned, num_bins: np.ndarray, default_bin: np.ndarray,
                 max_conflict_rate: float, bin_budget: int,
                 sample_cnt: int = 50_000, seed: int = 1) -> FeatureBundles:
    """Greedy conflict-bounded grouping (``FindGroups``,
    ``dataset.cpp:66-135``): try two feature orders (original and by
    descending non-default count) and keep the one with fewer groups.
    Conflicts are counted on a row sample, as the reference counts them
    on its construction sample.  ``binned``: (N, F) numpy, or the port's
    (F, N) tensor."""
    sample = _bundle_sample(binned, sample_cnt, seed)
    S, F = sample.shape
    nz = sample != default_bin[None, :]          # (S, F) non-default
    nz_cnt = nz.sum(axis=0)
    max_error = int(S * max_conflict_rate)

    def greedy(order):
        groups: List[List[int]] = []
        marks: List[np.ndarray] = []
        conflict: List[int] = []
        bins: List[int] = []
        for f in order:
            nb_extra = int(num_bins[f]) - 1
            placed = False
            for g in range(len(groups)):
                if bins[g] + nb_extra > bin_budget:
                    continue
                cnt = int(np.count_nonzero(marks[g] & nz[:, f]))
                if conflict[g] + cnt <= max_error:
                    groups[g].append(f)
                    marks[g] |= nz[:, f]
                    conflict[g] += cnt
                    bins[g] += nb_extra
                    placed = True
                    break
            if not placed:
                groups.append([f])
                marks.append(nz[:, f].copy())
                conflict.append(0)
                bins.append(1 + nb_extra)
        return groups

    g1 = greedy(range(F))
    g2 = greedy(list(np.argsort(-nz_cnt, kind="stable")))
    groups = g2 if len(g2) < len(g1) else g1

    group_id = np.zeros(F, np.int32)
    offsets = np.zeros(F, np.int32)
    gnb = np.zeros(len(groups), np.int32)
    single = np.zeros(len(groups), bool)
    for g, feats in enumerate(groups):
        single[g] = len(feats) == 1
        off = 1  # bundle bin 0 = all-default
        for f in feats:
            group_id[f] = g
            offsets[f] = off
            off += int(num_bins[f]) - 1
        gnb[g] = int(num_bins[feats[0]]) if single[g] else off
    return FeatureBundles(groups=[list(f) for f in groups],
                          group_id=group_id, offsets=offsets,
                          default_bin=np.asarray(default_bin, np.int32),
                          group_num_bins=gnb, is_singleton=single)
