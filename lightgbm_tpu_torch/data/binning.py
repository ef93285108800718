"""Feature binning: value -> small-integer bin mapping.

Copy of ``lightgbm_tpu/data/binning.py`` (pure numpy) for the PyTorch
port, so both packages bin identically without the port importing the
JAX package.

Re-implements the behavior of the reference ``BinMapper``
(``src/io/bin.cpp:79-533``, ``include/LightGBM/bin.h:58-544``) in
NumPy on the host. Binning runs once at dataset construction; the binned
``uint8``/``uint16`` matrix is what lives in TPU HBM afterwards.

Semantics preserved (file:line refer to the reference):
  * greedy equal-ish-count bin boundaries over distinct sample values
    (``GreedyFindBin`` bin.cpp:79-156), with big-count values given their
    own bin and ``min_data_in_bin`` respected;
  * zero is always its own bin (``FindBinWithZeroAsOneBin`` bin.cpp:257-313)
    split at +-kZeroThreshold;
  * missing handling ``None | Zero | NaN`` (bin.h:26): NaN gets the last
    bin when present and ``use_missing``;
  * forced bounds (``FindBinWithPredefinedBin`` bin.cpp:158-255);
  * categorical: count-sorted category->bin with 99% mass cutoff and
    negative values mapped to the NaN bin (bin.cpp:425-497);
  * trivial-feature pre-filter (``NeedFilter`` bin.cpp:55-77);
  * ``most_freq_bin`` / ``default_bin`` selection (bin.cpp:511-528);
  * ``ValueToBin`` binary search incl. NaN routing (bin.h:503-540).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from ..utils.log import log_warning

kZeroThreshold = 1e-35
kSparseThreshold = 0.7
kMissingZeroMask = 1
kMissingNaNMask = 2

MISSING_NONE = "None"
MISSING_ZERO = "Zero"
MISSING_NAN = "NaN"

BIN_TYPE_NUMERICAL = "numerical"
BIN_TYPE_CATEGORICAL = "categorical"


def _next_after_up(a: float) -> float:
    return math.nextafter(a, math.inf)


def _double_equal_ordered(a: float, b: float) -> bool:
    return b <= _next_after_up(a)


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Greedy equal-count boundary search (bin.cpp:79-156)."""
    num_distinct = len(distinct_values)
    bounds: List[float] = []
    if max_bin <= 0:
        raise ValueError("max_bin must be > 0")
    if num_distinct <= max_bin:
        cur = 0
        for i in range(num_distinct - 1):
            cur += int(counts[i])
            if cur >= min_data_in_bin:
                val = _next_after_up(
                    (float(distinct_values[i]) + float(distinct_values[i + 1]))
                    / 2.0)
                if not bounds or not _double_equal_ordered(bounds[-1], val):
                    bounds.append(val)
                    cur = 0
        bounds.append(math.inf)
        return bounds
    # more distinct values than bins: greedy mean-size packing
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    rest_bin_cnt = max_bin
    rest_sample_cnt = total_cnt
    is_big = counts >= mean_bin_size
    rest_bin_cnt -= int(is_big.sum())
    rest_sample_cnt -= int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin
    lower_bounds[0] = float(distinct_values[0])
    if is_big.any():
        bin_cnt = _greedy_pack(distinct_values, counts, is_big, max_bin,
                               mean_bin_size, rest_bin_cnt, rest_sample_cnt,
                               upper_bounds, lower_bounds)
    else:
        bin_cnt = _greedy_pack_no_big(distinct_values, counts, max_bin,
                                      mean_bin_size, rest_bin_cnt,
                                      rest_sample_cnt, upper_bounds,
                                      lower_bounds)
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _next_after_up((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bounds or not _double_equal_ordered(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def _greedy_pack(distinct_values, counts, is_big, max_bin, mean_bin_size,
                 rest_bin_cnt, rest_sample_cnt, upper_bounds,
                 lower_bounds) -> int:
    """The packing loop of ``greedy_find_bin`` (bin.cpp:119-142), a
    distinct value at a time; returns the bins cut."""
    bin_cnt = 0
    cur = 0
    for i in range(len(distinct_values) - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur += int(counts[i])
        if (is_big[i] or cur >= mean_bin_size
                or (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            upper_bounds[bin_cnt] = float(distinct_values[i])
            bin_cnt += 1
            lower_bounds[bin_cnt] = float(distinct_values[i + 1])
            if bin_cnt >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    return bin_cnt


def _greedy_pack_no_big(distinct_values, counts, max_bin, mean_bin_size,
                        rest_bin_cnt, rest_sample_cnt, upper_bounds,
                        lower_bounds) -> int:
    """``_greedy_pack`` where no distinct value is big (every count
    below the mean bin size: continuous data), a bin at a time: a bin
    ends at the first value where the integer running count reaches the
    float mean (``cur >= mean`` is ``cur >= ceil(mean)``), found by a
    search of the cumulative counts, and the rest count there is the
    total less the cumulative count. The same bounds as the loop."""
    c = np.cumsum(np.asarray(counts, np.int64))
    total = rest_sample_cnt
    last = len(distinct_values) - 2          # the loop's last index
    bin_cnt, start, base = 0, 0, 0
    while True:
        i = max(start, int(np.searchsorted(
            c, base + math.ceil(mean_bin_size), side="left")))
        if i > last:
            return bin_cnt
        upper_bounds[bin_cnt] = float(distinct_values[i])
        bin_cnt += 1
        lower_bounds[bin_cnt] = float(distinct_values[i + 1])
        if bin_cnt >= max_bin - 1:
            return bin_cnt
        rest_bin_cnt -= 1
        mean_bin_size = (total - int(c[i])) / max(rest_bin_cnt, 1)
        start, base = i + 1, int(c[i])


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray,
                                  counts: np.ndarray, max_bin: int,
                                  total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Zero always gets a dedicated bin (bin.cpp:257-313)."""
    num_distinct = len(distinct_values)
    left_cnt_data = int(counts[distinct_values <= -kZeroThreshold].sum())
    right_cnt_data = int(counts[distinct_values > kZeroThreshold].sum())
    cnt_zero = total_sample_cnt - left_cnt_data - right_cnt_data

    left_idx = np.nonzero(distinct_values > -kZeroThreshold)[0]
    left_cnt = int(left_idx[0]) if len(left_idx) else num_distinct

    bounds: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bounds = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                 left_max_bin, left_cnt_data, min_data_in_bin)
        if bounds:
            bounds[-1] = -kZeroThreshold

    right_idx = np.nonzero(distinct_values[left_cnt:] > kZeroThreshold)[0]
    right_start = left_cnt + int(right_idx[0]) if len(right_idx) else -1

    right_max_bin = max_bin - 1 - len(bounds)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(
            distinct_values[right_start:], counts[right_start:],
            right_max_bin, right_cnt_data, min_data_in_bin)
        bounds.append(kZeroThreshold)
        bounds.extend(right_bounds)
    else:
        bounds.append(math.inf)
    assert len(bounds) <= max_bin
    return bounds


def find_bin_with_predefined_bin(distinct_values: np.ndarray,
                                 counts: np.ndarray, max_bin: int,
                                 total_sample_cnt: int, min_data_in_bin: int,
                                 forced_upper_bounds: Sequence[float]
                                 ) -> List[float]:
    """Forced-boundary bin finding (bin.cpp:158-255)."""
    num_distinct = len(distinct_values)
    left_idx = np.nonzero(distinct_values > -kZeroThreshold)[0]
    left_cnt = int(left_idx[0]) if len(left_idx) else num_distinct
    right_idx = np.nonzero(distinct_values[left_cnt:] > kZeroThreshold)[0]
    right_start = left_cnt + int(right_idx[0]) if len(right_idx) else -1

    bounds: List[float] = []
    if max_bin == 2:
        bounds.append(kZeroThreshold if left_cnt == 0 else -kZeroThreshold)
    elif max_bin >= 3:
        if left_cnt > 0:
            bounds.append(-kZeroThreshold)
        if right_start >= 0:
            bounds.append(kZeroThreshold)
    bounds.append(math.inf)

    max_to_insert = max_bin - len(bounds)
    num_inserted = 0
    for fb in forced_upper_bounds:
        if num_inserted >= max_to_insert:
            break
        if abs(fb) > kZeroThreshold:
            bounds.append(float(fb))
            num_inserted += 1
    bounds.sort()

    free_bins = max_bin - len(bounds)
    bounds_to_add: List[float] = []
    value_ind = 0
    n_bounds = len(bounds)
    for i in range(n_bounds):
        cnt_in_bin = 0
        distinct_cnt = 0
        bin_start = value_ind
        while value_ind < num_distinct and \
                distinct_values[value_ind] < bounds[i]:
            cnt_in_bin += int(counts[value_ind])
            distinct_cnt += 1
            value_ind += 1
        bins_remaining = max_bin - n_bounds - len(bounds_to_add)
        num_sub_bins = int(round(cnt_in_bin * free_bins / total_sample_cnt))
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == n_bounds - 1:
            num_sub_bins = bins_remaining + 1
        if distinct_cnt > 0:
            new_bounds = greedy_find_bin(
                distinct_values[bin_start:bin_start + distinct_cnt],
                counts[bin_start:bin_start + distinct_cnt],
                num_sub_bins, cnt_in_bin, min_data_in_bin)
            bounds_to_add.extend(new_bounds[:-1])  # last bound is inf
    bounds.extend(bounds_to_add)
    bounds.sort()
    assert len(bounds) <= max_bin
    return bounds


def _count_in_bins(dv: np.ndarray, cn: np.ndarray,
                   upper: List[float]) -> List[int]:
    """The sample count of each bin (bin.cpp:411-423): the reference
    walks the distinct values and moves to the next bin when a value
    passes the current bin's bound, one bin a value at most, so its bin
    t_i = min(s_i, t_(i-1) + 1), with s_i the value's first bound at or
    above it (a search) and t_(-1) = 0: t_i = min(i + 1, min over j <= i
    of (s_j - j) + i). The same counts as the walk, in numpy."""
    s = np.searchsorted(np.asarray(upper, np.float64), dv, side="left")
    i = np.arange(len(dv), dtype=np.int64)
    t = np.minimum(np.minimum.accumulate(s.astype(np.int64) - i) + i,
                   i + 1)
    return np.bincount(t, weights=np.asarray(cn, np.float64),
                       minlength=len(upper)).astype(np.int64).tolist()


class BinMapper:
    """Per-feature value -> bin mapping (bin.h:58-230)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: str = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: str = BIN_TYPE_NUMERICAL
        self.bin_upper_bound: List[float] = []
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    # ---- FindBin (bin.cpp:326-533) ------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int, min_split_data: int,
                 pre_filter: bool, bin_type: str = BIN_TYPE_NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 forced_upper_bounds: Sequence[float] = ()) -> None:
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        values = values[~nan_mask]
        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NONE if na_cnt == 0 else MISSING_NAN
        if self.missing_type != MISSING_NAN:
            # NaN is folded into the zero/default bin (bin.cpp:337-348 keeps
            # na_cnt = 0 unless missing_type ends up NaN)
            na_cnt = 0

        self.bin_type = bin_type
        self.default_bin = 0
        num_sample_values = len(values)
        zero_cnt = total_sample_cnt - num_sample_values - na_cnt

        # distinct values with implicit zeros merged in (bin.cpp:354-390),
        # vectorized: consecutive values within one float ulp are merged
        # ("use the large value"), matching CheckDoubleEqualOrdered.
        values = np.sort(values, kind="stable")
        if num_sample_values > 0:
            new_grp = np.concatenate(
                [[True], values[1:] > np.nextafter(values[:-1], np.inf)])
            starts = np.nonzero(new_grp)[0]
            ends = np.concatenate([starts[1:], [num_sample_values]])
            dv = values[ends - 1]
            cn = (ends - starts).astype(np.int64)
            # insert the implicit-zero entry at its sorted position
            if zero_cnt > 0:
                if dv[0] > 0.0:
                    pos = 0
                elif dv[-1] < 0.0:
                    pos = len(dv)
                else:
                    pos = int(np.searchsorted(dv, 0.0))
                    if not (0 < pos < len(dv) and dv[pos - 1] < 0.0
                            and dv[pos] > 0.0):
                        pos = -1
                if pos >= 0:
                    dv = np.insert(dv, pos, 0.0)
                    cn = np.insert(cn, pos, zero_cnt)
        else:
            dv = np.asarray([0.0])
            cn = np.asarray([zero_cnt], np.int64)
        # the sorted distinct values and their counts, as host lists for
        # the categorical walk
        distinct_values, counts = dv, cn
        self.min_val = float(dv[0])
        self.max_val = float(dv[-1])

        cnt_in_bin: List[int] = []
        if bin_type == BIN_TYPE_NUMERICAL:
            if self.missing_type == MISSING_NAN:
                eff_max_bin = max_bin - 1
                eff_total = total_sample_cnt - na_cnt
            else:
                eff_max_bin = max_bin
                eff_total = total_sample_cnt
            if forced_upper_bounds:
                self.bin_upper_bound = find_bin_with_predefined_bin(
                    dv, cn, eff_max_bin, eff_total, min_data_in_bin,
                    forced_upper_bounds)
            else:
                self.bin_upper_bound = find_bin_with_zero_as_one_bin(
                    dv, cn, eff_max_bin, eff_total, min_data_in_bin)
            if self.missing_type == MISSING_ZERO \
                    and len(self.bin_upper_bound) == 2:
                self.missing_type = MISSING_NONE
            if self.missing_type == MISSING_NAN:
                self.bin_upper_bound.append(math.nan)
            self.num_bin = len(self.bin_upper_bound)
            # count per bin (bin.cpp:411-423)
            cnt_in_bin = _count_in_bins(dv, cn, self.bin_upper_bound)
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            # categorical (bin.cpp:425-497)
            dvi: List[int] = []
            cni: List[int] = []
            for v, c in zip(distinct_values, counts):
                iv = int(v)
                if iv < 0:
                    na_cnt += int(c)
                    log_warning("Met negative value in categorical features, "
                                "will convert it to NaN")
                else:
                    if not dvi or iv != dvi[-1]:
                        dvi.append(iv)
                        cni.append(int(c))
                    else:
                        cni[-1] += int(c)
            self.num_bin = 0
            rest_cnt = total_sample_cnt - na_cnt
            if rest_cnt > 0:
                order = np.argsort(-np.asarray(cni), kind="stable")
                cni = [cni[i] for i in order]
                dvi = [dvi[i] for i in order]
                if dvi and dvi[0] == 0:
                    if len(cni) == 1:
                        cni.append(0)
                        dvi.append(dvi[0] + 1)
                    cni[0], cni[1] = cni[1], cni[0]
                    dvi[0], dvi[1] = dvi[1], dvi[0]
                cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
                eff_max_bin = min(len(dvi), max_bin)
                self.categorical_2_bin = {}
                self.bin_2_categorical = []
                used_cnt = 0
                cur_cat = 0
                while cur_cat < len(dvi) and (used_cnt < cut_cnt
                                              or self.num_bin < eff_max_bin):
                    if cni[cur_cat] < min_data_in_bin and cur_cat > 1:
                        break
                    self.bin_2_categorical.append(dvi[cur_cat])
                    self.categorical_2_bin[dvi[cur_cat]] = self.num_bin
                    used_cnt += cni[cur_cat]
                    cnt_in_bin.append(cni[cur_cat])
                    self.num_bin += 1
                    cur_cat += 1
                if cur_cat == len(dvi) and na_cnt > 0:
                    self.bin_2_categorical.append(-1)
                    self.categorical_2_bin[-1] = self.num_bin
                    cnt_in_bin.append(0)
                    self.num_bin += 1
                self.missing_type = MISSING_NONE \
                    if (cur_cat == len(dvi) and na_cnt == 0) else MISSING_NAN
                if cnt_in_bin:
                    cnt_in_bin[-1] += total_sample_cnt - used_cnt

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and _need_filter(
                cnt_in_bin, total_sample_cnt, min_split_data, bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = self.value_to_bin(0.0)
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            if bin_type == BIN_TYPE_CATEGORICAL and self.most_freq_bin == 0:
                self.most_freq_bin = 1
            max_sparse_rate = cnt_in_bin[self.most_freq_bin] / total_sample_cnt
            if self.most_freq_bin != self.default_bin \
                    and max_sparse_rate < kSparseThreshold:
                self.most_freq_bin = self.default_bin
            self.sparse_rate = cnt_in_bin[self.most_freq_bin] \
                / total_sample_cnt
        else:
            self.sparse_rate = 1.0

    # ---- ValueToBin (bin.h:503-540), vectorized ------------------------
    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_TYPE_NUMERICAL:
            nan_mask = np.isnan(values)
            safe = np.where(nan_mask, 0.0, values)
            n_search = self.num_bin - (
                1 if self.missing_type == MISSING_NAN else 0)
            bounds = np.asarray(self.bin_upper_bound[:n_search])
            # bin = first index with value <= bound
            bins = np.searchsorted(bounds, safe, side="left")
            # searchsorted(side=left) gives first bound >= value; LightGBM
            # wants first bound with value <= bound, identical for floats
            # except exact-equality, handled by side="left".
            bins = np.minimum(bins, n_search - 1)
            if self.missing_type == MISSING_NAN:
                bins = np.where(nan_mask, self.num_bin - 1, bins)
            elif nan_mask.any():
                # NaN treated as zero when missing is not NaN (bin.h:504-509)
                zero_bin = int(np.minimum(
                    np.searchsorted(bounds, 0.0, side="left"), n_search - 1))
                bins = np.where(nan_mask, zero_bin, bins)
            return bins.astype(np.int32)
        # categorical
        out = np.full(values.shape, self.num_bin - 1, dtype=np.int32)
        iv = values.astype(np.int64, copy=False)
        iv = np.where(np.isnan(values), -1, iv)
        for cat, b in self.categorical_2_bin.items():
            out[iv == cat] = b
        return out

    def value_to_bin(self, value: float) -> int:
        return int(self.values_to_bins(np.asarray([value]))[0])

    # ---- BinToValue (bin.h:106-121) ------------------------------------
    def bin_to_value(self, bin_idx: int) -> float:
        if self.bin_type == BIN_TYPE_NUMERICAL:
            return self.bin_upper_bound[bin_idx]
        return float(self.bin_2_categorical[bin_idx])

    def max_cat_value(self) -> int:
        return max(self.bin_2_categorical) if self.bin_2_categorical else 0

    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin, "missing_type": self.missing_type,
            "is_trivial": self.is_trivial, "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "bin_upper_bound": list(self.bin_upper_bound),
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val, "max_val": self.max_val,
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        for k, v in d.items():
            setattr(m, k, v)
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        return m


def _need_filter(cnt_in_bin: List[int], total_cnt: int, filter_cnt: int,
                 bin_type: str) -> bool:
    """Trivial-feature pre-filter (bin.cpp:55-77)."""
    if bin_type == BIN_TYPE_NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += cnt_in_bin[i]
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True
    if len(cnt_in_bin) <= 2:
        for i in range(len(cnt_in_bin) - 1):
            if cnt_in_bin[i] >= filter_cnt \
                    and total_cnt - cnt_in_bin[i] >= filter_cnt:
                return False
        return True
    return False
