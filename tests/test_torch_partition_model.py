"""A model of the segment partition kernel's row moves
(``csrc/partition_segment.cu``), on the CPU, held against the port's
plain version and the JAX package's Pallas partition in interpret mode.

The kernel compacts a segment into the workspace tile by tile
(``TILE_ROWS`` rows, claimed in order): each tile's lefts go to
``lefts_before + rank`` and its rights, from the back in reverse, to
``count - 1 - (rights_before + rank)``, where ``lefts_before`` is the
sum of the earlier tiles' left counts (the look-back) and
``rights_before = row0 - lefts_before``; in-tile ranks follow 32-row
groups in row order. The copy back moves ``ws[0, NL)`` to the front and
``ws[count - 1 - j]`` to ``NL + j``. The model does the same arithmetic
with numpy (the Pallas kernel's matrix is padded differently, so it is
compared by the row ids it holds); the Python mirrors of the kernels' constants are held
against the C++ sources.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import hist_pallas as jhp
from lightgbm_tpu.ops import partition_pallas as jpp
from lightgbm_tpu_torch.ops import hist_cuda as hc
from lightgbm_tpu_torch.ops import partition_cuda as pc
from lightgbm_tpu_torch.ops import split_scan_cuda as sc
from lightgbm_tpu_torch.ops.partition import rows_go_left

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(pc.__file__), "..", "csrc")


def _constant(fname: str, name: str) -> int:
    with open(os.path.join(CSRC, fname)) as fh:
        m = re.search(rf"constexpr int {name} = (\d+);", fh.read())
    assert m, name
    return int(m.group(1))


def test_tile_rows_mirror_the_kernel():
    threads = _constant("partition_segment.cu", "kThreads")
    items = _constant("partition_segment.cu", "kItems")
    assert pc.TILE_ROWS == threads * items
    # the look-back's warp 0 scans one group a lane: 32 groups a tile
    assert items * threads // 32 == 32
    assert pc.PART_THREADS == _constant("partition_core.cuh", "kPartRows")


def test_scan_block_mirrors_the_kernel():
    # the wrapper's bin limit is the kernel's (past one block of planes,
    # the wide scan's windows of kMaxScanBins); the kernel's largest
    # block is whole warps, within a block's 1024 threads
    assert sc.MAX_SCAN_BINS == _constant("scan_core.cuh", "kMaxWideBins")
    assert _constant("scan_core.cuh", "kScanWindow") \
        == _constant("scan_core.cuh", "kMaxScanBins") == 1024
    top = _constant("split_scan.cu", "kMaxThreads")
    assert 32 <= top <= 1024 and top % 32 == 0


def workspace_rows(left: np.ndarray, tile_rows: int) -> np.ndarray:
    """Each segment row's workspace row, tile by tile as the kernel
    writes it."""
    count = len(left)
    dest = np.empty(count, np.int64)
    lefts_before = 0                          # the look-back's sum
    for row0 in range(0, count, tile_rows):
        tl = left[row0:row0 + tile_rows]
        rights_before = row0 - lefts_before
        # in-tile ranks: 32-row groups in row order, then the lane
        off_l = np.concatenate([[0], np.cumsum(tl)[:-1]])
        off_r = np.arange(len(tl)) - off_l
        dest[row0:row0 + len(tl)] = np.where(
            tl, lefts_before + off_l, count - 1 - (rights_before + off_r))
        lefts_before += int(tl.sum())
    return dest


def copy_back_rows(count: int, nl: int) -> np.ndarray:
    """The workspace row each segment row takes in the copy back."""
    j = np.arange(count)
    return np.where(j < nl, j, count - 1 - (j - nl))


def model_partition(mat: np.ndarray, begin: int, count: int,
                    left: np.ndarray, tile_rows: int) -> np.ndarray:
    out = mat.copy()
    ws = np.zeros_like(mat[:count])
    ws[workspace_rows(left, tile_rows)] = mat[begin:begin + count]
    out[begin:begin + count] = ws[copy_back_rows(count, int(left.sum()))]
    return out


N, F, B = 3000, 6, 32


@pytest.fixture(scope="module")
def packed():
    rng = np.random.RandomState(1)
    binned = rng.randint(0, B, (N, F)).astype(np.uint8)
    grad = rng.randn(N).astype(np.float32)
    hess = np.abs(rng.randn(N)).astype(np.float32)
    cnt = np.ones(N, np.float32)
    jmat = jhp.pack_gh(jhp.build_matrix(jnp.asarray(binned)), F,
                       jnp.asarray(grad), jnp.asarray(hess),
                       jnp.asarray(cnt))
    tmat = hc.pack_gh(hc.build_matrix(torch.from_numpy(binned)), F,
                      torch.from_numpy(grad), torch.from_numpy(hess),
                      torch.from_numpy(cnt))
    return jmat, tmat


@pytest.mark.parametrize("miss", [0, 1, 2])
@pytest.mark.parametrize("seed", range(4))
def test_model_matches_plain_and_pallas(packed, miss, seed):
    """Random segments, thresholds and default directions under each
    missing code, at the kernel's tile size and at small tiles (many
    tiles, so the look-back's sum crosses tiles of all-left and
    all-right rows): the model's matrix equals the plain version's and
    the Pallas kernel's (interpret mode) byte for byte."""
    jmat, tmat = packed
    rng = np.random.RandomState(10 * seed + miss)
    begin = int(rng.randint(0, N // 2))
    count = int(rng.randint(0, N - begin + 1))
    feat, thr = int(rng.randint(0, F)), int(rng.randint(-1, B))
    dl, dbin = int(rng.randint(0, 2)), int(rng.randint(0, B))
    mat = tmat.numpy()
    bins = torch.from_numpy(mat[begin:begin + count, feat].astype(np.int64))
    left = rows_go_left(bins, thr, dl, miss, dbin, B).numpy()
    want = tmat.clone()
    seg = pc.partition_segment_plain(want, None, begin, count, feat, thr,
                                     dl, miss, dbin, B, False, None)
    nl = int(left.sum())
    assert seg.tolist() == [begin, nl, begin + nl, count - nl]
    jm, _, jnl = jpp.partition_segment(
        jmat, jnp.zeros_like(jmat), begin, count, feat, thr, dl, miss, dbin,
        B, 0, jnp.zeros((1, 256), jnp.float32), interpret=True)
    assert int(jnl[0]) == nl
    jrows = np.asarray(jhp.extract_row_ids(jm, F, N))
    for tile_rows in (pc.TILE_ROWS, 64, 1):
        got = model_partition(mat, begin, count, left, tile_rows)
        np.testing.assert_array_equal(got, want.numpy())
        # the JAX matrix has its own padding: compare the rows it holds
        np.testing.assert_array_equal(
            hc.extract_row_ids(torch.from_numpy(got), F, N).numpy(), jrows)


@pytest.mark.parametrize("count", [0, 1, 255, 256, 257, 1023, 1024, 1025,
                                   3 * 1024 + 1])
@pytest.mark.parametrize("pattern", ["random", "all_left", "all_right",
                                     "alternate"])
def test_destinations_are_a_permutation(count, pattern):
    """The workspace rows are a permutation of [0, count): lefts fill
    [0, NL) in row order, rights fill [NL, count) in reverse row order,
    and the copy back restores the stable order."""
    rng = np.random.RandomState(count)
    left = {"random": rng.rand(count) < 0.4,
            "all_left": np.ones(count, bool),
            "all_right": np.zeros(count, bool),
            "alternate": np.arange(count) % 2 == 0}[pattern]
    dest = workspace_rows(left, pc.TILE_ROWS)
    nl = int(left.sum())
    assert sorted(dest.tolist()) == list(range(count))
    np.testing.assert_array_equal(dest[left], np.arange(nl))
    np.testing.assert_array_equal(dest[~left],
                                  np.arange(count - 1, nl - 1, -1))
    ws = np.empty(count, np.int64)
    ws[dest] = np.arange(count)
    order = ws[copy_back_rows(count, nl)]
    ids = np.arange(count)
    np.testing.assert_array_equal(order,
                                  np.concatenate([ids[left], ids[~left]]))
