"""The histogram chunk rule shared by the segment histogram kernel and
the segment fused split step (``ops/hist_cuda.py`` ``child_chunks``,
``csrc/hist_tile.cuh``), on the CPU.

The rule cuts a segment into row chunks from its row count alone, so
both kernels sum every bin in the same order on any card. Here: the
Python mirror against the C++ constants, the bound by the partial
buffers, and a numpy model of the kernels' summation order (float64:
32-row groups, lane-ordered sums, chunks in order, rounded once) held
against the JAX package's histogram at the tolerance of
``test_torch_hist.py`` (|diff| <= 2e-5 * sum|value| against the Pallas
kernel in interpret mode, whose bf16 hi/lo payload keeps about 16
mantissa bits) and against the port's plain version bit for bit.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import hist_pallas as jhp
from lightgbm_tpu.ops.histogram import make_ghc
from lightgbm_tpu_torch.ops import hist_cuda as hc

N, F, B = 3000, 10, 64
CSRC = os.path.join(os.path.dirname(hc.__file__), "..", "csrc")


def _constant(name: str) -> int:
    with open(os.path.join(CSRC, "hist_tile.cuh")) as fh:
        m = re.search(rf"constexpr int {name} = (\d+);", fh.read())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("py,c", [("CHUNK_ROWS", "kChunkRows"),
                                  ("CHUNK_SLOTS", "kChunkSlots")])
def test_mirror_matches_source(py, c):
    assert getattr(hc, py) == _constant(c)


def test_tile_and_step_follow_the_block():
    # kTileFeatures = kHistWarps (one feature a warp) and kStepRows =
    # kHistThreads (one row a thread)
    threads = _constant("kHistThreads")
    assert hc.TILE_FEATURES == threads // 32
    assert hc.STEP_ROWS == threads


@pytest.mark.parametrize("count", [0, 1, 255, 256, 257, 1024, 1025,
                                   66 * 256, 66 * 256 + 1, 10 ** 7])
@pytest.mark.parametrize("f", [1, 8, 28, 130])
def test_chunks_from_the_counts(count, f):
    """ceil(count / CHUNK_ROWS) chunks, at least 1 and at most
    max_chunks(F), with chunks x feature tiles within CHUNK_SLOTS;
    chunks of ceil(count / chunks) rows cover the segment, and past the
    cap a chunk takes more than CHUNK_ROWS rows."""
    cap = hc.max_chunks(f)
    tiles = -(-f // hc.TILE_FEATURES)
    assert cap == max(1, hc.CHUNK_SLOTS // tiles)
    assert cap * tiles <= hc.CHUNK_SLOTS or cap == 1
    c = hc.child_chunks(count, f)
    assert c == max(1, min(cap, -(-count // hc.CHUNK_ROWS)))
    chunk = -(-count // c)
    assert 1 <= c <= cap and c * chunk >= count
    assert (chunk <= hc.CHUNK_ROWS) == (count <= cap * hc.CHUNK_ROWS)


@pytest.mark.parametrize("max_count", [1, 1024, 1025, 60_000, 270_337,
                                       2_000_000])
def test_chunks_fit_the_partials(max_count):
    """A segment of any count up to the host's bound takes no more
    chunks than the partials sized from that bound hold
    (``histogram_segment``), nor than the fused step's scratch holds
    (max_chunks(F)); the rule is monotone in the count."""
    alloc = hc.child_chunks(max_count, F)
    counts = np.unique(np.linspace(0, max_count, 97).astype(int))
    chunks = [hc.child_chunks(int(c), F) for c in counts]
    assert max(chunks) <= alloc <= hc.max_chunks(F)
    assert all(a <= b for a, b in zip(chunks, chunks[1:]))


@pytest.mark.parametrize("b", [1, 16, 64, 255, 256])
def test_two_blocks_an_sm(b):
    """A histogram block's shared memory (float64 bins of its 8-feature
    tile and one staged step) leaves room for two blocks on an H100 SM
    (228 KB, 1 KB reserved a block, ~1 KB static)."""
    assert 2 * (hc.hist_smem_bytes(b) + 2048) <= 228 * 1024


def chunked_histogram(binned, ghc, begin, count, b, feat_tile):
    """A numpy model of the kernels' summation order: chunks from the
    row and feature counts (``child_chunks``), each summed in float64 in 32-row groups
    whose lanes of one bin add in lane order, each group's sum added to
    the chunk's bin; the chunks added in chunk order and the total
    rounded once to float32. Features in tiles of ``feat_tile``, which
    must not change a bit."""
    f = binned.shape[1]
    rows = np.arange(begin, begin + count)
    chunks = hc.child_chunks(count, f)
    size = -(-count // chunks) if count else 0
    vals = ghc.astype(np.float32).astype(np.float64)
    total = None
    for c in range(chunks):
        part = np.zeros((f, b, 3))
        for f0 in range(0, f, feat_tile):
            for base in range(c * size, min(count, (c + 1) * size), 32):
                grp = rows[base:min(base + 32, (c + 1) * size, count)]
                for j in range(f0, min(f, f0 + feat_tile)):
                    gs = np.zeros((b, 3))
                    np.add.at(gs, binned[grp, j], vals[grp])
                    hit = np.unique(binned[grp, j])
                    part[j, hit] += gs[hit]
        total = part if total is None else total + part
    return total.astype(np.float32)


@pytest.fixture(scope="module")
def packed():
    rng = np.random.RandomState(5)
    binned = rng.randint(0, B, (N, F)).astype(np.uint8)
    binned[:, 3] = np.minimum(binned[:, 3], 2)          # crowded bins
    grad = rng.randn(N).astype(np.float32)
    hess = (np.abs(rng.randn(N)) + 0.1).astype(np.float32)
    ghc = np.array(make_ghc(jnp.asarray(grad), jnp.asarray(hess)))
    jmat = jhp.pack_gh(jhp.build_matrix(jnp.asarray(binned)), F,
                       ghc[:, 0], ghc[:, 1], ghc[:, 2])
    return binned, ghc, jmat


@pytest.mark.parametrize("begin,count", [(0, 256), (7, 257),
                                         (3, 2048 + 257), (0, N)])
def test_chunked_order_matches_jax(packed, begin, count):
    """The model of the kernels' order, in tiles of 4 and 8 (the
    kernels') features and of all of them, is bitwise the same across
    tilings, within the Pallas
    kernel's tolerance of the JAX package's histogram, and bitwise the
    plain version's (float64 sums rounded once)."""
    binned, ghc, jmat = packed
    ref = np.asarray(jhp.histogram_segment(jmat, begin, count, B, F,
                                           interpret=True))
    outs = [chunked_histogram(binned, ghc, begin, count, B, t)
            for t in (4, 8, F)]
    for o in outs[1:]:
        assert o.tobytes() == outs[0].tobytes()
    scale = np.zeros((F, B, 3))
    seg = np.abs(ghc[begin:begin + count].astype(np.float64))
    for j in range(F):
        np.add.at(scale[j], binned[begin:begin + count, j], seg)
    assert np.all(np.abs(outs[0] - ref) <= 2e-5 * scale + 1e-30)
    np.testing.assert_array_equal(outs[0][..., 2], ref[..., 2])
    plain = hc.histogram_segment_plain(
        hc.pack_gh(hc.build_matrix(torch.from_numpy(binned)), F,
                   torch.from_numpy(ghc[:, 0]), torch.from_numpy(ghc[:, 1]),
                   torch.from_numpy(ghc[:, 2])),
        begin, count, B, F).numpy()
    assert outs[0].tobytes() == plain.tobytes()
