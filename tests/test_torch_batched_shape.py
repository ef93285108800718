"""The block-shape rules of the two model-batched kernels, on the CPU.

``ops/hist_cuda.py`` mirrors ``csrc/hist_rows.cu``'s ``batched_shape``
(the features and models one block of ``hist_rows_batched`` takes, and
its shared bytes) and ``ops/split_step_cuda.py`` the batched leaf
step's shared bytes a model (``kModelSmem``). Here: each mirrored
constant against the C++ source, and the rule's properties at the main
path's shapes (2M x 28 u8 at 255 bins, B 4 and B 8, and u16 at 1023
bins): every block fits two an SM, the widest sub-tile that fits is
taken, the models are spread evenly, and the chunk rule (which fixes
every sum's order) does not depend on the block. The card tests
(``tests/test_torch_kernels_cuda.py``) hold the mirror against the
library's ``ltt_hist_rows_batched_shape``.
"""

import os
import re

import pytest

from lightgbm_tpu_torch.ops import hist_cuda as hc
from lightgbm_tpu_torch.ops import split_step_cuda as ss

CSRC = os.path.join(os.path.dirname(hc.__file__), "..", "csrc")
SMEM_PER_SM = 228 * 1024     # an H100 SM's shared memory
SMEM_RESERVED = 1024         # reserved a block


def _constant(src: str, name: str) -> int:
    with open(os.path.join(CSRC, src)) as fh:
        text = fh.read()
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([0-9* ]+);", text)
    assert m, name
    return int(eval(m.group(1)))  # a product of integer literals


@pytest.mark.parametrize("py,c", [
    ("BATCHED_STEP_ROWS", "kThreads"), ("BATCHED_MAX_MODELS", "kBMaxModels"),
    ("BATCHED_MAX_TILE", "kBMaxTile"), ("BATCHED_SMEM_BYTES", "kBatchedSmem"),
    ("BATCHED_MODEL_BIN_BYTES", "kBModelBinBytes"),
    ("BATCHED_FEATURE_BIN_BYTES", "kBFeatureBinBytes"),
    ("BATCHED_WARP_BIN_BYTES", "kBWarpBinBytes"),
    ("BATCHED_LEADER_BYTES", "kBLeaderBytes"),
    ("BATCHED_STAGE_ROW_BYTES", "kBStageRowBytes")])
def test_hist_mirror_matches_source(py, c):
    src = "hist_ids.cuh" if c == "kThreads" else "hist_rows.cu"
    assert getattr(hc, py) == _constant(src, c)


def test_hist_step_is_a_row_a_thread():
    # kBStep = kThreads (one staged row a thread), kBWarps = kThreads / 32
    with open(os.path.join(CSRC, "hist_rows.cu")) as fh:
        text = fh.read()
    assert "constexpr int kBStep = kThreads;" in text
    assert "constexpr int kBWarps = kThreads / 32;" in text
    assert hc.BATCHED_WARPS == hc.BATCHED_STEP_ROWS // 32


def test_leaf_mirror_matches_source():
    assert ss.LEAF_BATCHED_MODEL_BYTES == _constant("split_step_leaf.cu",
                                                    "kModelSmem")
    with open(os.path.join(CSRC, "split_step_leaf.cu")) as fh:
        text = fh.read()
    assert "constexpr int kGroupModels = 8;" in text
    assert ("constexpr size_t kCompactBytes = 2 * kGroupModels * kThreads "
            "* sizeof(int);") in text
    assert ss.LEAF_BATCHED_COMPACT_BYTES == 2 * 8 * _constant(
        "hist_ids.cuh", "kThreads") * 4
    # the single kernel's bytes (at least the compaction's staging)
    # rounded up to 16, then the models'
    assert ss.leaf_batched_smem_bytes(110_272, 4) == 110_272 + 4 * 144
    assert ss.leaf_batched_smem_bytes(110_270, 1) == 110_272 + 144
    assert ss.leaf_batched_smem_bytes(9_000, 2) == 16_384 + 2 * 144


@pytest.mark.parametrize("bin_bytes,b,models,want", [
    (1, 255, 4, (4, 4)), (1, 255, 8, (2, 8)), (1, 255, 1, (8, 1)),
    (1, 255, 3, (5, 3)), (1, 255, 17, (2, 6)), (1, 63, 8, (7, 8)),
    (2, 1023, 4, (1, 2)), (2, 1023, 8, (1, 3))])
def test_block_shape_at_the_main_shapes(bin_bytes, b, models, want):
    """The widest sub-tile for the most models a block: at 255 bins u8
    (F 28, leaf tile 16) B 4 takes 4 features x 4 models and B 8 2 x 8;
    at 1023 bins u16 each warp's peer words (4 KB) leave room for one
    feature of 2 or 3 models."""
    tile = hc.leaf_feat_tile(28, b, bin_bytes)
    assert hc.rows_batched_block(bin_bytes, b, tile, models) == want


@pytest.mark.parametrize("bin_bytes,b", [(1, 2), (1, 63), (1, 255),
                                         (1, 256), (2, 257), (2, 1023),
                                         (2, 1024)])
@pytest.mark.parametrize("models", [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 64])
def test_block_shape_fits_and_is_widest(bin_bytes, b, models):
    """Every shape fits BATCHED_SMEM_BYTES and two blocks an SM; one
    feature more does not fit (or the cap is reached); the model groups
    are as even as can be and at most BATCHED_MAX_MODELS."""
    tile = hc.leaf_feat_tile(28, b, bin_bytes)
    ft, mb = hc.rows_batched_block(bin_bytes, b, tile, models)
    assert 1 <= mb <= min(models, hc.BATCHED_MAX_MODELS)
    assert 1 <= ft <= min(tile, hc.BATCHED_MAX_TILE)
    smem = hc.rows_batched_smem(bin_bytes, b, ft, mb)
    assert smem <= hc.BATCHED_SMEM_BYTES
    assert 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    assert ft == min(tile, hc.BATCHED_MAX_TILE) or \
        hc.rows_batched_smem(bin_bytes, b, ft + 1, mb) > hc.BATCHED_SMEM_BYTES
    groups = -(-models // mb)
    assert -(-models // groups) == mb


@pytest.mark.parametrize("n", [300, 20_011, 2_000_000])
@pytest.mark.parametrize("models", [1, 4, 8])
def test_blocks_cover_chunks_tiles_and_groups(n, models):
    """The grid is chunks x feature sub-tiles x model groups, the chunks
    those of hist_rows (child_chunks of N with the leaf tile): at 2M rows
    of 28 u8 features the 128 chunks give every slot of the H100's 132
    SMs x 2 a block, and at B 4 and B 8 three."""
    tile = hc.leaf_feat_tile(28, 255, 1)
    ft, mb = hc.rows_batched_block(1, 255, tile, models)
    chunks = hc.leaf_child_chunks(n, 28, tile)
    blocks = hc.rows_batched_blocks(n, 28, 255, 1, models)
    assert blocks == chunks * -(-28 // ft) * -(-models // mb)
    if n == 2_000_000:
        assert chunks == 128
        assert blocks >= (3 if models > 1 else 1) * 132 * 2
