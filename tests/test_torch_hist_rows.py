"""The port's full-range histogram (``lightgbm_tpu_torch/ops/hist_cuda.py``
``histogram_rows``, kernel ``csrc/hist_rows.cu``) on the CPU, where it
runs its plain version, against the JAX package's ``histogram_pallas``
(``lightgbm_tpu/ops/hist_pallas.py:642``, in interpret mode) and
``build_histogram``.

Tolerances, per bin, as ``tests/test_torch_hist.py`` holds the segment
histogram: against the Pallas kernel |diff| <= 2e-5 * sum|value| (its
bf16 hi/lo payload keeps about 16 mantissa bits); against the float32
scatter |diff| <= 1e-6 * sum|value|. Counts are exact. Against the
port's own masked-ghc ``build_histogram`` the id-list mode is bitwise
(rows with zero ghc add nothing to a float64 sum).

Also here: the numpy model of the kernel's summation order (512-row
chunks from the row, feature and tile counts, 32-row groups summed in
lane order, chunks in order, float64 rounded once) against the plain
version bit for bit; the model of the kernel's loop
(``tests/torch_hist_model.py``: peer words, integer counts) against it;
the integer count against the float64 sum of 0/1 count columns; the
tile against the one the order was fixed with; and the Python mirror of
the constants against ``csrc/hist_ids.cuh``. The serial learner on these
histograms: ``tests/test_torch_serial.py``.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import hist_pallas as jhp
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch.ops import _native
from lightgbm_tpu_torch.ops import hist_cuda as hc
from lightgbm_tpu_torch.ops.histogram import build_histogram
from torch_hist_model import kernel_histogram

torch.set_num_threads(2)
N, F = 3000, 10
CSRC = os.path.join(os.path.dirname(hc.__file__), "..", "csrc")


def _inputs(b, seed):
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if b <= 256 else np.uint16
    binned = rng.randint(0, b, (N, F)).astype(dtype)
    binned[:, 2] = np.minimum(binned[:, 2], 3)          # crowded bins
    grad = rng.randn(N).astype(np.float32)
    hess = (np.abs(rng.randn(N)) + 0.1).astype(np.float32)
    bag = (rng.rand(N) < 0.8).astype(np.float32)
    ghc = np.array(jh.make_ghc(jnp.asarray(grad), jnp.asarray(hess),
                               jnp.asarray(bag)))
    held = torch.from_numpy(binned.view(np.int16) if dtype == np.uint16
                            else binned)
    return binned, ghc, held, torch.from_numpy(ghc)


def _abs_scale(binned, ghc, b, rows=None):
    rows = np.arange(N) if rows is None else rows
    out = np.zeros((F, b, 3))
    vals = np.abs(ghc[rows].astype(np.float64))
    for j in range(F):
        np.add.at(out[j], binned[rows, j], vals)
    return out


@pytest.fixture(scope="module")
def u8():
    return _inputs(64, 0)


@pytest.fixture(scope="module")
def u16():
    return _inputs(600, 1)


def test_matches_histogram_pallas_interpret(u8):
    binned, ghc, held, tghc = u8
    ref = np.asarray(jhp.histogram_pallas(jnp.asarray(binned),
                                          jnp.asarray(ghc), 64,
                                          interpret=True))
    got = hc.histogram_rows_plain(held, tghc, 64).numpy()
    assert got.shape == ref.shape == (F, 64, 3)
    scale = _abs_scale(binned, ghc, 64)
    assert np.all(np.abs(got - ref) <= 2e-5 * scale + 1e-30)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    # the wrapper takes the plain version for a CPU tensor, uncounted
    before = _native.LAUNCHES["hist_rows"]
    assert hc.histogram_rows(held, tghc, 64).numpy().tobytes() \
        == got.tobytes()
    assert _native.LAUNCHES["hist_rows"] == before


@pytest.mark.parametrize("method", ["scatter", "onehot"])
def test_u16_matches_jax_build_histogram(u16, method):
    """600 bins (u16, held as int16 bits): beyond what the Pallas
    function takes (u8), the same function as the JAX package's other
    ``build_histogram`` methods."""
    binned, ghc, held, tghc = u16
    ref = np.asarray(jh.build_histogram(jnp.asarray(binned),
                                        jnp.asarray(ghc), 600,
                                        method=method))
    got = hc.histogram_rows(held, tghc, 600).numpy()
    scale = _abs_scale(binned, ghc, 600)
    assert np.all(np.abs(got - ref) <= 1e-6 * scale + 1e-30)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])


def _ids(case):
    rng = np.random.RandomState(11)
    if case == "empty":
        return np.zeros(0, np.int32)
    if case == "one_row":
        return np.array([1234], np.int32)
    if case == "first_and_last":
        return np.array([0, N - 1], np.int32)
    if case == "all":
        return np.arange(N, dtype=np.int32)
    return np.flatnonzero(rng.rand(N) < 0.37).astype(np.int32)


@pytest.mark.parametrize("case", ["empty", "one_row", "first_and_last",
                                  "subset", "all"])
@pytest.mark.parametrize("width", ["u8", "u16"])
def test_id_list_equals_masked_histogram(u8, u16, width, case):
    """The id-list mode (a per-phase child's rows in row order) equals
    ``build_histogram`` over ghc masked to those rows, bit for bit."""
    binned, ghc, held, tghc = u8 if width == "u8" else u16
    b = 64 if width == "u8" else 600
    ids = _ids(case)
    mask = torch.zeros(N)
    mask[torch.from_numpy(ids).long()] = 1.0
    want = build_histogram(held, tghc * mask[:, None], b)
    got = hc.histogram_rows(held, tghc, b, torch.from_numpy(ids))
    assert got.numpy().tobytes() == want.numpy().tobytes()
    if case == "empty":
        assert not got.any()
    # every feature counts the listed rows' count channel once
    np.testing.assert_array_equal(got[..., 2].sum(1).numpy(),
                                  np.full(F, ghc[ids, 2].sum(), np.float32))


def _constant(name: str) -> int:
    with open(os.path.join(CSRC, "hist_ids.cuh")) as fh:
        m = re.search(rf"constexpr int {name} = (\d+);", fh.read())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("py,c", [("LEAF_CHUNK_ROWS", "kChunkRows"),
                                  ("LEAF_MAX_VBLOCKS", "kMaxVBlocks"),
                                  ("LEAF_STAGE_ROWS", "kStageRows"),
                                  ("LEAF_MAX_TILE", "kMaxTile"),
                                  ("LEAF_BIN_BYTES", "kBinBytes"),
                                  ("LEAF_STAGE_ROW_BYTES",
                                   "kStageRowBytes")])
def test_mirror_matches_source(py, c):
    assert getattr(hc, py) == _constant(c)


@pytest.mark.parametrize("f,b,bb", [(28, 1023, 2), (28, 255, 1), (10, 64, 1),
                                    (10, 600, 2), (130, 1024, 2)])
@pytest.mark.parametrize("count", [0, 1, 511, 512, 513, 3000, 40_000,
                                   2_000_000])
def test_chunks_from_the_counts(f, b, bb, count):
    """ceil(count / 512) chunks, at least 1 and at most
    leaf_max_chunks(F, tile) (chunks x feature tiles <= 256), covering
    the list; past the cap a chunk takes more than 512 rows; the
    partials hold every count's chunks."""
    tile = hc.leaf_feat_tile(f, b, bb)
    cap = hc.leaf_max_chunks(f, tile)
    tiles = -(-f // tile)
    assert cap * tiles <= hc.LEAF_MAX_VBLOCKS or cap == 1
    c = hc.leaf_child_chunks(count, f, tile)
    assert c == max(1, min(cap, -(-count // hc.LEAF_CHUNK_ROWS)))
    chunk = -(-count // c)
    assert c * chunk >= count
    assert (chunk <= hc.LEAF_CHUNK_ROWS) == (count <= cap
                                             * hc.LEAF_CHUNK_ROWS)
    held = torch.zeros((1, f), dtype=torch.uint8 if bb == 1
                       else torch.int16)
    assert hc.rows_partial(held, b).shape == (cap, f, b, 3)


TILE_WALK = [(b, bb) for b in (1, 16, 255, 256, 600, 1023, 1024)
             for bb in (1, 2) if not (bb == 1 and b > 256)]


def test_tile_fits_two_blocks_an_sm():
    """The tile's shared memory (the bins' float64 (g, h) pairs and
    integer (peer word, count) pairs, one staged step) stays within the
    leaf kernel's budget for two blocks an SM, and within the bytes of
    the tile rule (24 a bin, 12 a staged row)."""
    for b, bb in TILE_WALK:
        t = hc.leaf_feat_tile(28, b, bb)
        smem = hc.leaf_tile_smem_bytes(t, b, bb)
        assert smem <= t * b * 24 + hc.LEAF_STAGE_ROWS * (12 + t * bb)
        assert smem <= hc.LEAF_SMEM_BYTES
        # the shape the H100's 227 KB a block and 228 KB an SM allow
        assert 2 * (smem + 1024) <= 228 * 1024


# leaf_feat_tile as it was before the peer-word tile: the tile sets the
# chunk cap, so a changed tile would change the order of every sum
TILE_BEFORE = {28: {(1, 1): 16, (1, 2): 16, (16, 1): 16, (16, 2): 16,
                 (255, 1): 16, (255, 2): 14, (256, 1): 16, (256, 2): 14,
                 (600, 2): 6, (1023, 2): 4, (1024, 2): 4},
            10: {(1, 1): 10, (1, 2): 10, (16, 1): 10, (16, 2): 10,
                 (255, 1): 10, (255, 2): 10, (256, 1): 10, (256, 2): 10,
                 (600, 2): 6, (1023, 2): 4, (1024, 2): 4},
            130: {(1, 1): 16, (1, 2): 16, (16, 1): 16, (16, 2): 16,
                  (255, 1): 16, (255, 2): 14, (256, 1): 16, (256, 2): 14,
                  (600, 2): 6, (1023, 2): 4, (1024, 2): 4}}


@pytest.mark.parametrize("f", [28, 10, 130])
def test_tile_unchanged(f):
    """``leaf_feat_tile`` at every (B, width) the budget test walks is
    the tile the order was fixed with."""
    assert {k: hc.leaf_feat_tile(f, *k) for k in TILE_WALK} == TILE_BEFORE[f]


def chunked_histogram(binned, ghc, rows, b, feat_tile, model_tile):
    """A numpy model of the kernel's summation order over ``rows`` (a
    list in row order): leaf_child_chunks chunks of the list (the tile
    ``feat_tile`` sets the cap), each summed in float64 in 32-row groups
    from the chunk's start whose lanes of one bin add in lane order,
    each group's sum added to the chunk's bin; the chunks added in
    order and the total rounded once to float32. Features are walked in
    tiles of ``model_tile``, which must not change a bit."""
    f = binned.shape[1]
    count = len(rows)
    chunks = hc.leaf_child_chunks(count, f, feat_tile)
    size = -(-count // chunks) if count else 0
    vals = ghc.astype(np.float32).astype(np.float64)
    total = np.zeros((f, b, 3))
    for c in range(chunks):
        part = np.zeros((f, b, 3))
        lo, hi = min(count, c * size), min(count, (c + 1) * size)
        for f0 in range(0, f, model_tile):
            for base in range(lo, hi, 32):
                grp = rows[base:min(base + 32, hi)]
                for j in range(f0, min(f, f0 + model_tile)):
                    gs = np.zeros((b, 3))
                    np.add.at(gs, binned[grp, j], vals[grp])
                    hit = np.unique(binned[grp, j])
                    part[j, hit] += gs[hit]
        total = part if c == 0 else total + part
    return total.astype(np.float32)


@pytest.mark.parametrize("rows", ["all", "one_chunk", "one_row_over",
                                  "subset"])
@pytest.mark.parametrize("width", ["u8", "u16"])
def test_chunked_order_matches_plain(u8, u16, width, rows):
    """The model of the kernel's order, in tiles of 1, 4 and all
    features, is bitwise the same across tilings and bitwise the plain
    version's (float64 sums rounded once) on this data; with all rows it
    is within the Pallas kernel's tolerance of ``histogram_pallas``."""
    binned, ghc, held, tghc = u8 if width == "u8" else u16
    b = 64 if width == "u8" else 600
    tile = hc.leaf_feat_tile(F, b, 1 if width == "u8" else 2)
    sel = {"all": np.arange(N), "one_chunk": np.arange(7, 7 + 512),
           "one_row_over": np.arange(3, 3 + 513),
           "subset": np.flatnonzero(np.random.RandomState(2).rand(N)
                                    < 0.6)}[rows]
    outs = [chunked_histogram(binned, ghc, sel, b, tile, t)
            for t in (1, 4, F)]
    for o in outs[1:]:
        assert o.tobytes() == outs[0].tobytes()
    plain = hc.histogram_rows_plain(held, tghc, b, torch.from_numpy(
        sel.astype(np.int32)))
    assert outs[0].tobytes() == plain.numpy().tobytes()
    if rows == "all" and width == "u8":
        ref = np.asarray(jhp.histogram_pallas(
            jnp.asarray(binned), jnp.asarray(ghc), b, interpret=True))
        scale = _abs_scale(binned, ghc, b)
        assert np.all(np.abs(outs[0] - ref) <= 2e-5 * scale + 1e-30)


@pytest.mark.parametrize("rows", ["all", "one_row_over", "subset"])
@pytest.mark.parametrize("width", ["u8", "u16"])
def test_kernel_loop_model_matches_order_model(u8, u16, width, rows):
    """The model of the kernel's loop (peer words, the lowest lane's
    walk, integer counts; ``tests/torch_hist_model.py``, which the card
    tests hold the kernel against) is bitwise the order model above."""
    binned, ghc, held, tghc = u8 if width == "u8" else u16
    b = 64 if width == "u8" else 600
    tile = hc.leaf_feat_tile(F, b, 1 if width == "u8" else 2)
    sel = {"all": np.arange(N), "one_row_over": np.arange(3, 3 + 513),
           "subset": np.flatnonzero(np.random.RandomState(2).rand(N)
                                    < 0.6)}[rows]
    got = kernel_histogram(binned, ghc, sel, b, tile)
    assert got.tobytes() == chunked_histogram(binned, ghc, sel, b, tile,
                                              tile).tobytes()


@pytest.mark.parametrize("column", ["bagged", "all_zero", "all_one"])
@pytest.mark.parametrize("width", ["u8", "u16"])
def test_integer_count_equals_float_sum(u8, u16, width, column):
    """The kernel counts the rows whose count is not 0, in integers; on a
    0/1 count column (``make_ghc``'s, every caller's) that is the
    float64 sum the plain version takes, an all-zero column included."""
    binned, ghc, held, tghc = u8 if width == "u8" else u16
    b = 64 if width == "u8" else 600
    ghc = ghc.copy()
    ghc[:, 2] = {"bagged": ghc[:, 2], "all_zero": 0.0,
                 "all_one": 1.0}[column]
    assert set(np.unique(ghc[:, 2])) <= {0.0, 1.0}
    tile = hc.leaf_feat_tile(F, b, 1 if width == "u8" else 2)
    rows = np.arange(N)
    got = kernel_histogram(binned, ghc, rows, b, tile)[..., 2]
    plain = hc.histogram_rows_plain(held, torch.from_numpy(ghc), b)[..., 2]
    want = np.zeros((F, b))
    for j in range(F):
        np.add.at(want[j], binned[:, j], ghc[:, 2].astype(np.float64))
    assert got.tobytes() == plain.numpy().tobytes()
    assert got.tobytes() == want.astype(np.float32).tobytes()
    assert got.sum() == F * ghc[:, 2].sum()


def test_kernel_refuses_what_it_does_not_take(u8):
    """Checks that need no card: the bin dtype of the leaf layout."""
    _, _, held, tghc = u8
    with pytest.raises(TypeError):
        hc.leaf_bin_bytes(held.to(torch.int64))
    assert hc.leaf_bin_bytes(held) == 1
    assert hc.leaf_bin_bytes(held.to(torch.int16)) == 2
    # int32: the device copy past 32,768 bins
    assert hc.leaf_bin_bytes(held.to(torch.int32)) == 4
