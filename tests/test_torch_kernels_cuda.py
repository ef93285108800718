"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: without a CUDA device (or without nvcc) every
test here skips. On a card: ``python -m pytest tests/test_torch_kernels_cuda.py``.
``chip_smoke.py`` runs the same checks at full width."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

N, F, B = 20_000, 12, 256


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from lightgbm_tpu_torch.ops import _native
    try:
        _native.library()
    except RuntimeError as e:   # no nvcc on this machine
        pytest.skip(str(e))
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mat(dev):
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    g = torch.Generator(device=dev).manual_seed(0)
    binned = torch.randint(0, B, (N, F), generator=g, device=dev)
    m = hc.build_matrix(binned.to(torch.uint8))
    hc.pack_gh(m, F, torch.randn(N, generator=g, device=dev),
               torch.rand(N, generator=g, device=dev),
               torch.ones(N, device=dev))
    return m


@pytest.mark.parametrize("begin,count", [
    (0, N), (3, 12_345), (N - 1, 1), (77, 0),
    (0, 256),      # one chunk exactly (hist_cuda.CHUNK_ROWS)
    (5, 257),      # one row over: two chunks
])
def test_histogram_kernel_matches_plain(mat, begin, count):
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    out = hc.histogram_segment(mat, begin, count, B, F)
    ref = hc.histogram_segment_plain(mat, begin, count, B, F)
    scale = hc.histogram_segment_plain(mat, begin, count, B, F,
                                       absolute=True)
    assert bool(((out - ref).abs() <= 1e-5 * scale + 1e-6).all())
    assert torch.equal(out, hc.histogram_segment(mat, begin, count, B, F))


@pytest.mark.parametrize("count", [256, 257, None],
                         ids=["one_chunk", "one_row_over", "chunk_cap"])
def test_histogram_kernel_device_segment(dev, count):
    """A segment given on the device with a larger bound (a child sized
    by its parent, as the per-phase path launches it) sums bitwise as
    with its own count: the chunks come from the count on the device.
    The last case (None) passes the chunk cap (max_chunks(F) chunks of
    more than CHUNK_ROWS rows)."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    if count is None:
        count = hc.max_chunks(F) * hc.CHUNK_ROWS + 1
    n = count + 2_000
    m = _matrix(dev, n, F, B, 4)
    begin = 1_001
    seg = torch.tensor([begin, count], dtype=torch.int32, device=dev)
    out = hc.histogram_segment(m, begin, count, B, F)
    bound = hc.histogram_segment(m, seg, None, B, F, max_count=n)
    assert _same_bytes(out, bound)
    ref = hc.histogram_segment_plain(m, begin, count, B, F)
    scale = hc.histogram_segment_plain(m, begin, count, B, F,
                                       absolute=True)
    assert bool(((out - ref).abs() <= 1e-5 * scale + 1e-6).all())
    assert torch.equal(out[..., 2], ref[..., 2])


@pytest.mark.parametrize("miss,is_cat", [(0, False), (1, False),
                                         (2, False), (0, True)])
def test_partition_kernel_matches_plain(mat, miss, is_cat):
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    bits = np.zeros(8, np.uint32)
    bits[0] = 0x0F0F0F0F
    lut = pc.bitset_to_lut(bits).to(mat.device)
    m1, m2 = mat.clone(), mat.clone()
    args = (5, N - 9, 4, 100, 1, miss, 60, B, is_cat, lut)
    s1 = pc.partition_segment(m1, torch.empty_like(m1), *args)
    s2 = pc.partition_segment_plain(m2, None, *args)
    assert torch.equal(s1, s2) and torch.equal(m1, m2)


def test_scan_kernel_matches_plain(mat):
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    hists = [hc.histogram_segment(mat, 0, 9000, B, F),
             hc.histogram_segment(mat, 9000, N - 9000, B, F)]
    leaves = [tuple(h[0].sum(0).cpu().numpy()) + (-np.inf, np.inf)
              for h in hists]
    meta = sp.FeatureMeta(
        num_bins=np.full(F, B, np.int32),
        missing=(np.arange(F) % 3).astype(np.int32),
        default_bin=np.full(F, 100, np.int32),
        most_freq_bin=np.zeros(F, np.int32),
        monotone=np.zeros(F, np.int32), penalty=np.ones(F, np.float32),
        is_categorical=np.zeros(F, bool))
    meta_t = sp.meta_tensors(meta, mat.device)
    params = sp.SplitParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0, True)
    k = sc.per_feature_numerical_cuda(hists, leaves, meta_t, params)
    p = sc.per_feature_numerical_plain(hists, leaves, meta_t, params)
    assert torch.equal(k[..., sp.O_THR], p[..., sp.O_THR])
    assert _same_bytes(k, p)


def _matrix(dev, n, f, b, seed, block=None):
    """A random [n, f] u8 training matrix with gradients. ``block``: the
    rows of a random subset of that size take bin 0 of feature 0 and the
    others its top bin, and the gradient is mostly the subset (features
    1-3 carry a smaller linear signal), so the root split sends exactly
    ``block`` rows to its smaller child and later splits still gain."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    g = torch.Generator(device=dev).manual_seed(seed)
    binned = torch.randint(0, b, (n, f), generator=g, device=dev)
    # real signal, so that splits keep positive gains for many steps
    y = (binned[:, 0].float() / b + 0.3 * torch.rand(n, generator=g,
                                                    device=dev) > 0.6)
    if block is not None:
        rows = torch.randperm(n, generator=g, device=dev)[:block]
        binned[:, 0] = b - 1
        binned[rows, 0] = 0
        y = (binned[:, 0] == 0).float() \
            + 0.3 * (binned[:, 1:4].float().sum(1) / b - 1.5)
    m = hc.build_matrix(binned.to(torch.uint8))
    hc.pack_gh(m, f, y.float() - 0.5 + 0.01 * torch.randn(
        n, generator=g, device=dev), 0.2 + 0.05 * torch.rand(
        n, generator=g, device=dev), torch.ones(n, device=dev))
    return m


def _fused_root(mat, f, b, big_l, max_depth=-1, monotone=False):
    """Root state of a tree on ``mat`` ([k, S, T, mat copy, hist]), the
    metadata tables and the step's keyword arguments."""
    from lightgbm_tpu_torch.learner.split_step import (SEG_SI_PREFIX,
                                                       make_grow_pack,
                                                       root_state)
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    dev, n = mat.device, mat.shape[0]
    mono = np.zeros(f, np.int32)
    if monotone:
        mono[:2] = (1, -1)
    meta = sp.FeatureMeta(
        num_bins=np.full(f, b, np.int32),
        missing=(np.arange(f) % 3).astype(np.int32),
        default_bin=np.full(f, b // 2, np.int32),
        most_freq_bin=np.zeros(f, np.int32), monotone=mono,
        penalty=np.ones(f, np.float32), is_categorical=np.zeros(f, bool))
    params = sp.SplitParams(0.1, 1.0, 0.0, 20.0, 1e-3, 0.0, True)
    hist = torch.zeros((big_l, f, b, 3), device=dev)
    hist[0] = hc.histogram_segment(mat, 0, n, b, f)
    sums = hist[0, 0].sum(0).cpu().numpy()
    table = sc.per_feature_numerical_cuda(
        [hist[0]], [tuple(sums) + (-np.inf, np.inf)],
        sp.meta_tensors(meta, dev), params)[0]
    pack = make_grow_pack(SEG_SI_PREFIX, has_monotone=monotone, big_l=big_l)
    st = root_state(pack, table, *sums, n, params, big_l)
    k = torch.ones((1,), dtype=torch.int32, device=dev)
    imeta, fmeta = ss.pack_meta_tables(meta, None, dev)
    kw = dict(params=params, big_l=big_l, max_depth=max_depth, b=b, f=f,
              has_monotone=monotone)
    return [k, st["S"], st["T"], mat.clone(), hist], imeta, fmeta, kw


def _same_bytes(a, b):
    return a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()


@pytest.mark.parametrize("n,f,b,max_depth,monotone,block", [
    (N, F, B, -1, False, None),
    (30_000, 40, 256, -1, False, None),   # two feature tiles in the kernel
    (5_000, 5, 16, 3, True, None),        # few bins, depth cap, monotone
    # the root's smaller child is one chunk exactly (CHUNK_ROWS rows),
    # then one row over it (two chunks)
    (16_384, F, B, -1, False, 256),
    (16_384, F, B, -1, False, 257),
    # the root's smaller child past the chunk cap (max_chunks(F) chunks);
    # the root's segment goes through the workspace, later ones are held
    (600_000, F, B, -1, False, 290_000),
    # 80-byte rows: every segment goes through the workspace
    (30_000, 60, 256, -1, False, None),
], ids=["base", "feature_tiles", "small_bins", "one_chunk_child",
        "one_row_over", "chunk_cap", "wide_rows"])
def test_fused_step_kernel_matches_plain(dev, n, f, b, max_depth,
                                         monotone, block):
    """Consecutive splits of one tree through the fused kernel and
    through its plain version fed the per-phase histogram kernel: k, S,
    T, the matrix and the histogram cache bitwise equal after each, so
    the fused histogram equals the per-phase kernel's bit for bit; and
    the kernel again from the same state, bitwise the same."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    mat = _matrix(dev, n, f, b, 1, block)
    big_l = 31
    state, imeta, fmeta, kw = _fused_root(mat, f, b, big_l, max_depth,
                                          monotone)
    plain = [t.clone() for t in state]
    ws = torch.empty_like(mat)

    def per_phase_hist(m, begin, count, max_count):
        return hc.histogram_segment(m, begin, count, b, f,
                                    max_count=max_count)
    for _ in range(big_l - 1):
        again = [t.clone() for t in state]
        ss.fused_split_step_segment(*state[:3], state[3], ws, state[4],
                                    imeta, fmeta, **kw)
        ss.fused_split_step_segment(*again[:3], again[3], ws, again[4],
                                    imeta, fmeta, **kw)
        ss.fused_split_step_segment_plain(*plain[:3], plain[3], ws,
                                          plain[4], imeta, fmeta,
                                          histogram=per_phase_hist, **kw)
        torch.cuda.synchronize()
        for name, a, p, r in zip(("k", "S", "T", "mat", "hist"), state,
                                 plain, again):
            assert _same_bytes(a, p), (int(plain[0][0]), name)
            assert _same_bytes(a, r), (int(plain[0][0]), name, "again")
        if block is not None and int(state[0][0]) == 2:
            cnt = ss.state_rows(monotone) - ss.STATE_INT_ROWS["segment"]
            sizes = state[1][cnt + 1, :2].view(torch.int32).tolist()
            assert min(sizes) == block
    assert int(state[0][0]) > 4


@pytest.mark.parametrize("case", ["k_at_L", "gain_zero"])
def test_fused_step_kernel_stops(mat, case):
    """A launch whose grow-loop condition fails changes nothing."""
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    state, imeta, fmeta, kw = _fused_root(mat, F, B, 31)
    if case == "k_at_L":
        state[0][0] = 31
    else:
        state[1][3, 0] = 0.0   # bs_gain of the only open leaf
    before = [t.clone() for t in state]
    ss.fused_split_step_segment(*state[:3], state[3],
                                torch.empty_like(mat), state[4], imeta,
                                fmeta, **kw)
    torch.cuda.synchronize()
    for a, p in zip(before, state):
        assert _same_bytes(a, p)


@pytest.mark.parametrize("b", [1, 31, 32, 33, 255, 256, 1023, 1024,
                               1025, 2048, 4095, 4096, 9400, 12000,
                               32767, 32768, 32769, 65536])
def test_scan_kernel_matches_plain_wide(dev, b):
    """The scan kernel at up to 256 bins (static planes), past it
    (dynamic) and past 1024 bins (windows of 1024 with a float64 carry),
    across the 32-bin segments of its block prefix scan: bitwise equal
    to the plain version, whose ``_cumsum`` adds in the same order."""
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    n, f = 40_000, 10
    g = torch.Generator(device=dev).manual_seed(3)
    binned = torch.randint(0, b, (n, f), generator=g, device=dev)
    ghc = torch.stack([torch.randn(n, generator=g, device=dev)
                       + (binned[:, 0] > b // 2).float(),
                       torch.rand(n, generator=g, device=dev) + 0.1,
                       torch.ones(n, device=dev)], dim=1)
    hists = [build_histogram(binned[:n // 3], ghc[:n // 3], b),
             build_histogram(binned[n // 3:], ghc[n // 3:], b)]
    leaves = [tuple(h[0].sum(0).cpu().numpy()) + (-np.inf, np.inf)
              for h in hists]
    meta = sp.FeatureMeta(
        num_bins=np.full(f, b, np.int32),
        missing=(np.arange(f) % 3).astype(np.int32),
        default_bin=np.full(f, b // 3, np.int32),
        most_freq_bin=np.zeros(f, np.int32),
        monotone=np.zeros(f, np.int32), penalty=np.ones(f, np.float32),
        is_categorical=np.zeros(f, bool))
    meta_t = sp.meta_tensors(meta, dev)
    params = sp.SplitParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0, True)
    k = sc.per_feature_numerical_cuda(hists, leaves, meta_t, params)
    p = sc.per_feature_numerical_plain(hists, leaves, meta_t, params)
    assert torch.equal(k[..., sp.O_THR], p[..., sp.O_THR])
    assert torch.equal(k[..., sp.O_DLEFT], p[..., sp.O_DLEFT])
    assert _same_bytes(k, p)
    if b > 2:
        assert bool(torch.isfinite(k[..., sp.O_SCORE]).any())


def _leaf_root(dev, n, f, b, big_l, max_depth=-1, monotone=False, seed=2,
               layout="random"):
    """Root state of a serial tree on random [n, f] bins: ([k, S, T,
    lid, hist], binned, ghc, imeta, fmeta, step kwargs). ``layout``
    "sorted" makes feature 0 rise with the row index (a split on it
    leaves whole row ranges, so whole blocks of the kernel's grid,
    without a member); "outlier" gives one row the top bin of feature 0
    and a large gradient, with min_data_in_leaf 1, so the first split
    sends that one row to its own leaf."""
    from lightgbm_tpu_torch.learner.split_step import (make_grow_pack,
                                                       root_state)
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    from lightgbm_tpu_torch.ops.histogram import build_histogram, make_ghc
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev)
    if layout == "sorted":
        bins[:, 0] = torch.arange(n, device=dev) * b // n
    if layout == "outlier":
        bins[:, 0] = torch.randint(0, b - 1, (n,), generator=g, device=dev)
        bins[7, 0] = b - 1
    y = (bins[:, 0].float() / b + 0.3 * torch.rand(n, generator=g,
                                                   device=dev) > 0.6)
    grad = y.float() - 0.5 + 0.01 * torch.randn(n, generator=g, device=dev)
    if layout == "outlier":
        grad[7] = 2000.0
    ghc = make_ghc(grad, 0.2 + 0.05 * torch.rand(n, generator=g,
                                                 device=dev))
    binned = bins.to(torch.uint8 if b <= 256 else torch.int16)
    mono = np.zeros(f, np.int32)
    if monotone:
        mono[:2] = (1, -1)
    meta = sp.FeatureMeta(
        num_bins=np.full(f, b, np.int32),
        missing=(np.arange(f) % 3).astype(np.int32),
        default_bin=np.full(f, b // 2, np.int32),
        most_freq_bin=np.zeros(f, np.int32), monotone=mono,
        penalty=np.ones(f, np.float32), is_categorical=np.zeros(f, bool))
    params = sp.SplitParams(0.1, 1.0, 0.0,
                            1.0 if layout == "outlier" else 20.0, 1e-3, 0.0,
                            True)
    hist = torch.zeros((big_l, f, b, 3), device=dev)
    hist[0] = build_histogram(binned, ghc, b)
    sums = hist[0, 0].sum(0).cpu().numpy()
    table = sc.per_feature_numerical_cuda(
        [hist[0]], [tuple(sums) + (-np.inf, np.inf)],
        sp.meta_tensors(meta, dev), params)[0]
    pack = make_grow_pack((), has_monotone=monotone, big_l=big_l)
    st = root_state(pack, table, *sums, n, params, big_l)
    k = torch.ones((1,), dtype=torch.int32, device=dev)
    lid = torch.zeros(n, dtype=torch.int32, device=dev)
    imeta, fmeta = ss.pack_meta_tables(meta, None, dev)
    kw = dict(params=params, big_l=big_l, max_depth=max_depth, b=b,
              has_monotone=monotone)
    return [k, st["S"], st["T"], lid, hist], binned, ghc, imeta, fmeta, kw


def _assert_leaf_states_agree(got, want, nf, ghc_abs_hist, what):
    """k, lid and the int rows of S and T bitwise; float rows at rtol
    1e-5 / atol 1e-5; the cache within 1e-5 x the bins' sum of |x| over
    all rows (a bin of any leaf sums a subset of them), counts exact."""
    k, S, T, lid, hist = (t.cpu() for t in got)
    k2, S2, T2, lid2, hist2 = (t.cpu() for t in want)
    assert torch.equal(k, k2), what
    assert torch.equal(lid, lid2), what
    for a, b, n_float in ((S, S2, nf), (T, T2, 4)):
        assert a[n_float:].numpy().tobytes() == b[n_float:].numpy().tobytes(), what
        np.testing.assert_allclose(a[:n_float].numpy(), b[:n_float].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=what)
    assert torch.equal(hist[..., 2], hist2[..., 2]), what
    assert bool(((hist - hist2).abs() <= 1e-5 * ghc_abs_hist + 1e-6).all()), what


@pytest.mark.parametrize("n,f,b,max_depth,monotone,layout", [
    (20_000, 12, 256, -1, False, "random"),    # u8 bins
    (30_000, 40, 1024, -1, False, "random"),   # u16 bins, feature tiles
    (5_000, 5, 16, 3, True, "random"),         # few bins, depth, monotone
    # every child fits one histogram chunk (the direct cache write)
    (3_000, 12, 1024, -1, False, "random"),
    # the root's smaller child (~20k rows) spreads over the chunk cap
    # (130 features at 1024 bins: 33 feature tiles, 7 chunks of 512)
    (40_000, 130, 1024, -1, False, "random"),
    # a 1-row child: the first split isolates one row
    (20_011, 12, 256, -1, False, "outlier"),
    # splits on a sorted feature leave whole blocks without a member;
    # N is a multiple of neither 32 nor 256
    (50_003, 12, 1024, -1, False, "sorted"),
    (20_011, 9, 255, 4, True, "sorted"),       # u8, depth, monotone
], ids=["u8", "u16_feature_tiles", "small_bins", "one_chunk",
        "chunk_cap", "one_row_child", "sorted_u16", "sorted_u8_depth"])
def test_fused_leaf_kernel_matches_plain(dev, n, f, b, max_depth, monotone,
                                         layout):
    """30 consecutive splits of one tree: each split runs through the
    leaf kernel and through its plain version from the same state, and
    the kernel's state carries on to the next split."""
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    big_l = 31
    state, binned, ghc, imeta, fmeta, kw = _leaf_root(
        dev, n, f, b, big_l, max_depth, monotone, layout=layout)
    if layout == "outlier":
        # the root's split sends the one outlier row to its own leaf
        step = [t.clone() for t in state]
        ss.fused_split_step_leaf(*step, binned, ghc, imeta, fmeta, **kw)
        assert int((step[3] == step[3][7]).sum()) == 1
    scale = build_histogram(binned, ghc.abs(), b).cpu()
    nf = ss.state_rows(monotone, "leaf") - ss.STATE_INT_ROWS["leaf"]
    scratch = ss.LeafScratch(binned, b)
    for _ in range(big_l - 1):
        plain = [t.clone() for t in state]
        ss.fused_split_step_leaf(*state, binned, ghc, imeta, fmeta,
                                 scratch=scratch, **kw)
        again = [t.clone() for t in plain]
        ss.fused_split_step_leaf(*again, binned, ghc, imeta, fmeta,
                                 scratch=scratch, **kw)
        ss.fused_split_step_leaf_plain(*plain, binned, ghc, imeta, fmeta,
                                       **kw)
        torch.cuda.synchronize()
        for a, p in zip(state, again):   # bitwise repeatable
            assert _same_bytes(a, p), int(plain[0][0])
        _assert_leaf_states_agree(state, plain, nf, scale,
                                  f"split {int(plain[0][0]) - 1}")
    assert int(state[0][0]) > 4


@pytest.mark.parametrize("case", ["k_at_L", "gain_zero"])
def test_fused_leaf_kernel_stops(dev, case):
    """A launch whose grow-loop condition fails changes nothing."""
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    state, binned, ghc, imeta, fmeta, kw = _leaf_root(dev, 20_000, 12,
                                                      1024, 31)
    if case == "k_at_L":
        state[0][0] = 31
    else:
        state[1][3, 0] = 0.0   # bs_gain of the only open leaf
    before = [t.clone() for t in state]
    ss.fused_split_step_leaf(*state, binned, ghc, imeta, fmeta, **kw)
    torch.cuda.synchronize()
    for a, p in zip(before, state):
        assert _same_bytes(a, p)


def _bins_ghc(dev, n, f, b, seed):
    """Random [n, f] bins (u8 up to 256 bins, the int16 bits of u16 up
    to 32,768, else int32) and ghc [n, 3] with a 0/1 count channel."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev)
    bins[:, 1] = torch.clamp(bins[:, 1], max=2)       # crowded bins
    ghc = torch.stack([torch.randn(n, generator=g, device=dev),
                       torch.rand(n, generator=g, device=dev) + 0.1,
                       (torch.rand(n, generator=g, device=dev) < 0.9)
                       .float()], dim=1)
    return bins.to(torch.uint8 if b <= 256 else torch.int16
                   if b <= 32768 else torch.int32), ghc


def _hist_rows_agree(binned, ghc, b, ids=None):
    """The hist_rows kernel against its plain version: bitwise
    repeatable, counts exact, sums within 1e-5 x the bin's sum of
    |values| + 1e-6 (the float64 sums in another order than the
    plain version's, each rounded once)."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    out = hc.histogram_rows(binned, ghc, b, ids)
    again = hc.histogram_rows(binned, ghc, b, ids)
    ref = hc.histogram_rows_plain(binned, ghc, b, ids)
    scale = hc.histogram_rows_plain(binned, ghc.abs(), b, ids)
    torch.cuda.synchronize()
    assert _same_bytes(out, again)
    assert torch.equal(out[..., 2], ref[..., 2])
    assert bool(((out - ref).abs() <= 1e-5 * scale + 1e-6).all())
    return out


@pytest.mark.parametrize("b", [255, 1023], ids=["u8", "u16"])
@pytest.mark.parametrize("n", [300, 513, 20_011, None],
                         ids=["below_one_chunk", "one_row_over",
                              "n_not_multiple_of_32", "past_chunk_cap"])
def test_hist_rows_kernel_matches_plain(dev, b, n):
    """All rows: below one chunk (LEAF_CHUNK_ROWS), one row over it, an
    N that is a multiple of neither 32 nor a chunk, and past the chunk
    cap (leaf_max_chunks chunks of more than LEAF_CHUNK_ROWS rows)."""
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    f = 12
    if n is None:
        tile = hc.leaf_feat_tile(f, b)
        n = hc.leaf_max_chunks(f, tile) * hc.LEAF_CHUNK_ROWS + 1
    binned, ghc = _bins_ghc(dev, n, f, b, 5)
    before = _native.LAUNCHES["hist_rows"]
    _hist_rows_agree(binned, ghc, b)
    assert _native.LAUNCHES["hist_rows"] == before + 2


@pytest.mark.parametrize("b", [2048, 4095, 9400, 9500, 12000, 32769, 65536])
@pytest.mark.parametrize("ids", [False, True], ids=["all", "third"])
def test_hist_rows_kernel_wide_bins(dev, b, ids):
    """``hist_rows`` past 1024 bins: a tile of one feature from ~4,400
    bins on, and past ~9,400 one window of a feature's bins a block
    (int32 bins past 32,768), all rows and a list of a third of them,
    against its plain version; past the chunk cap, so the partials'
    reduce runs."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    f = 5
    n = hc.leaf_max_chunks(f, hc.leaf_feat_tile(f, b)) \
        * hc.LEAF_CHUNK_ROWS + 1
    binned, ghc = _bins_ghc(dev, n, f, b, 7)
    sel = torch.arange(0, n, 3, device=dev, dtype=torch.int32) \
        if ids else None
    out = _hist_rows_agree(binned, ghc, b, sel)
    assert int(out[..., 2].sum()) == int(
        (ghc[:, 2] if sel is None else ghc[sel.long(), 2]).sum()) * f
    wide = hc.histogram_rows(binned, ghc, b, sel, float64=True)
    plain = hc.histogram_rows_plain(binned, ghc, b, sel, float64=True)
    torch.cuda.synchronize()
    assert wide.dtype == torch.float64
    assert torch.equal(wide.float(), out)
    assert bool(((wide - plain).abs() <= 1e-9 * plain.abs().sum() + 1e-9)
                .all())


@pytest.mark.parametrize("b", [255, 1023], ids=["u8", "u16"])
@pytest.mark.parametrize("case", ["empty", "one_row", "third", "all"])
def test_hist_rows_kernel_id_list(dev, b, case):
    """A list of row ids in row order: empty (all zeros), one row, a
    random third of the rows, every row (bitwise the all-rows mode: the
    same rows in the same order)."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    n, f = 30_001, 12
    binned, ghc = _bins_ghc(dev, n, f, b, 6)
    g = torch.Generator(device=dev).manual_seed(9)
    pick = {"empty": torch.zeros(n, dtype=torch.bool, device=dev),
            "one_row": torch.arange(n, device=dev) == 12_345,
            "third": torch.rand(n, generator=g, device=dev) < 1 / 3,
            "all": torch.ones(n, dtype=torch.bool, device=dev)}[case]
    ids = torch.nonzero(pick).flatten().to(torch.int32)
    out = _hist_rows_agree(binned, ghc, b, ids)
    if case == "empty":
        assert not bool(out.any())
    if case == "all":
        assert _same_bytes(out, hc.histogram_rows(binned, ghc, b))


@pytest.mark.parametrize("n,f,b", [(20_000, 12, 256), (30_000, 40, 1024),
                                   (3_000, 12, 1023)],
                         ids=["u8", "u16_feature_tiles", "one_chunk"])
def test_hist_rows_equals_fused_leaf_child(dev, n, f, b):
    """The id-list histogram of a split's smaller child (its rows in row
    order, as the per-phase loop passes them) equals, bitwise, the child
    row one ``fused_split_step_leaf`` launch writes into the cache: the
    two kernels share the row loop and the chunk rule (hist_ids.cuh)."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    state, binned, ghc, imeta, fmeta, kw = _leaf_root(dev, n, f, b, 31)
    scratch = ss.LeafScratch(binned, b)
    checked = 0
    for _ in range(12):
        lid_old = state[3].clone()
        k = int(state[0][0])
        ss.fused_split_step_leaf(*state, binned, ghc, imeta, fmeta,
                                 scratch=scratch, **kw)
        torch.cuda.synchronize()
        if int(state[0][0]) != k + 1:
            break
        lid = state[3]
        moved = lid != lid_old
        leaf = int(lid_old[moved][0]) if bool(moved.any()) else None
        if leaf is None:
            continue
        n_left = int((lid == leaf).sum())
        n_right = int(moved.sum())
        small = leaf if n_left <= n_right else k
        ids = torch.nonzero(lid == small).flatten().to(torch.int32)
        h = hc.histogram_rows(binned, ghc, b, ids)
        torch.cuda.synchronize()
        assert _same_bytes(h, state[4][small]), (k, small, ids.numel())
        checked += 1
    assert checked >= 8


@pytest.mark.parametrize("b", [255, 1023, 1024],
                         ids=["u8", "u16", "u16_1024"])
@pytest.mark.parametrize("case", ["all", "list", "crowded_all",
                                  "crowded_list"])
def test_hist_rows_kernel_matches_loop_model(dev, b, case):
    """All-rows and list modes bitwise against the numpy model of the
    kernel's loop (``tests/torch_hist_model.py``, which the CPU tests
    hold bitwise to the summation-order model ``chunked_histogram``):
    several chunks, a tile of fewer features than warps, and the count
    channel counted. "crowded": every row of feature 0 in bin b - 1 and
    of feature 1 in bin 0, so all 32 lanes of every group share one
    peer word, with some count bits 0."""
    from torch_hist_model import kernel_histogram

    from lightgbm_tpu_torch.ops import hist_cuda as hc
    n, f = 5_003, 6
    binned, ghc = _bins_ghc(dev, n, f, b, 12)
    if case.startswith("crowded"):
        binned[:, 0] = b - 1
        binned[:, 1] = 0
    rows = np.arange(n)
    ids = None
    if case.endswith("list"):
        rows = np.flatnonzero(np.random.RandomState(4).rand(n) < 0.4)
        ids = torch.from_numpy(rows.astype(np.int32)).to(dev)
    out = hc.histogram_rows(binned, ghc, b, ids)
    torch.cuda.synchronize()
    host = binned.cpu().numpy()
    host = host.view(np.uint16) if host.dtype == np.int16 else host
    want = kernel_histogram(host, ghc.cpu().numpy(), rows, b,
                            hc.leaf_feat_tile(f, b))
    assert out.cpu().numpy().tobytes() == want.tobytes()
    if case.startswith("crowded"):
        assert float(out[0, b - 1, 2]) == float(ghc[rows, 2].sum())


def _scan_inputs(dev, b, f=10, seed=5, empty=None):
    """Two children's [f, b, 3] histograms of random bins; ``empty``: a
    bin range no row falls in (candidates there tie)."""
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    n = 40_000
    g = torch.Generator(device=dev).manual_seed(seed)
    binned = torch.randint(0, b, (n, f), generator=g, device=dev)
    if empty is not None:
        lo, hi = empty
        binned = torch.where((binned >= lo) & (binned < hi),
                             binned - lo, binned)
    ghc = torch.stack([torch.randn(n, generator=g, device=dev)
                       + (binned[:, 0] > b // 2).float()
                       - 0.5 * (binned[:, 1] > b // 3).float(),
                       torch.rand(n, generator=g, device=dev) + 0.1,
                       torch.ones(n, device=dev)], dim=1)
    return [build_histogram(binned[:n // 3], ghc[:n // 3], b),
            build_histogram(binned[n // 3:], ghc[n // 3:], b)]


def _scan_meta(b, f, default_bin, monotone=None, nbins=None):
    from lightgbm_tpu_torch.ops import split as sp
    return sp.FeatureMeta(
        num_bins=np.full(f, b, np.int32) if nbins is None
        else np.asarray(nbins, np.int32),
        missing=(np.arange(f) % 3).astype(np.int32),
        default_bin=np.full(f, default_bin, np.int32),
        most_freq_bin=np.zeros(f, np.int32),
        monotone=np.zeros(f, np.int32) if monotone is None
        else np.asarray(monotone, np.int32),
        penalty=np.linspace(0.5, 1.5, f).astype(np.float32),
        is_categorical=np.zeros(f, bool))


@pytest.mark.parametrize("case,b", [
    ("one_leaf", 255), ("one_leaf", 1023),
    ("regularized", 255), ("regularized", 1023),
    ("ties", 255), ("ties", 1023),
    ("all_invalid", 255), ("all_invalid", 1023),
])
def test_scan_kernel_cases(dev, case, b):
    """The scan kernel against its plain version, every column of the
    [K, F, 8] table bitwise: one leaf (K = 1); L1 + max_delta_step +
    monotone bounds + a masked feature; ties (an empty bin range, so
    neighbouring thresholds of a direction and the two directions score
    the same: the right-to-left scan wins with its largest threshold);
    and features none of whose candidates is valid (min_data past the
    leaf; a 2-bin NaN feature), whose rows still match."""
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    f = 10
    hists = _scan_inputs(dev, b, f, empty=(b // 4, b // 2)
                         if case == "ties" else None)
    leaves = [tuple(h[0].sum(0).cpu().numpy()) + (-np.inf, np.inf)
              for h in hists]
    meta = _scan_meta(b, f, b // 3)
    params = sp.SplitParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0, True)
    mask = None
    if case == "one_leaf":
        hists, leaves = hists[:1], leaves[:1]
    elif case == "regularized":
        meta = _scan_meta(b, f, b // 3, monotone=[(i % 4 == 0) -
                                                  (i % 3 == 0)
                                                  for i in range(f)])
        params = sp.SplitParams(0.5, 1.0, 0.7, 20.0, 1e-3, 0.0, True)
        leaves[1] = leaves[1][:3] + (np.float32(-0.05), np.float32(0.05))
        mask = np.ones(f, bool)
        mask[4] = False
    elif case == "ties":
        meta = _scan_meta(b, f, b // 4 + 3)   # zero-missing: an empty bin
    elif case == "all_invalid":
        nbins = np.full(f, b, np.int32)
        nbins[2] = 2                          # NaN-missing, 2 bins
        meta = _scan_meta(b, f, b // 3, nbins=nbins)
        params = sp.SplitParams(0.0, 1.0, 0.0, 1e9, 1e-3, 0.0, True)
    meta_t = sp.meta_tensors(meta, dev, mask)
    k = sc.per_feature_numerical_cuda(hists, leaves, meta_t, params)
    p = sc.per_feature_numerical_plain(hists, leaves, meta_t, params)
    assert k.shape == (len(hists), f, 8)
    assert _same_bytes(k, p)
    finite = torch.isfinite(k[..., sp.O_SCORE])
    if case == "all_invalid":
        assert not bool(finite.any())
    else:
        assert bool(finite.any())


@pytest.mark.parametrize("b", [33, 255, 1023])
@pytest.mark.parametrize("threads", [32, 64, 192, 512])
def test_scan_kernel_any_block_size(dev, b, threads):
    """The winner does not depend on how the bins are dealt to threads:
    any block size gives the plain version's bytes (fewer than six
    warps take several planes each)."""
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    f = 10
    hists = _scan_inputs(dev, b, f, seed=b)
    leaves = [tuple(h[0].sum(0).cpu().numpy()) + (-np.inf, np.inf)
              for h in hists]
    meta_t = sp.meta_tensors(_scan_meta(b, f, b // 3), dev)
    params = sp.SplitParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0, True)
    k = sc.per_feature_numerical_profile(hists, leaves, meta_t, params,
                                         threads=threads)
    p = sc.per_feature_numerical_plain(hists, leaves, meta_t, params)
    assert _same_bytes(k, p)
    times = torch.zeros((2, f, 5), dtype=torch.int64, device=dev)
    timed = sc.per_feature_numerical_profile(hists, leaves, meta_t, params,
                                             threads=threads, times=times)
    assert _same_bytes(timed, p)
    t = times.cpu().numpy()
    assert (np.diff(t, axis=-1) >= 0).all() and (t[..., 0] > 0).all()


def _partition_pair(m, begin, count, args, lut):
    """The kernel and the plain version on copies of ``m``: both
    matrices and both segment tensors bitwise equal."""
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    m1, m2 = m.clone(), m.clone()
    feat, thr, dl, miss, dbin, nbins, is_cat = args
    s1 = pc.partition_segment(m1, torch.empty_like(m1), begin, count, feat,
                              thr, dl, miss, dbin, nbins, is_cat, lut)
    s2 = pc.partition_segment_plain(m2, None, begin, count, feat, thr, dl,
                                    miss, dbin, nbins, is_cat, lut)
    torch.cuda.synchronize()
    assert torch.equal(s1, s2), (s1.tolist(), s2.tolist())
    assert _same_bytes(m1, m2)
    return m1, s1


PARTITION_EDGES = {  # (n, begin, count, (feat, thr, dl, miss, dbin, B, cat))
    "one_row": (4_000, 0, 1, (2, 100, 0, 0, 0, B, False)),
    "tile_255": (4_000, 0, 255, (2, 100, 0, 0, 0, B, False)),
    "tile_256": (4_000, 0, 256, (2, 100, 1, 1, 60, B, False)),
    "tile_257": (4_000, 0, 257, (2, 100, 0, 2, 0, B, False)),
    "tiles_1023_1024_1025": (4_000, 0, 3_073, (3, 128, 1, 2, 0, B, False)),
    "begin_one_row": (4_000, 1_001, 1, (2, 100, 0, 0, 0, B, False)),
    "begin_257": (4_000, 1_001, 257, (2, 100, 0, 1, 99, B, False)),
    "all_left": (20_000, 17, 19_000, (4, B - 1, 0, 0, 0, B, False)),
    "all_right": (20_000, 17, 19_000, (4, -1, 0, 0, 0, B, False)),
    "lut": (20_000, 3, 19_990, (5, 0, 0, 0, 0, B, True)),
    "empty": (4_000, 77, 0, (2, 100, 0, 0, 0, B, False)),
    "two_million": (2_003_000, 2_999, 2_000_000,
                    (6, 120, 1, 1, 64, B, False)),
    # 64- and 80-byte rows (4 and 5 vectors a row in the warps' copy)
    "rows_64": (20_000, 9, 19_000, (33, 100, 0, 2, 0, B, False)),
    "rows_80": (20_000, 9, 19_000, (50, 100, 1, 1, 30, B, False)),
}
PARTITION_FEATURES = {"two_million": 28, "rows_64": 40, "rows_80": 60}


@pytest.mark.parametrize("case", list(PARTITION_EDGES))
def test_partition_kernel_edges(dev, case):
    """The partition at its tiles' and look-back's edges (counts 1, 255,
    256, 257, three tiles and one row, 2M rows; a nonzero begin; all
    rows left, all right; the LUT; an empty segment; rows of 32, 48, 64
    and 80 bytes): the matrix and the segment tensor bitwise the plain
    version's."""
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    n, begin, count, args = PARTITION_EDGES[case]
    f = PARTITION_FEATURES.get(case, F)
    m = _matrix(dev, n, f, B, 11)
    assert m.shape[1] == {28: 48, 40: 64, 60: 80}.get(f, 32)
    bits = np.zeros(8, np.uint32)
    bits[0], bits[3] = 0x0F0F0F0F, 0x80000001
    _partition_pair(m, begin, count, args, pc.bitset_to_lut(bits).to(dev))


def test_partition_kernel_reuses_its_scratch(dev):
    """Calls in a row on one scratch (the tile states carry each call's
    epoch; the copy back resets the tile counter): each matches the
    plain version, the scratch is not reallocated, its counter is 0
    after every call, and a call is two kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.ops import partition_cuda as pc
    m = _matrix(dev, 50_000, F, B, 12)
    _partition_pair(m, 0, 50_000, (1, 60, 0, 0, 0, B, False), None)
    scratch = pc._SCRATCH[m.device][0]
    ptr = scratch.data_ptr()
    m2, _ = _partition_pair(m, 0, 50_000, (1, 60, 0, 0, 0, B, False), None)
    # the children of that split, split again on another feature
    m3, seg = _partition_pair(m2, 0, 30_000, (2, 200, 1, 1, 7, B, False),
                              None)
    _partition_pair(m3, int(seg[2]), 50_000 - int(seg[2]),
                    (3, 10, 0, 2, 0, B, False), None)
    assert pc._SCRATCH[m.device][0].data_ptr() == ptr
    assert int(scratch[0]) == 0
    ws = torch.empty_like(m)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pc.partition_segment(m.clone(), ws, 0, 50_000, 1, 60, 0, 0, 0, B,
                             False)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "part_" in e.name]
    assert len(names) == 2, names


# ---- TreeSHAP (csrc/tree_shap.cu) --------------------------------------

def _golden_shap(name, rows=300):
    import os
    from golden_common import DATASETS
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "fixtures", "golden",
                           f"model_{name}.txt")) as f:
        text = f.read()
    X = DATASETS[name]["make"]()[2][:rows]
    X = X.todense() if hasattr(X, "todense") else X
    return text, np.asarray(X, np.float64)


@pytest.mark.parametrize("name", ["binary", "categorical", "monotone",
                                  "multiclass", "rank", "regression_l1",
                                  "sparse_efb", "tweedie", "weighted"])
def test_tree_shap_kernel_matches_plain(dev, name):
    """The kernel against its plain version on every golden model:
    1e-9 relative (float64, sums in another order), and
    ``Booster.predict(pred_contrib=True)`` on the card goes through it."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops.tree_shap_cuda import tree_shap
    from lightgbm_tpu_torch.predictor import tree_shap_plain
    text, X = _golden_shap(name)
    bst = lt.Booster(model_str=text, device=dev)
    k = bst.num_model_per_iteration()
    before = _native.LAUNCHES["tree_shap"]
    out = tree_shap(bst.models, torch.from_numpy(X).to(dev), k)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["tree_shap"] == before + 1
    ref = tree_shap_plain(bst.models, torch.from_numpy(X), k).numpy()
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=1e-9,
                               atol=1e-12)
    got = bst.predict(X, pred_contrib=True).reshape(len(X), -1)
    assert _native.LAUNCHES["tree_shap"] == before + 2
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("which", ["repeats", "long"])
def test_tree_shap_kernel_deep_chains(dev, which):
    """A chain repeating one feature on 37 of its 40 nodes (paths of 5
    elements), and a chain of 40 distinct features (paths of up to 41
    elements: the long-path kernel)."""
    from lightgbm_tpu_torch.ops.tree_shap_cuda import tree_shap
    from lightgbm_tpu_torch.predictor import tree_shap_plain
    from torch_shap_model import chain_rows, chain_tree
    if which == "repeats":
        f = 4
        tree = chain_tree([0] * 36 + [1, 2, 3, 0],
                          list(np.linspace(-1.5, 1.5, 36))
                          + [0.1, -0.2, 0.3, 1.8])
    else:
        f = 40
        tree = chain_tree(list(range(f)), list(0.05 * np.arange(f) - 1.0),
                          seed=2)
    x = chain_rows(f, n=300)
    out = tree_shap([tree], torch.from_numpy(x).to(dev), 1)
    ref = tree_shap_plain([tree], torch.from_numpy(x), 1)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("which", ["mixed", "trained", "repeats", "long"])
def test_tree_shap_kernel_repeatable(dev, which):
    """Two launches give the same contributions to the bit (no float
    atomics: every slot's adds run in bin order, then lane order), and
    both are within 1e-9 of the plain version: on chains of 3-20 distinct
    features whose paths (2-21 elements) share bins, on a trained model,
    and on the deep chains (the long-path kernel after the bin kernel)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops.tree_shap_cuda import ShapModel, \
        tree_shap_cuda
    from lightgbm_tpu_torch.predictor import tree_shap_plain
    from torch_shap_model import chain_rows, chain_tree
    f = 40 if which == "long" else 24
    if which == "mixed":
        models = [chain_tree(list(range(m)),
                             list(0.1 * np.arange(m) - 0.9), seed=m)
                  for m in (3, 7, 12, 20, 5, 9)]
    elif which == "trained":
        rng = np.random.RandomState(5)
        X = rng.randn(20_000, f)
        y = (X[:, 0] + X[:, 1] * X[:, 2] - X[:, 3] > 0).astype(float)
        models = lt.train({"objective": "binary", "num_leaves": 63,
                           "verbosity": -1}, lt.Dataset(X, label=y), 4,
                          device="cpu").models
    elif which == "repeats":
        models = [chain_tree([0] * 36 + [1, 2, 3, 0],
                             list(np.linspace(-1.5, 1.5, 36))
                             + [0.1, -0.2, 0.3, 1.8])]
    else:
        models = [chain_tree(list(range(f)),
                             list(0.05 * np.arange(f) - 1.0), seed=2)]
    x = chain_rows(f, n=3_000)
    sm = ShapModel(models, 1, dev)
    if which == "mixed":
        lens = sm.paths["lens"]
        assert any(len({int(lens[q]) for q in b}) > 1 for b in sm.bins)
    xd = torch.from_numpy(x).to(dev)
    a = tree_shap_cuda(sm, xd)
    b = tree_shap_cuda(sm, xd)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = tree_shap_plain(models, torch.from_numpy(x), 1).numpy()
    np.testing.assert_allclose(a.cpu().numpy(), ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("k,f", [(1, 1440), (5, 290), (3, 511), (1, 1535),
                                 (1, 3071), (1, 3072)])
def test_tree_shap_kernel_wide_rows(dev, k, f):
    """Wide contribution rows, k (F + 1) = 1441-1536 (a block's phi rows
    under 48 KB but past it with the kernel's static shared memory), 3072
    (the widest phi kept in shared memory) and 3073 (phi in global
    memory): two launches equal to the bit and within 1e-9 of the plain
    version."""
    from lightgbm_tpu_torch.ops.tree_shap_cuda import ShapModel, \
        tree_shap_cuda
    from lightgbm_tpu_torch.predictor import tree_shap_plain
    from torch_shap_model import chain_rows, chain_tree
    rng = np.random.RandomState(k * 10_000 + f)
    models = [chain_tree(list(rng.choice(f, 12, replace=False)),
                         list(0.5 * rng.randn(12)), seed=i)
              for i in range(2 * k)]
    x = chain_rows(f, n=600)
    sm = ShapModel(models, k, dev)
    xd = torch.from_numpy(x).to(dev)
    a = tree_shap_cuda(sm, xd)
    b = tree_shap_cuda(sm, xd)
    torch.cuda.synchronize()
    assert a.shape == (600, k * (f + 1))
    assert torch.equal(a, b)
    ref = tree_shap_plain(models, torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(a.cpu().numpy(), ref, rtol=1e-9, atol=1e-12)


def _categorical_data(n, seed=3):
    """A 40-way category (feature 0) with numeric noise, as
    tests/test_torch_categorical_train.py trains it."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, 40, n)
    effect = np.where(np.isin(cats, [2, 5, 11, 17, 23, 31]), 2.5, -1.0)
    noise = rng.randn(n, 3)
    z = effect + 0.3 * noise[:, 0] + 0.5 * rng.randn(n)
    X = np.concatenate([cats[:, None].astype(np.float64), noise], axis=1)
    return X, (z > 0).astype(np.float32)


@pytest.mark.parametrize("max_bin", [255, 600])
def test_categorical_training_kernels_match_plain(dev, max_bin):
    """Per-phase categorical training through the kernels (at 255 bins
    the partition's LUT route for every categorical split) against the
    same run through the plain versions on the card: the same trees,
    categorical left sets included, and leaf values to the bit."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    X, y = _categorical_data(20_000)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "learning_rate": 0.2, "min_data_per_group": 20, "max_bin": max_bin}
    _native.reset_launch_counts()
    kb = lt.train(p, lt.Dataset(X, label=y, categorical_feature=[0]), 3,
                  device=dev)
    lut = _native.ROUTE_LAUNCHES["partition_segment_lut"]
    pb = lt.train(p, lt.Dataset(X, label=y, categorical_feature=[0]), 3,
                  device=dev, ops="plain")
    cat_nodes = sum(int((t.decision_type[:t.num_leaves - 1] & 1).sum())
                    for t in kb.models)
    assert cat_nodes > 0
    assert lut == (cat_nodes if max_bin == 255 else 0)
    for a, b in zip(kb.models, pb.models):
        assert a.num_leaves == b.num_leaves
        for name in ("split_feature_inner", "threshold_bin",
                     "decision_type", "left_child", "right_child",
                     "cat_bitsets"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


def test_lut_partition_matches_plain(dev, mat):
    """The partition kernel's LUT route against its plain version on a
    categorical split's bin bitset, inside a segment of the matrix."""
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops.partition_cuda import (
        bitset_to_lut, partition_segment, partition_segment_plain)
    words = np.zeros(8, np.uint32)
    words[0] = 0b1010_0110_0011_0101_1100_1010_0101_0011
    words[3] = 0b1001
    words[7] = 1 << 31
    lut = bitset_to_lut(words).to(dev)
    a, b = mat.clone(), mat.clone()
    before = _native.ROUTE_LAUNCHES["partition_segment_lut"]
    sa = partition_segment(a, torch.empty_like(a), 123, 15_000, 2, 0, False,
                           0, 0, B, True, lut)
    sb = partition_segment_plain(b, None, 123, 15_000, 2, 0, False, 0, 0, B,
                                 True, lut)
    assert _native.ROUTE_LAUNCHES["partition_segment_lut"] == before + 1
    assert torch.equal(sa, sb) and torch.equal(a, b)


# ---- EFB, multi-val ----------------------------------------------------

def _bosch_slots(n, seed=3):
    """A Bosch-shaped multi-val dataset's slots (``torch_efb_data``)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import Dataset
    from torch_efb_data import bosch_like
    X, y = bosch_like(n=n, f=200, seed=seed)
    ds = Dataset.from_numpy(X, Config.from_params({"verbosity": -1}),
                            label=y)
    assert ds.has_multival
    return ds


@pytest.mark.parametrize("b", [64, 256, 300])
@pytest.mark.parametrize("case", ["all", "third", "one_row", "empty",
                                  "one_chunk"])
def test_hist_multival_kernel_matches_plain(dev, b, case):
    """The multi-val histogram kernel against its plain version on the
    card, over all rows and over row lists: max abs err 0."""
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import hist_multival_cuda as hm
    ds = _bosch_slots(30_000)
    lay = ds.mv_layout_device(dev)
    n = lay.n
    g = torch.Generator(device=dev).manual_seed(4)
    ghc = torch.stack([torch.randn(n, generator=g, device=dev),
                       torch.rand(n, generator=g, device=dev),
                       torch.ones(n, device=dev)], 1).contiguous()
    ids = {"all": None,
           "third": torch.randperm(n, generator=g, device=dev)[:n // 3],
           "one_row": torch.tensor([n - 1], device=dev),
           "empty": torch.zeros(0, dtype=torch.int64, device=dev),
           "one_chunk": torch.arange(hm.MV_CHUNK_ROWS, device=dev)}[case]
    if ids is not None:
        ids = ids.sort().values.to(torch.int32)
    before = _native.LAUNCHES["hist_multival"]
    out = hm.hist_multival(lay, ghc, b, ids)
    ref = hm.hist_multival_plain(lay, ghc, b, ids)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["hist_multival"] == before + 1
    assert out.shape == (lay.g_mv, b, 3)
    assert torch.equal(out, ref)
    assert torch.equal(out, hm.hist_multival(lay, ghc, b, ids))


@pytest.mark.parametrize("b", [64, 256, 300])
@pytest.mark.parametrize("case", ["all", "third", "one_row", "empty",
                                  "one_chunk"])
def test_hist_multival_float64_route_matches_plain(dev, b, case):
    """The float64 route (the data-parallel learners': the chunk-ordered
    float64 sum, unrounded, the kernel's ``out64``) against its plain
    version on the card: max abs err 0, and rounded once it is the
    float32 route's histogram to the bit; one launch counted."""
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import hist_multival_cuda as hm
    ds = _bosch_slots(30_000)
    lay = ds.mv_layout_device(dev)
    n = lay.n
    g = torch.Generator(device=dev).manual_seed(5)
    ghc = torch.stack([torch.randn(n, generator=g, device=dev),
                       torch.rand(n, generator=g, device=dev),
                       torch.ones(n, device=dev)], 1).contiguous()
    ids = {"all": None,
           "third": torch.randperm(n, generator=g, device=dev)[:n // 3],
           "one_row": torch.tensor([n - 1], device=dev),
           "empty": torch.zeros(0, dtype=torch.int64, device=dev),
           "one_chunk": torch.arange(hm.MV_CHUNK_ROWS, device=dev)}[case]
    if ids is not None:
        ids = ids.sort().values.to(torch.int32)
    before = _native.LAUNCHES["hist_multival"]
    out = hm.hist_multival(lay, ghc, b, ids, float64=True)
    ref = hm.hist_multival_plain(lay, ghc, b, ids, float64=True)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["hist_multival"] == before + 1
    assert out.dtype == torch.float64 and out.shape == (lay.g_mv, b, 3)
    assert torch.equal(out, ref)
    assert torch.equal(out.float(), hm.hist_multival(lay, ghc, b, ids))


@pytest.mark.parametrize("g_mv", [1, 16, 17, 30, 31, 242])
@pytest.mark.parametrize("k", [1, 2, 200])
@pytest.mark.parametrize("rows", ["all", "list"])
def test_hist_multival_kernel_shapes(dev, g_mv, k, rows):
    """The kernel against its plain version and against itself on a
    second call, bitwise, across slot widths (K 1-2, and 200: past the
    first design's 128-column tile) and pseudo-group counts (one window,
    a window's edge of 16 groups, two windows, 16 windows), on exactly
    representable ghc (multiples of 2^-12 in [-2, 2]: every chunk's
    float64 sums are exact, so the two sum orders agree by
    construction)."""
    from lightgbm_tpu_torch.ops import hist_multival_cuda as hm
    n = 40_000 if k < 200 else 12_000
    rng = np.random.RandomState(g_mv * 1000 + k)
    slots = np.zeros((n, k), np.int32)
    real = rng.randint(0, k + 1, n)
    vals = rng.randint(0, g_mv, (n, k)) * 256 + rng.randint(1, 256, (n, k))
    mask = np.arange(k)[None, :] < real[:, None]
    slots[mask] = vals[mask]
    lay = hm.MultivalLayout(torch.from_numpy(slots).to(dev), g_mv)
    ghc = torch.from_numpy(np.stack([
        rng.randint(-8192, 8192, n) / 4096.0,
        rng.randint(0, 8192, n) / 4096.0,
        rng.randint(0, 2, n)], 1).astype(np.float32)).to(dev)
    ids = None if rows == "all" else torch.from_numpy(np.sort(rng.choice(
        n, n // 2, replace=False)).astype(np.int32)).to(dev)
    out = hm.hist_multival(lay, ghc, 256, ids)
    again = hm.hist_multival(lay, ghc, 256, ids)
    ref = hm.hist_multival_plain(lay, ghc, 256, ids)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out, ref)


def test_group_matrix_histogram_and_bundled_lut_partition(dev):
    """On a bundled dataset's group matrix: the segment histogram kernel
    against its plain version, and a bundled numerical split's LUT
    partition (``partition_decision_lut``) against its plain version."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import Dataset
    from lightgbm_tpu_torch.learner.partitioned import \
        feature_meta_from_dataset
    from lightgbm_tpu_torch.ops.partition_cuda import partition_decision_lut
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops.split_step_cuda import pack_meta_tables
    from torch_efb_data import sparse_problem
    X, y = sparse_problem(n=40_000, f=60)
    ds = Dataset.from_numpy(X, Config.from_params({"verbosity": -1}),
                            label=y)
    g_cols = ds.binned.shape[1]
    b = int(max(ds.num_bins_array().max(), ds.group_num_bins.max()))
    m = hc.build_matrix(ds.binned_device(dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    n = m.shape[0]
    hc.pack_gh(m, g_cols, torch.randn(n, generator=gen, device=dev),
               torch.rand(n, generator=gen, device=dev),
               torch.ones(n, device=dev))
    for begin, count in ((0, n), (11, 9_999)):
        out = hc.histogram_segment(m, begin, count, b, g_cols)
        ref = hc.histogram_segment_plain(m, begin, count, b, g_cols)
        scale = hc.histogram_segment_plain(m, begin, count, b, g_cols,
                                           absolute=True)
        assert bool(((out - ref).abs() <= 1e-5 * scale + 1e-6).all())
    imeta = pack_meta_tables(feature_meta_from_dataset(ds))[0].numpy()
    feat = int(np.flatnonzero(ds.feature_offset > 1)[0])
    col, use_lut, lut = partition_decision_lut(
        imeta, feat, 1, True, False, np.zeros(8, np.uint32), True)
    assert use_lut and col == ds.feature_group[feat]
    _partition_pair(m, 5, n - 10, (col, 1, 1, int(imeta[feat, 1]),
                                   int(imeta[feat, 2]), b, True),
                    lut.to(dev))


@pytest.mark.parametrize("case", ["partitioned_255", "serial_600",
                                  "multival"])
def test_bundled_training_kernels_match_plain(dev, case):
    """EFB training through the kernels against the same run through
    the plain versions on the card: the same trees and leaf values to
    the bit; the bundled splits take the partition's LUT route, and a
    multi-val dataset launches the multi-val histogram kernel."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    from torch_efb_data import bosch_like, sparse_problem
    if case == "multival":
        X, y = bosch_like(n=30_000, f=200)
        p = {"max_bin": 63}
    else:
        X, y = sparse_problem(n=30_000, f=60)
        p = {"max_bin": 255 if case == "partitioned_255" else 600}
    p.update(objective="binary", num_leaves=15, verbosity=-1,
             learning_rate=0.2, min_data_in_leaf=5)
    _native.reset_launch_counts()
    kb = lt.train(p, lt.Dataset(X, label=y), 3, device=dev)
    launches = dict(_native.LAUNCHES)
    lut = _native.ROUTE_LAUNCHES["partition_segment_lut"]
    pb = lt.train(p, lt.Dataset(X, label=y), 3, device=dev, ops="plain")
    td = kb._gbdt.train_data
    assert td.is_bundled and not kb._gbdt.learner.fused
    if case == "partitioned_255":
        bundled_nodes = sum(int((td.feature_offset[
            t.split_feature_inner[:t.num_leaves - 1]] > 0).sum())
            for t in kb.models)
        assert lut == bundled_nodes > 0
    if case == "multival":
        assert launches["hist_multival"] > 0
    for a, b in zip(kb.models, pb.models):
        assert a.num_leaves == b.num_leaves
        for name in ("split_feature_inner", "threshold_bin",
                     "decision_type", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


# ---- the scan's node table and the rest of tree growing ----------------

def _node_scan_inputs(dev, b, f=10, n=40_000):
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    g = torch.Generator(device=dev).manual_seed(b + 7)
    binned = torch.randint(0, b, (n, f), generator=g, device=dev)
    ghc = torch.stack([torch.randn(n, generator=g, device=dev)
                       + (binned[:, 0] > b // 2).float(),
                       torch.rand(n, generator=g, device=dev) + 0.1,
                       torch.ones(n, device=dev)], dim=1)
    hists = [build_histogram(binned[:n // 3], ghc[:n // 3], b),
             build_histogram(binned[n // 3:], ghc[n // 3:], b)]
    leaves = [tuple(h[0].sum(0).cpu().numpy()) + (-np.inf, np.inf)
              for h in hists]
    meta = sp.FeatureMeta(
        num_bins=np.full(f, b, np.int32),
        missing=(np.arange(f) % 3).astype(np.int32),
        default_bin=np.full(f, b // 3, np.int32),
        most_freq_bin=np.zeros(f, np.int32),
        monotone=np.zeros(f, np.int32), penalty=np.ones(f, np.float32),
        is_categorical=np.zeros(f, bool))
    params = sp.SplitParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0, True)
    return hists, leaves, sp.meta_tensors(meta, dev), params


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("b", [64, 255, 1023])
def test_scan_kernel_node_table_matches_plain(dev, b, k):
    """The scan with a node table (each leaf's rand bins, -1 in one row,
    and node masks) against its plain version with the same rows: every
    column of the table bitwise."""
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    hists, leaves, meta_t, params = _node_scan_inputs(dev, b)
    f = hists[0].shape[0]
    rng = np.random.RandomState(b * 10 + k)
    rb = rng.randint(0, b - 2, (6, f))
    rb[2] = -1
    nm = rng.rand(6, f) < 0.5
    for rbs, nms in ((rb, None), (None, nm), (rb, nm)):
        node = sc.node_table(rbs, nms, f, dev)
        for salts in ((1, 4), (2, 0), (5, 3)):
            out = sc.per_feature_numerical_cuda(
                hists[:k], leaves[:k], meta_t, params, node=node,
                salts=salts[:k])
            ref = sc.per_feature_numerical_plain(
                hists[:k], leaves[:k], meta_t, params, node, salts[:k])
            assert _same_bytes(out, ref), (b, k, salts)
            if rbs is not None:
                thr = out[..., sp.O_THR].long().cpu().numpy()
                fin = np.isfinite(out[..., sp.O_SCORE].cpu().numpy())
                for i in range(k):
                    row = rbs[salts[i]]
                    sel = fin[i] & (row >= 0)
                    assert (thr[i][sel] == row[sel]).all()


@pytest.mark.parametrize("b", [64, 255, 1023])
def test_scan_kernel_pass_table_is_no_table(dev, b):
    """A node table that keeps every threshold and every feature gives
    the scan without a table, bit for bit (the fused steps pass none)."""
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    hists, leaves, meta_t, params = _node_scan_inputs(dev, b)
    f = hists[0].shape[0]
    node = sc.node_table(np.full((3, f), -1), np.ones((3, f), bool), f,
                         dev)
    out = sc.per_feature_numerical_cuda(hists, leaves, meta_t, params,
                                        node=node, salts=(0, 2))
    ref = sc.per_feature_numerical_cuda(hists, leaves, meta_t, params)
    assert _same_bytes(out, ref)


EXTRAS_CASES = {
    "extra_255": {"extra_trees": True},
    "extra_600": {"extra_trees": True, "max_bin": 600},
    "bynode": {"feature_fraction": 0.8, "feature_fraction_bynode": 0.5},
    "cegb": {"cegb_penalty_split": 1e-5,
             "cegb_penalty_feature_coupled": [1.0 + 0.5 * i
                                              for i in range(8)]},
    "lazy": {"cegb_penalty_feature_lazy": [1e-3] * 8},
    "pool": {"histogram_pool_size": 4.5 * 8 * 256 * 12 / 2 ** 20},
    "rebuild_600": {"histogram_pool_size": 0.01, "max_bin": 600},
    "linear": {"linear_tree": True},
}


@pytest.mark.parametrize("case", list(EXTRAS_CASES))
def test_extras_training_kernels_match_plain(dev, case):
    """Training with each option of the rest of tree growing (and
    linear leaves) through the kernels against the same run through the
    plain versions on the card: the same trees, leaf values and linear
    models to the bit, on the per-phase path (linear: the fused one)."""
    import lightgbm_tpu_torch as lt
    rng = np.random.RandomState(5)
    X = rng.randn(30_000, 8)
    X[rng.rand(30_000) < 0.1, 2] = np.nan
    y = (X[:, 0] - X[:, 1] + 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.randn(30_000) > 0).astype(np.float32)
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "learning_rate": 0.2}, **EXTRAS_CASES[case])
    kb = lt.train(p, lt.Dataset(X, label=y), 3, device=dev)
    pb = lt.train(p, lt.Dataset(X, label=y), 3, device=dev, ops="plain")
    assert kb._gbdt.learner.fused == (case == "linear")
    for a, b in zip(kb.models, pb.models):
        assert a.num_leaves == b.num_leaves > 1
        for name in ("split_feature_inner", "threshold_bin",
                     "decision_type", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
        assert a.is_linear == b.is_linear == (case == "linear")
        if a.is_linear:
            np.testing.assert_array_equal(a.leaf_coeff, b.leaf_coeff)
            np.testing.assert_array_equal(a.leaf_const, b.leaf_const)
    np.testing.assert_array_equal(kb.predict(X[:5000], raw_score=True),
                                  pb.predict(X[:5000], raw_score=True))


@pytest.mark.parametrize("num_leaves", [63, 1000, 40000],
                         ids=["u8", "u16", "u32"])
def test_refit_leaf_sums_kernel_matches_plain(dev, num_leaves):
    """Refit's per-leaf sums through the ``hist_rows`` kernel (the leaf
    ids as a one-column bin matrix: uint8 bins at 63 leaves, the int16
    bits of u16 bins at 1000) against its plain version on the card and
    on the CPU: one launch, the same float32 sums to the bit."""
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    n = 300_007
    g = torch.Generator(device=dev).manual_seed(num_leaves)
    leaf = torch.randint(0, num_leaves, (n,), generator=g, device=dev)
    ghc = torch.stack([torch.randn(n, generator=g, device=dev),
                       torch.rand(n, generator=g, device=dev),
                       torch.ones(n, device=dev)], dim=1)
    before = _native.LAUNCHES["hist_rows"]
    out = hc.leaf_histogram(leaf, ghc, num_leaves)
    assert _native.LAUNCHES["hist_rows"] == before + 1
    plain = hc.leaf_histogram(leaf, ghc, num_leaves, plain=True)
    cpu = hc.leaf_histogram(leaf.cpu(), ghc.cpu(), num_leaves)
    torch.cuda.synchronize()
    assert _same_bytes(out, plain)
    assert _same_bytes(out.cpu(), cpu)


@pytest.mark.parametrize("linear", [False, True])
def test_refit_kernel_matches_plain(dev, linear):
    """``Booster.refit`` of one model on the card through the kernel and
    through the plain versions: the same leaf values (and linear
    models) to the bit, one ``hist_rows`` launch a tree; decay 1.0
    changes no leaf."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    rng = np.random.RandomState(6)
    X = rng.randn(40_000, 8)
    X[rng.rand(40_000) < 0.1, 2] = np.nan
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.randn(40_000) > 0).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 63, "verbosity": -1,
         "learning_rate": 0.2, "linear_tree": linear}
    text = lt.train(p, lt.Dataset(X, label=y), 4, device=dev) \
        .model_to_string()
    X2 = rng.randn(40_000, 8)
    y2 = (X2[:, 0] - X2[:, 1] + 0.3 * rng.randn(40_000) > 0).astype(
        np.float32)
    before = _native.LAUNCHES["hist_rows"]
    kb = lt.Booster(model_str=text, device=dev).refit(X2, y2, 0.9)
    assert _native.LAUNCHES["hist_rows"] == before + 4
    pb = lt.Booster(model_str=text, device=dev, ops="plain").refit(X2, y2,
                                                                   0.9)
    same = lt.Booster(model_str=text, device=dev).refit(X2, y2, 1.0)
    src = lt.Booster(model_str=text, device=dev)
    for a, b, c, d in zip(kb.models, pb.models, same.models, src.models):
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
        np.testing.assert_array_equal(c.leaf_value, d.leaf_value)
        assert a.is_linear == linear
        if linear:
            np.testing.assert_array_equal(a.leaf_coeff, b.leaf_coeff)
            np.testing.assert_array_equal(a.leaf_const, b.leaf_const)


# ---- the model-batched kernels (multiboost) ------------------------------

def _batch_roots(dev, models, n, f, b, big_l, exact, seed=7, stop=None,
                 layout="random"):
    """``models`` models over one random [n, f] bin matrix, each with its
    own ghc (``exact``: gradients and hessians in multiples of 1/8, so
    every float64 sum is exact in any order) and bagging mask (the count
    channel), its own ``SplitParams`` (min_data_in_leaf and lambda_l2
    varying) and its root state from the scan kernel. Model ``stop``
    takes min_data_in_leaf n / 3: it stops growing after a split or two
    while the others go on. ``layout`` "sorted" makes feature 0 rise
    with the row index (whole blocks of the grid without a member).
    Returns ([k, S, T, lid, hist] stacked, binned, ghc [M, n, 3], imeta,
    fmeta, params, step kwargs)."""
    from lightgbm_tpu_torch.learner.split_step import (make_grow_pack,
                                                       root_state)
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    from lightgbm_tpu_torch.ops.histogram import build_histogram, make_ghc
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev)
    if layout == "sorted":
        bins[:, 0] = torch.arange(n, device=dev) * b // n
    binned = bins.to(torch.uint8 if b <= 256 else torch.int16)
    meta = sp.FeatureMeta(
        num_bins=np.full(f, b, np.int32),
        missing=(np.arange(f) % 3).astype(np.int32),
        default_bin=np.full(f, b // 2, np.int32),
        most_freq_bin=np.zeros(f, np.int32), monotone=np.zeros(f, np.int32),
        penalty=np.ones(f, np.float32), is_categorical=np.zeros(f, bool))
    pack = make_grow_pack((), has_monotone=False, big_l=big_l)
    ghcs, params, states = [], [], []
    hist = torch.zeros((models, big_l, f, b, 3), device=dev)
    for m in range(models):
        y = (bins[:, m % f].float() / b
             + 0.3 * torch.rand(n, generator=g, device=dev) > 0.6)
        grad = y.float() - 0.5 + 0.05 * torch.randn(n, generator=g,
                                                    device=dev)
        hess = 0.2 + 0.05 * torch.rand(n, generator=g, device=dev)
        if exact:
            grad, hess = torch.round(grad * 8) / 8, \
                torch.clamp(torch.round(hess * 8) / 8, min=0.125)
        w = (torch.rand(n, generator=g, device=dev) < 0.8).float()
        ghcs.append(make_ghc(grad, hess, w))
        p = sp.SplitParams(0.1, 0.5 * m, 0.0,
                           float(n // 3) if m == stop else 5.0 + 3 * m,
                           1e-3, 0.0, True)
        params.append(p)
        hist[m, 0] = build_histogram(binned, ghcs[-1], b)
        sums = hist[m, 0, 0].sum(0).cpu().numpy()
        table = sc.per_feature_numerical_cuda(
            [hist[m, 0]], [tuple(sums) + (-np.inf, np.inf)],
            sp.meta_tensors(meta, dev), p)[0]
        states.append(root_state(pack, table, *sums, n, p, big_l))
    k = torch.ones((models,), dtype=torch.int32, device=dev)
    lid = torch.zeros((models, n), dtype=torch.int32, device=dev)
    S = torch.stack([st["S"] for st in states])
    T = torch.stack([st["T"] for st in states])
    imeta, fmeta = ss.pack_meta_tables(meta, None, dev)
    kw = dict(big_l=big_l, max_depth=-1, b=b, has_monotone=False)
    return ([k, S, T, lid, hist], binned, torch.stack(ghcs), imeta, fmeta,
            params, kw)


@pytest.mark.parametrize("models", [1, 3, 5, 8, 17])
@pytest.mark.parametrize("b", [255, 1023], ids=["u8", "u16"])
def test_leaf_batched_kernel_matches_single_kernel(dev, models, b):
    """A whole tree of every model (L - 1 launches of the batched kernel)
    against each model's own tree through the single-model kernel from
    the same root: bitwise, state, leaf ids and cache."""
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    big_l = 15
    state, binned, ghc, imeta, fmeta, params, kw = _batch_roots(
        dev, models, 20_011, 12, b, big_l, exact=False)
    single = [[t[m].clone() for t in state] for m in range(models)]
    before = _native.LAUNCHES["fused_split_step_leaf_batched"]
    scratch = ss.LeafBatchScratch(binned, b, models)
    for _ in range(big_l - 1):
        ss.fused_split_step_leaf_batched(*state, binned, ghc, imeta, fmeta,
                                         params=params, scratch=scratch,
                                         **kw)
    assert _native.LAUNCHES["fused_split_step_leaf_batched"] \
        == before + big_l - 1
    for m in range(models):
        k, S, T, lid, hist = single[m]
        k = k.reshape(1)
        for _ in range(big_l - 1):
            ss.fused_split_step_leaf(k, S, T, lid, hist, binned, ghc[m],
                                     imeta, fmeta, params=params[m], **kw)
        torch.cuda.synchronize()
        for a, w in zip([t[m] for t in state], (k[0], S, T, lid, hist)):
            assert _same_bytes(a, w), m
        assert int(k[0]) > 4


@pytest.mark.parametrize("models", [1, 3, 5, 8, 17])
def test_leaf_batched_kernel_matches_plain(dev, models):
    """The same batched tree against the plain version (a loop of the
    single-model plain step) on gradients whose sums are exact: every
    float64 sum is the same in any order, so state, leaf ids and cache
    are bitwise equal. One model starts finished (k = L): its launch
    changes nothing."""
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    big_l = 15
    state, binned, ghc, imeta, fmeta, params, kw = _batch_roots(
        dev, models, 20_011, 12, 255, big_l, exact=True)
    state[0][models - 1] = big_l
    plain = [t.clone() for t in state]
    done_before = [t[models - 1].clone() for t in state]
    for _ in range(big_l - 1):
        ss.fused_split_step_leaf_batched(*state, binned, ghc, imeta, fmeta,
                                         params=params, **kw)
        ss.fused_split_step_leaf_batched_plain(*plain, binned, ghc, imeta,
                                               fmeta, params=params, **kw)
    torch.cuda.synchronize()
    for a, p in zip(state, plain):
        assert _same_bytes(a, p)
    for a, p in zip([t[models - 1] for t in state], done_before):
        assert _same_bytes(a, p)
    if models > 1:
        assert int(state[0][0]) > 4


@pytest.mark.parametrize("models", [1, 3, 5, 8, 17])
@pytest.mark.parametrize("b,n", [(255, 20_011), (1023, 30_000), (63, 300),
                                 (255, 300_007)],
                         ids=["u8", "u16", "one_chunk", "chunk_cap"])
def test_hist_rows_batched_matches_single_and_plain(dev, models, b, n):
    """The batched root histogram: model by model the single kernel's
    bit for bit (random ghc), and the plain version's bit for bit on
    gradients whose sums are exact."""
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    g = torch.Generator(device=dev).manual_seed(models)
    binned = torch.randint(0, b, (n, 12), generator=g, device=dev).to(
        torch.uint8 if b <= 256 else torch.int16)
    ghc = torch.stack([torch.randn(models, n, generator=g, device=dev),
                       torch.rand(models, n, generator=g, device=dev) + 0.1,
                       (torch.rand(models, n, generator=g, device=dev) < 0.9)
                       .float()], dim=2)
    before = _native.LAUNCHES["hist_rows_batched"]
    out = hc.histogram_rows_batched(binned, ghc, b)
    assert _native.LAUNCHES["hist_rows_batched"] == before + 1
    for m in range(models):
        assert _same_bytes(out[m], hc.histogram_rows(binned, ghc[m].contiguous(),
                                                     b))
    exact = torch.round(ghc * 8) / 8
    exact[..., 2] = ghc[..., 2]
    got = hc.histogram_rows_batched(binned, exact, b)
    assert _same_bytes(got, hc.histogram_rows_batched_plain(binned, exact, b))


@pytest.mark.parametrize("case", ["chunk_cap", "stops", "sorted_u16",
                                  "sorted_u8"])
def test_leaf_batched_kernel_cases(dev, case):
    """A whole tree of the batched kernel against each model's tree
    through the single kernel, bitwise: children over the chunk cap (130
    features at 1024 bins: 7 chunks of 512 rows at most), a model that
    stops growing after a split or two while the others go on, and
    splits on a sorted feature (whole blocks without a member) with N a
    multiple of neither 32 nor 512, u16 and u8."""
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    models, n, f, b, stop, layout = {
        "chunk_cap": (3, 40_000, 130, 1024, None, "random"),
        "stops": (5, 20_011, 12, 255, 2, "random"),
        "sorted_u16": (4, 50_003, 12, 1024, None, "sorted"),
        "sorted_u8": (8, 20_011, 9, 255, 6, "sorted")}[case]
    big_l = 15
    state, binned, ghc, imeta, fmeta, params, kw = _batch_roots(
        dev, models, n, f, b, big_l, exact=False, stop=stop, layout=layout)
    single = [[t[m].clone() for t in state] for m in range(models)]
    scratch = ss.LeafBatchScratch(binned, b, models)
    for _ in range(big_l - 1):
        ss.fused_split_step_leaf_batched(*state, binned, ghc, imeta, fmeta,
                                         params=params, scratch=scratch,
                                         **kw)
    for m in range(models):
        k, S, T, lid, hist = single[m]
        k = k.reshape(1)
        for _ in range(big_l - 1):
            ss.fused_split_step_leaf(k, S, T, lid, hist, binned, ghc[m],
                                     imeta, fmeta, params=params[m], **kw)
        torch.cuda.synchronize()
        for a, w in zip([t[m] for t in state], (k[0], S, T, lid, hist)):
            assert _same_bytes(a, w), (case, m)
    ks = state[0].tolist()
    if stop is not None:
        assert ks[stop] <= 3 and max(ks) == big_l, ks
    else:
        assert min(ks) > 4, ks


def test_batched_timed_builds_match(dev):
    """The timed instantiations of both batched kernels write the same
    bits as the untimed ones, and their clock reads."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    big_l = 15
    state, binned, ghc, imeta, fmeta, params, kw = _batch_roots(
        dev, 4, 20_011, 12, 255, big_l, exact=False)
    timed = [t.clone() for t in state]
    scratch = ss.LeafBatchScratch(binned, 255, 4)
    step = ss.LeafBatchStep(*state, binned, ghc, imeta, fmeta,
                            ss.params_table(params, dev), scratch=scratch,
                            **kw)
    tstep = ss.LeafBatchStep(*timed, binned, ghc, imeta, fmeta,
                             ss.params_table(params, dev),
                             scratch=ss.LeafBatchScratch(binned, 255, 4),
                             **kw)
    times = torch.zeros((big_l - 1, ss.LEAF_TIMES), dtype=torch.int64,
                        device=dev)
    for i in range(big_l - 1):
        step()
        tstep.timed(times, i)
    torch.cuda.synchronize()
    for a, t in zip(state, timed):
        assert _same_bytes(a, t)
    assert bool((times[:, 7] > 0).all()) and bool((times[:, 1] > 0).all())
    n = binned.shape[0]
    blocks = hc.rows_batched_blocks(n, 12, 255, 1, 4)
    laps = torch.zeros((blocks, len(hc.BATCHED_LAPS)), dtype=torch.int64,
                       device=dev)
    out = hc.histogram_rows_batched(binned, ghc, 255, times=laps)
    assert _same_bytes(out, hc.histogram_rows_batched(binned, ghc, 255))
    assert bool((laps[:, 3] > 0).all())


@pytest.mark.parametrize("models", [1, 3, 4, 8, 17, 64])
@pytest.mark.parametrize("b", [63, 255, 1023])
def test_batched_shapes_match_the_library(dev, models, b):
    """The Python mirrors of both batched kernels' shapes against the
    library: hist_rows_batched's block (features, models, shared bytes)
    and the batched leaf step's shared bytes (the single step's rounded
    up to 16, then LEAF_BATCHED_MODEL_BYTES a model)."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    bb = 1 if b <= 256 else 2
    tile = hc.leaf_feat_tile(28, b, bb)
    ft, mb = hc.rows_batched_block(bb, b, tile, models)
    assert hc.rows_batched_shape(bb, b, tile, models) == dict(
        features=ft, models=mb, smem_bytes=hc.rows_batched_smem(bb, b, ft,
                                                                mb))
    single = ss.leaf_launch_shape(bb, 2_000_000, 28, b)
    batched = ss.leaf_batched_launch_shape(bb, 2_000_000, 28, b, models)
    assert batched["smem_bytes"] == ss.leaf_batched_smem_bytes(
        single["smem_bytes"], models)
    assert batched["max_chunks"] == single["max_chunks"]
    assert batched["grid"] >= 132


def test_multiboost_bucket_too_large_loops(dev, monkeypatch):
    """On the card a bucket whose state would not fit the free memory is
    refused before any launch, and ``train_many`` trains its models in
    the loop with the reason."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import engine as pe
    from lightgbm_tpu_torch.ops import _native
    rng = np.random.RandomState(0)
    X = rng.rand(3000, 8)
    y = (X[:, 0] > 0.5).astype(np.float64)
    params = [{"objective": "binary", "num_leaves": 15, "verbosity": -1,
               "learning_rate": lr} for lr in (0.1, 0.2)]
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1, 1))
    before = _native.LAUNCHES["fused_split_step_leaf_batched"]
    boosters, report = pe.train_many(params, lt.Dataset(X, label=y), 2,
                                     return_report=True)
    assert report["batched_models"] == 0
    assert all("device memory" in f["reason"]
               for f in report["loop_fallback"])
    assert _native.LAUNCHES["fused_split_step_leaf_batched"] == before
    assert len(boosters) == 2 and all(len(b.models) == 2 for b in boosters)


# ---- the robustness and observability planes on the card ------------

def _planes_data(n=20_000, f=10, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _planes_reset():
    from lightgbm_tpu_torch.observability.telemetry import get_telemetry
    from lightgbm_tpu_torch.observability.tracing import get_tracer
    from lightgbm_tpu_torch.robustness.faults import set_fault_plan
    set_fault_plan(None)
    get_telemetry().reset()
    get_tracer().reset()


@pytest.mark.parametrize("max_bin", [255, 1023])
def test_probe_launches_its_kernels(dev, max_bin):
    """The phase probe on the partitioned learner launches
    ``hist_segment``, ``partition_segment`` and ``split_scan`` (rows 1,
    4, 5), on the serial learner ``hist_rows`` and ``split_scan`` (rows
    8, 5)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.observability.probe import run_phase_probe
    from lightgbm_tpu_torch.ops import _native
    X, y = _planes_data()
    bst = lt.train({"objective": "binary", "num_leaves": 15, "verbosity": -1,
                    "max_bin": max_bin}, lt.Dataset(X, label=y), 2,
                   device=dev)
    _native.reset_launch_counts()
    ph = run_phase_probe(bst._gbdt)
    assert set(ph) == {"grad", "update", "hist", "partition", "split"}
    want = ("hist_segment", "partition_segment", "split_scan") \
        if max_bin == 255 else ("hist_rows", "split_scan")
    assert all(_native.LAUNCHES[k] > 0 for k in want), _native.LAUNCHES


@pytest.mark.parametrize("max_bin", [255, 1023])
def test_planes_drill_kernel_equals_plain(dev, max_bin, tmp_path):
    """The drill (a NaN gradient rolled back, a preemption, a resume)
    grows the same model text through the kernels and their plain
    versions, and the resumed text equals the uninterrupted run's."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.robustness.faults import set_fault_plan
    X, y = _planes_data()
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "max_bin": max_bin, "checkpoint_freq": 1, "guard_policy": "rollback"}
    texts = {}
    for ops in ("kernel", "plain"):
        _planes_reset()
        pp = dict(p, checkpoint_dir=str(tmp_path / ops))
        first = lt.train(dict(pp, faults="nan_grad@iteration=1;"
                              "sigterm@iteration=2"),
                         lt.Dataset(X, label=y), 4, device=dev, ops=ops)
        set_fault_plan(None)
        assert first.preempted
        second = lt.train(pp, lt.Dataset(X, label=y), 4, device=dev, ops=ops)
        texts[ops] = second.model_to_string().split("parameters:")[0]
    plain = lt.train({k: v for k, v in p.items() if k != "guard_policy"},
                     lt.Dataset(X, label=y), 4, device=dev)
    _planes_reset()
    assert texts["kernel"] == texts["plain"] \
        == plain.model_to_string().split("parameters:")[0]


def _iter_counts(tmp_path, dev, ops, max_bin):
    import json
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.observability.telemetry import get_telemetry
    from lightgbm_tpu_torch.ops import _native
    _planes_reset()
    X, y = _planes_data()
    snaps = []

    def snap(env):
        snaps.append(dict(_native.LAUNCHES, **_native.ROUTE_LAUNCHES))
    path = tmp_path / f"{ops}{max_bin}.jsonl"
    _native.reset_launch_counts()
    ds = lt.Dataset(X, label=y)
    lt.train({"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "max_bin": max_bin, "telemetry_out": str(path)}, ds, 3,
             valid_sets=[ds.create_valid(X[:2000], label=y[:2000])],
             verbose_eval=False, callbacks=[snap], device=dev, ops=ops)
    get_telemetry().flush()
    with open(path) as fh:
        iters = [json.loads(line) for line in fh]
    _planes_reset()
    return [r["counts"] for r in iters if r["kind"] == "iter"], snaps


@pytest.mark.parametrize("max_bin", [255, 1023])
def test_iter_launches_equal_the_launch_counters(dev, max_bin, tmp_path):
    """Each ``iter`` record's ``launch.*`` are that iteration's deltas
    of the launch counters; ``host.dispatches`` covers them; and
    ``host.dispatches`` / ``host.syncs`` are the same through the
    kernels and through their plain versions."""
    counts, snaps = _iter_counts(tmp_path, dev, "kernel", max_bin)
    assert len(counts) == len(snaps) == 3
    prev = {k: 0 for k in snaps[0]}
    for c, s in zip(counts, snaps):
        deltas = {k: s[k] - prev[k] for k in s}
        assert {k: c[f"launch.{k}"] for k in s} == deltas
        step = "fused_split_step_segment" if max_bin == 255 \
            else "fused_split_step_leaf"
        assert deltas[step] == 14
        assert c["host.dispatches"] >= sum(
            v for k, v in deltas.items() if k in prev and
            not k.endswith("_lut"))
        prev = s
    plain, _ = _iter_counts(tmp_path, dev, "plain", max_bin)
    for a, b in zip(counts, plain):
        assert (a["host.dispatches"], a["host.syncs"]) \
            == (b["host.dispatches"], b["host.syncs"])
        assert all(v == 0 for k, v in b.items() if k.startswith("launch."))
