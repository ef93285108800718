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
    np.testing.assert_allclose(k.cpu().numpy(), p.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(k[..., sp.O_THR], p[..., sp.O_THR])


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


@pytest.mark.parametrize("b", [1, 31, 32, 33, 255, 256, 1023, 1024])
def test_scan_kernel_matches_plain_wide(dev, b):
    """The scan kernel at up to 256 bins (static planes) and past it
    (dynamic), across the 32-bin segments of its block prefix scan:
    bitwise equal to the plain version, whose ``_cumsum`` adds in the
    same order."""
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
