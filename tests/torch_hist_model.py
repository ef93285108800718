"""A numpy model of the row-list histogram kernel's loop
(``lightgbm_tpu_torch/csrc/hist_ids.cuh``: the ``hist_rows`` kernel and
the leaf fused step's histogram phase), without JAX, so that the card
tests can import it.

``tests/test_torch_hist_rows.py`` holds it bit for bit against
``chunked_histogram`` there, the model of the summation order;
``tests/test_torch_kernels_cuda.py`` holds the kernel bit for bit
against it.
"""

import numpy as np

from lightgbm_tpu_torch.ops import hist_cuda as hc


def kernel_histogram(binned, ghc, rows, b, feat_tile):
    """[F, b, 3] float32 histogram of ``rows`` (a list in row order) as
    the kernel sums it: ``leaf_child_chunks`` chunks of the list; in each
    chunk 32-row groups from its start, and in a group each bin's lanes
    (its peer word) summed by the lowest of them in lane order, in
    float64 from 0, into the chunk's bin; the count the number of the
    bin's lanes whose count is not 0, an integer; the chunks' partials
    added in order and rounded once."""
    f = binned.shape[1]
    count = len(rows)
    chunks = hc.leaf_child_chunks(count, f, feat_tile)
    size = -(-count // chunks) if count else 0
    g = ghc[:, 0].astype(np.float32)
    h = ghc[:, 1].astype(np.float32)
    counted = ghc[:, 2] != 0
    total = np.zeros((f, b, 3))
    for c in range(chunks):
        lo, hi = min(count, c * size), min(count, (c + 1) * size)
        sums = np.zeros((f, b, 2))
        counts = np.zeros((f, b), np.int64)
        for base in range(lo, hi, 32):
            grp = rows[base:min(base + 32, hi)]
            for j in range(f):
                peers = {}
                for row, bin_ in zip(grp, binned[grp, j]):
                    peers.setdefault(int(bin_), []).append(row)
                for bin_, lanes in peers.items():
                    sg = sh = 0.0
                    for row in lanes:
                        sg += float(g[row])
                        sh += float(h[row])
                    sums[j, bin_] += (sg, sh)
                    counts[j, bin_] += int(counted[lanes].sum())
        part = np.concatenate([sums, counts[..., None]], axis=2)
        total = part if c == 0 else total + part
    return total.astype(np.float32)
