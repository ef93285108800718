"""One serving program a (version, bucket, kind): the device route of a
request, captured once as a CUDA graph and replayed.

The JAX engine compiles each (version, bucket) once with XLA and
replays the executable. The port's counterpart captures the whole
device route of one bucket as a CUDA graph: pad (the rows past the
request's count are masked to zero on the device), the raw-feature walk
(``predictor.predict_leaf_index``: ``depth`` levels, no host read),
the in-order float64 add of the trees' values and the objective's
conversion (``predictor.serve_rows``). A request copies its rows into
the program's static input, replays the graph and copies its rows of
the static output back.

A graph's input and output buffers are static, and caller threads
(``ServingEngine.predict_now``) and the flusher may run one program at
once, so every run holds the program's lock from the input copy to the
output copy. Graphs are captured on a side stream with
``capture_error_mode="thread_local"``, so that other threads may keep
replaying on the default stream while a hot reload captures the next
version's programs; one capture runs at a time (``_CAPTURE_LOCK``).

On the CPU there is no graph: the same body runs eagerly.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..predictor import serve_rows

_CAPTURE_LOCK = threading.Lock()


class BucketProgram:
    """The device route of ``kind`` requests of up to ``bucket`` rows
    over one version's pinned stack."""

    def __init__(self, src, stacked: dict, bucket: int, kind: str,
                 num_features: int, device):
        self.src = src
        self.stacked = stacked
        self.bucket = int(bucket)
        self.kind = kind
        self.device = torch.device(device)
        self.lock = threading.Lock()
        self.x = torch.zeros((self.bucket, num_features),
                             dtype=torch.float64, device=self.device)
        self.n = torch.zeros((), dtype=torch.int64, device=self.device)
        self._rows = torch.arange(self.bucket, device=self.device)
        self.graph = None
        self.out = None
        if self.device.type == "cuda":
            self._capture()

    def _body(self) -> torch.Tensor:
        live = (self._rows < self.n)[:, None]
        x = torch.where(live, self.x, torch.zeros_like(self.x))
        return serve_rows(self.src, self.stacked, x, self.kind)

    def _capture(self) -> None:
        with _CAPTURE_LOCK:
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._body()        # first run outside the capture
            cur.wait_stream(side)
            # capture_begin / capture_end on the side stream, as
            # torch.cuda.graph does, without its synchronize, gc.collect
            # and empty_cache before every capture (a hot reload
            # captures a dozen graphs while traffic runs)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self._body()
                finally:
                    graph.capture_end()
            cur.wait_stream(side)
            self.out, self.graph = out, graph

    def run(self, rows: np.ndarray) -> np.ndarray:
        """The program's output for ``rows`` ([n, F] float64, n at most
        the bucket) as numpy: [n] / [n, k] float64, or [n, T] int32."""
        n = len(rows)
        with self.lock:
            self.x[:n].copy_(torch.from_numpy(
                np.ascontiguousarray(rows, np.float64)))
            self.n.fill_(n)
            if self.graph is not None:
                self.graph.replay()
                out = self.out
            else:
                out = self._body()
            return out[:n].cpu().numpy()
