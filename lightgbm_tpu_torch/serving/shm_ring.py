"""Shared-memory row transport for process-fleet serving (copy of
``lightgbm_tpu/serving/shm_ring.py``; the slot header is the JAX
package's byte for byte, so either package's writer and either
package's reader understand each other).

Large submit batches would cross the worker socket as JSON float
arrays — O(rows*cols) text encode/decode in Python on both sides. This
module moves the payload through a ``multiprocessing.shared_memory``
ring instead: the supervisor memcpys the f64/f32 row block into a free
slot and ships only a tiny ``{slot, seq, nrows, ncols, dtype}`` ticket
in the (still length-prefixed JSON) control frame; the worker memcpys
it back out. Bytes in, bytes out — float64 parity with the JSON path
is trivially bit-exact (tests/test_torch_shm_ring.py).

Protocol (single writer = supervisor, single reader = its worker):

* Each slot has a 64-byte header — ``seq`` (seqlock: odd while the
  writer is mid-copy, even when stable), ``consumed`` (reader writes
  the slot's seq after copying out), and the block geometry.
* A slot is FREE when ``consumed == seq`` and seq is even; the writer
  bumps seq to odd, copies, publishes geometry, bumps seq to even.
* The reader validates ``seq`` from the ticket against the header
  before and after its copy (a torn read raises — it cannot happen in
  the normal flow because the control frame is sent only after the
  write completes, but it catches protocol bugs and slot reuse).
* No free slot, oversized batch, unsupported dtype → the caller falls
  back to JSON framing (counted, never an error). A reader that dies
  mid-slot simply never writes ``consumed``; its slots stay busy until
  the ring is torn down with the worker incarnation — rings are
  per-incarnation, created before spawn and unlinked at death.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..utils.log import log_warning

# header field indices (u64 each; 8 * 8 = 64-byte slot header)
_SEQ, _CONSUMED, _NROWS, _NCOLS, _DTYPE, _NBYTES = 0, 1, 2, 3, 4, 5
_HDR_U64 = 8
HEADER_BYTES = _HDR_U64 * 8

_DTYPES = {0: np.dtype(np.float64), 1: np.dtype(np.float32)}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}

ENV_VAR = "LGBM_TPU_WORKER_SHM"


class ShmTornRead(RuntimeError):
    """Ticket seq does not match the slot header: the slot was reused
    or the write was torn — a transport protocol violation."""


class ShmRing:
    """Seqlock'd slot ring over one shared-memory segment."""

    def __init__(self, shm, slots: int, slot_bytes: int,
                 owner: bool):
        self._shm = shm
        self.name = shm.name
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self.owner = owner
        self._hdr = np.ndarray((self.slots, _HDR_U64), np.uint64,
                               buffer=shm.buf)
        self._data_off = self.slots * HEADER_BYTES
        # best-effort counters (single-threaded per side under the
        # handle's write lock / worker loop)
        self.writes = 0
        self.reads = 0
        self.full_misses = 0
        self.oversize_misses = 0

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def create(cls, slots: int = 4,
               slot_bytes: int = 1 << 20) -> "ShmRing":
        from multiprocessing import shared_memory
        size = slots * (HEADER_BYTES + slot_bytes)
        shm = shared_memory.SharedMemory(create=True, size=size)
        shm.buf[:slots * HEADER_BYTES] = b"\0" * (slots * HEADER_BYTES)
        return cls(shm, slots, slot_bytes, owner=True)

    @classmethod
    def attach(cls, name: str, slots: int, slot_bytes: int,
               untrack: bool = True) -> "ShmRing":
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=name)
        # the attaching side must not let its resource_tracker "clean
        # up" (unlink) the creator's segment at interpreter exit
        # (untrack=False for same-process attachments, e.g. tests,
        # where creator and reader share one tracker)
        if untrack:
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:
                pass
        return cls(shm, slots, slot_bytes, owner=False)

    @classmethod
    def attach_from_env(cls) -> Optional["ShmRing"]:
        raw = os.environ.get(ENV_VAR, "").strip()
        if not raw:
            return None
        try:
            info = json.loads(raw)
            return cls.attach(info["name"], int(info["slots"]),
                              int(info["slot_bytes"]))
        except Exception as e:
            log_warning(f"worker shm ring attach failed ({e}); "
                        "falling back to JSON framing")
            return None

    def env_spec(self) -> str:
        return json.dumps({"name": self.name, "slots": self.slots,
                           "slot_bytes": self.slot_bytes})

    def close(self) -> None:
        try:
            self._hdr = None
            self._shm.close()
        except Exception:
            pass

    def destroy(self) -> None:
        """Close and (if owner) unlink the segment."""
        unlink = self.owner
        self.close()
        if unlink:
            try:
                self._shm.unlink()
            except Exception:
                pass

    # -- writer side (supervisor) --------------------------------------
    def try_write(self, arr: np.ndarray) -> Optional[dict]:
        """Copy ``arr`` into a free slot; returns the frame ticket, or
        None when the caller should fall back to JSON framing."""
        dtype = np.dtype(arr.dtype)
        code = _DTYPE_CODES.get(dtype)
        if code is None or arr.ndim != 2:
            return None
        nbytes = arr.nbytes
        if nbytes > self.slot_bytes:
            self.oversize_misses += 1
            return None
        hdr = self._hdr
        if hdr is None:
            return None
        for slot in range(self.slots):
            seq = int(hdr[slot, _SEQ])
            if seq % 2 == 0 and int(hdr[slot, _CONSUMED]) == seq:
                break
        else:
            self.full_misses += 1
            return None
        hdr[slot, _SEQ] = seq + 1          # odd: write in progress
        off = self._data_off + slot * self.slot_bytes
        self._shm.buf[off:off + nbytes] = \
            np.ascontiguousarray(arr).tobytes()
        hdr[slot, _NROWS] = arr.shape[0]
        hdr[slot, _NCOLS] = arr.shape[1]
        hdr[slot, _DTYPE] = code
        hdr[slot, _NBYTES] = nbytes
        hdr[slot, _SEQ] = seq + 2          # even: stable
        self.writes += 1
        return {"slot": slot, "seq": seq + 2,
                "nrows": int(arr.shape[0]), "ncols": int(arr.shape[1]),
                "dtype": int(code)}

    # -- reader side (worker) ------------------------------------------
    def read(self, ticket: dict) -> np.ndarray:
        """Copy the row block named by a frame ticket out of its slot
        and release the slot. Raises :class:`ShmTornRead` on seq
        mismatch (slot reused / torn write)."""
        slot = int(ticket["slot"])
        seq = int(ticket["seq"])
        if not 0 <= slot < self.slots:
            raise ShmTornRead(f"ticket names slot {slot} outside the "
                              f"ring (0..{self.slots - 1})")
        hdr = self._hdr
        if int(hdr[slot, _SEQ]) != seq:
            raise ShmTornRead(
                f"slot {slot} seq {int(hdr[slot, _SEQ])} != ticket "
                f"seq {seq} (torn write or slot reused)")
        nrows = int(hdr[slot, _NROWS])
        ncols = int(hdr[slot, _NCOLS])
        dtype = _DTYPES[int(hdr[slot, _DTYPE])]
        nbytes = int(hdr[slot, _NBYTES])
        off = self._data_off + slot * self.slot_bytes
        # one copy out of the slot, writable (the engine hands the rows
        # to torch.from_numpy)
        payload = bytearray(self._shm.buf[off:off + nbytes])
        if int(hdr[slot, _SEQ]) != seq:
            raise ShmTornRead(f"slot {slot} was overwritten mid-read")
        out = np.frombuffer(payload, dtype).reshape(nrows, ncols)
        hdr[slot, _CONSUMED] = seq         # release the slot
        self.reads += 1
        return out

    def stats(self) -> dict:
        return {"slots": self.slots, "slot_bytes": self.slot_bytes,
                "writes": self.writes, "reads": self.reads,
                "full_misses": self.full_misses,
                "oversize_misses": self.oversize_misses}
