"""The port's shared-memory row ring (``serving/shm_ring.py``), against
the JAX package's (``lightgbm_tpu/serving/shm_ring.py``).

The ring cases of ``tests/test_aot_shm.py`` run on the port's ring:
the write/read round trip bit-exact (NaNs and float32 too), slot reuse
across wrap-around, a full ring and an oversized or unsupported block
falling back (counted, never raised), a reader that died keeping its
slot busy, torn reads detected, and the environment spec. The slot
header is the JAX package's byte for byte: a block written by either
package's ring is read by the other's.
"""

import json

import numpy as np
import pytest

from lightgbm_tpu.serving.shm_ring import ShmRing as JRing
from lightgbm_tpu.serving.shm_ring import ShmTornRead as JTorn
from lightgbm_tpu_torch.serving.shm_ring import (ENV_VAR, HEADER_BYTES,
                                                 ShmRing, ShmTornRead)


@pytest.fixture
def ring():
    r = ShmRing.create(slots=2, slot_bytes=4096)
    # same-process reader view: untrack=False keeps the creator's
    # resource_tracker entry intact (a worker attaches from another
    # process and does untrack)
    reader = ShmRing.attach(r.name, r.slots, r.slot_bytes, untrack=False)
    yield r, reader
    reader.close()
    r.destroy()


def test_roundtrip_bit_exact(ring):
    w, r = ring
    arr = np.random.default_rng(0).normal(size=(16, 8))
    arr[3, 2] = np.nan
    ticket = w.try_write(arr)
    assert ticket is not None
    out = r.read(ticket)
    assert out.dtype == np.float64 and out.flags.writeable
    assert arr.tobytes() == out.tobytes()
    assert w.writes == 1 and r.reads == 1


def test_f32_roundtrip(ring):
    w, r = ring
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = r.read(w.try_write(arr))
    assert out.dtype == np.float32 and arr.tobytes() == out.tobytes()


def test_wrap_around_reuses_slots(ring):
    w, r = ring
    for i in range(20):
        arr = np.full((4, 4), float(i))
        ticket = w.try_write(arr)
        assert ticket is not None, f"cycle {i} found no free slot"
        np.testing.assert_array_equal(r.read(ticket), arr)
    assert w.writes == 20 and r.reads == 20 and w.full_misses == 0


def test_exhaustion_falls_back(ring):
    w, r = ring
    arr = np.zeros((2, 2))
    t1, t2 = w.try_write(arr), w.try_write(arr)
    assert t1 and t2
    assert w.try_write(arr) is None
    assert w.full_misses == 1
    r.read(t1)
    assert w.try_write(arr) is not None


def test_reader_death_keeps_slot_busy(ring):
    w, r = ring
    arr = np.ones((2, 2))
    t1 = w.try_write(arr)
    t2 = w.try_write(arr)
    assert t1 is not None and t2 is not None and t2["slot"] != t1["slot"]
    assert w.try_write(arr) is None
    np.testing.assert_array_equal(r.read(t1), arr)


def test_oversized_and_unsupported_fall_back(ring):
    w, _ = ring
    big = np.zeros((64, 64))
    assert big.nbytes > w.slot_bytes
    assert w.try_write(big) is None and w.oversize_misses == 1
    assert w.try_write(np.zeros(8)) is None                 # 1-D
    assert w.try_write(np.zeros((2, 2), np.int32)) is None  # dtype
    assert w.try_write(np.zeros((2, 2))) is not None
    assert w.stats() == {"slots": 2, "slot_bytes": 4096, "writes": 1,
                         "reads": 0, "full_misses": 0,
                         "oversize_misses": 1}


def test_torn_read_detected(ring):
    w, r = ring
    t = w.try_write(np.zeros((2, 2)))
    stale = dict(t)
    r.read(t)
    w.try_write(np.ones((2, 2)))
    w.try_write(np.ones((2, 2)))             # slot 0 again, seq bumped
    with pytest.raises(ShmTornRead):
        r.read(stale)
    with pytest.raises(ShmTornRead):
        r.read({"slot": 99, "seq": 2})


def test_env_spec_attach_roundtrip(monkeypatch):
    w = ShmRing.create(slots=2, slot_bytes=4096)
    try:
        spec = json.loads(w.env_spec())
        assert spec == {"name": w.name, "slots": 2, "slot_bytes": 4096}
        assert ENV_VAR == "LGBM_TPU_WORKER_SHM" and HEADER_BYTES == 64
        monkeypatch.setenv(ENV_VAR, "not json")
        assert ShmRing.attach_from_env() is None
        monkeypatch.delenv(ENV_VAR)
        assert ShmRing.attach_from_env() is None
    finally:
        w.destroy()


# ----------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_packages_read_each_others_blocks(direction, dtype):
    """A block written by one package's ring, read by the other's
    attached to the same segment: the same bytes, the same tickets and
    headers, and the slot released for the writer's next block."""
    wcls, rcls, torn = (JRing, ShmRing, ShmTornRead) \
        if direction == "jax_to_port" else (ShmRing, JRing, JTorn)
    w = wcls.create(slots=2, slot_bytes=8192)
    r = rcls.attach(w.name, w.slots, w.slot_bytes, untrack=False)
    try:
        rng = np.random.default_rng(3)
        for i in range(5):                   # wraps the 2 slots
            arr = rng.normal(size=(7 + i, 9)).astype(dtype)
            arr[0, i] = np.nan
            ticket = w.try_write(arr)
            assert ticket is not None
            assert bytes(w._shm.buf[:2 * 64]) == bytes(r._shm.buf[:2 * 64])
            out = r.read(ticket)
            assert out.dtype == arr.dtype and out.shape == arr.shape
            assert out.tobytes() == arr.tobytes()
        stale = dict(ticket)
        w.try_write(np.zeros((2, 2)))
        w.try_write(np.zeros((2, 2)))
        with pytest.raises(torn):
            r.read(stale)
    finally:
        r.close()
        w.destroy()


def test_ticket_and_header_layout_match_jax():
    """The same blocks through both packages' writers give the same
    tickets and the same 64-byte slot headers."""
    a, b = ShmRing.create(slots=3, slot_bytes=4096), \
        JRing.create(slots=3, slot_bytes=4096)
    try:
        for shape, dt in (((3, 5), np.float64), ((8, 2), np.float32),
                          ((1, 1), np.float64)):
            arr = np.arange(np.prod(shape), dtype=dt).reshape(shape)
            assert a.try_write(arr) == b.try_write(arr)
        n = 3 * HEADER_BYTES
        assert bytes(a._shm.buf[:n]) == bytes(b._shm.buf[:n])
        assert a.stats() == b.stats()
    finally:
        a.destroy()
        b.destroy()
