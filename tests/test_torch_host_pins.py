"""The pin-down cache of direct landing (`afp_tpu_torch/utils/host_pins.py`)
through an injected register and unregister pair, on the CPU: nothing is
registered on the first sighting of a block's bytes, and its owner's
whole byte range on the second sighting of the same bytes (never for an
array walked through once); the weak tables keep no caller's array alive; an owner the caller
has dropped is let go at the next lookup, and one no server uses any more
when the last is released; the budget evicts the least recently used
owner, and only after its last copy's event; a failed
registration, an owner over the budget and a non-contiguous block fall back
to staging and are not tried again; views of one owner, NumPy or torch,
share one registration; and the sharded, packed, pair and CPU landings of
`RingServer` never consult the cache.  The direct copies themselves need a
card: `tests/test_torch_cuda.py`.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from afp_tpu_torch.engine import Pipeline, StreamConfig, batch
from afp_tpu_torch.parallel import ShardedPipeline, make_mesh
from afp_tpu_torch.runtime import RingServer, serving
from afp_tpu_torch.utils import host_pins, staging
from afp_tpu_torch.utils.host_pins import HostPins, owner_of


class Runtime:
    """The injected register/unregister pair, logging every call (and the
    events' waits) in order; `refuse` makes registration fail."""

    def __init__(self, refuse=False):
        self.log = []
        self.refuse = refuse

    def register(self, ptr, nbytes):
        self.log.append(("register", ptr, nbytes))
        return not self.refuse

    def unregister(self, ptr):
        self.log.append(("unregister", ptr))

    def calls(self, kind):
        return [c for c in self.log if c[0] == kind]

    def cache(self, limit=1 << 40):
        return HostPins(self.register, self.unregister, limit)


class Event:
    """A copy's event: logs its wait into the runtime's log."""

    def __init__(self, runtime, name):
        self.runtime, self.name = runtime, name

    def synchronize(self):
        self.runtime.log.append(("wait", self.name))


def test_first_sighting_records_second_registers():
    d = Runtime()
    pins = d.cache()
    pool = np.zeros((4, 8, 16), dtype=np.int16)
    assert pins.lookup(pool[0]) is None  # first sighting: staged
    assert pins.lookup(pool[1]) is None  # other bytes' first sighting
    assert d.log == [] and pins.held() == []
    pin = pins.lookup(pool[0])  # second: the owner's whole range, once
    assert pin is not None and pin.owner is pool
    assert d.log == [("register", pool.ctypes.data, pool.nbytes)]
    assert pins.used == pool.nbytes
    for k in (2, 3, 0, 1):
        assert pins.lookup(pool[k]) is pin
    assert len(d.calls("register")) == 1


def test_views_of_one_owner_share_one_registration():
    """Slices, reshapes and views of views of one array, and the rows of one
    torch tensor handed as NumPy views, each register their owner once."""
    d = Runtime()
    pins = d.cache()
    pool = np.zeros((6, 4, 32), dtype=np.float32)
    views = [pool[0], pool.reshape(24, 32)[0:4], pool.reshape(24, 32)[4:8],
             pool[2][None][0], pool[3:4][0], pool[5]]
    got = [pins.lookup(v) for v in views]
    assert got[0] is None and all(g is got[1] for g in got[1:])
    assert d.calls("register") == [("register", pool.ctypes.data,
                                    pool.nbytes)]
    t = torch.zeros(3, 4, 32)
    assert pins.lookup(np.asarray(t[0])) is None
    pin = pins.lookup(np.asarray(t[0]))
    st = t.untyped_storage()
    assert pin is not None and pin.owner is st
    assert d.calls("register")[-1] == ("register", st.data_ptr(), st.nbytes())
    assert pins.lookup(np.asarray(t[1])) is pin
    assert len(d.calls("register")) == 2


def test_fresh_arrays_are_not_kept_alive():
    """A caller handing fresh memory each block: each owner is sighted once,
    nothing registers, the weak table keeps none alive and empties as
    they die."""
    d = Runtime()
    pins = d.cache()
    refs = []
    for k in range(8):
        blk = np.full((4, 16), k, dtype=np.float32)
        assert pins.lookup(blk) is None
        refs.append(weakref.ref(blk))
        del blk
    gc.collect()
    assert all(r() is None for r in refs)
    assert d.log == [] and not pins._seen and not pins._refused


def test_one_pass_array_is_never_registered():
    """A caller that walks once through one array hands no block's bytes
    twice: nothing registers, and the weak table lets the array go with the
    caller.  Walked through again, its first block registers it."""
    d = Runtime()
    pins = d.cache()
    blocks = np.zeros((6, 4, 16), dtype=np.float32)
    assert [pins.lookup(b) for b in blocks] == [None] * 6
    assert d.log == [] and pins.held() == []
    again = [pins.lookup(b) for b in blocks]
    assert again[0] is not None and all(p is again[0] for p in again)
    assert d.calls("register") == [("register", blocks.ctypes.data,
                                    blocks.nbytes)]
    once = np.ones((3, 4, 16), dtype=np.float32)
    [pins.lookup(b) for b in once]
    gone = weakref.ref(once)
    del once
    gc.collect()
    assert gone() is None and len(pins._seen) == 0


def test_budget_evicts_lru_after_the_last_copy():
    """A budget of two owners: a third evicts the least recently used, and
    unregisters it only after the event of the last copy that read it; the
    registered bytes never pass the budget."""
    d = Runtime()
    a, b, c = (np.zeros((2, 64), dtype=np.float32) for _ in range(3))
    pins = d.cache(limit=2 * a.nbytes)
    pa = [pins.lookup(a[i]) for i in (0, 0)][1]
    pb = [pins.lookup(b[i]) for i in (0, 0)][1]
    pa.event = Event(d, "a")
    pb.event = Event(d, "b")
    assert pins.lookup(a[0]) is pa  # a used last: b is the LRU
    pa.event = Event(d, "a2")
    assert pins.used == 2 * a.nbytes
    assert pins.lookup(c[0]) is None
    pc = pins.lookup(c[0])
    assert pc is not None and pins.held() == [a, c]
    tail = d.log[-3:]
    assert tail == [("wait", "b"), ("unregister", b.ctypes.data),
                    ("register", c.ctypes.data, c.nbytes)]
    assert pins.used == 2 * a.nbytes <= pins.limit
    # b again: registered anew (sighted afresh), evicting a after its
    # newest copy's event
    assert pins.lookup(b[1]) is None and pins.lookup(b[1]) is not None
    assert d.log[-3:] == [("wait", "a2"), ("unregister", a.ctypes.data),
                          ("register", b.ctypes.data, b.nbytes)]
    pins.release()
    assert pins.used == 0 and pins.held() == []
    released = [call[1] for call in d.calls("unregister")[-2:]]
    assert sorted(released) == sorted([b.ctypes.data, c.ctypes.data])


def test_owner_over_the_budget_is_staged_and_not_retried():
    d = Runtime()
    big = np.zeros((2, 1024), dtype=np.float32)
    pins = d.cache(limit=big.nbytes - 1)
    assert [pins.lookup(big[i % 2]) for i in range(5)] == [None] * 5
    assert d.log == [] and pins.used == 0


def test_budget_shared_by_caches():
    """One cache, and its budget, shared by the servers of a process: a
    second server over the first's owner hits its registration (one in
    all), an owner that does not fit evicts the least recently used one
    whichever server used it, and releasing one server keeps what another
    still lands from."""
    d = Runtime()
    a, b = np.zeros((2, 64), np.float32), np.zeros((2, 64), np.float32)
    pins = d.cache(limit=a.nbytes + b.nbytes)
    assert pins.lookup(a[0], "one") is None
    pa = pins.lookup(a[0], "one")
    assert pa is not None and pins.lookup(a[1], "two") is pa
    assert pa.users == {"one", "two"} and len(d.calls("register")) == 1
    pins.release("one")
    assert pins.held() == [a] and pins.used == a.nbytes
    assert pins.lookup(b[0], "one") is None
    assert pins.lookup(b[0], "one") is not None
    c = np.zeros((2, 64), np.float32)
    assert pins.lookup(c[0], "two") is None
    assert pins.lookup(c[0], "two") is not None
    assert pins.held() == [b, c] and pins.used == b.nbytes + c.nbytes
    pins.release("two")
    assert pins.held() == [b] and pins.used == b.nbytes
    pins.release("one")
    assert pins.used == 0 and pins.held() == []


def test_failed_registration_is_staged_and_not_retried():
    d = Runtime(refuse=True)
    pins = d.cache()
    pool = np.zeros((3, 32), dtype=np.int16)
    assert [pins.lookup(pool[k % 3]) for k in range(6)] == [None] * 6
    assert len(d.calls("register")) == 1 and pins.used == 0
    assert pins.held() == []


def test_non_contiguous_block_is_staged_and_not_retried():
    """A strided block is staged and its owner refused: a contiguous block
    of it later is staged too, and nothing registers."""
    d = Runtime()
    pins = d.cache()
    pool = np.zeros((4, 8, 16), dtype=np.float32)
    assert pins.lookup(pool[0][:, ::2]) is None
    assert pins.lookup(pool[1]) is None and pins.lookup(pool[2]) is None
    assert d.log == []
    # once registered, a strided view of the owner is staged, the owner kept
    other = np.zeros((4, 8, 16), dtype=np.float32)
    pin = [pins.lookup(other[i]) for i in (0, 0)][1]
    assert pins.lookup(other[2].T) is None and pins.lookup(other[3]) is pin


def test_unnamed_memory_is_staged():
    """Bytes that neither an array nor a CPU tensor owns (a `bytes` object)
    are staged every time and never registered or kept."""
    d = Runtime()
    pins = d.cache()
    raw = bytes(256)
    for _ in range(3):
        assert pins.lookup(np.frombuffer(raw, dtype=np.int16)) is None
    assert d.log == [] and not pins._seen and not pins._refused
    assert owner_of(np.frombuffer(raw, dtype=np.int16)) is None


def test_default_budget_is_a_quarter_of_the_host():
    assert host_pins.PINS.limit == host_pins.host_budget_bytes() > 0
    pins = HostPins(lambda p, n: True, lambda p: None)
    assert pins.limit == host_pins.host_budget_bytes()


def test_dropped_owner_is_unregistered_without_close():
    """A caller that serves one array and drops it: the next lookup, of
    any block, lets the array go (after its last copy's event) and holds
    nothing alive; an owner the caller still holds, itself or through a
    view, stays registered."""
    d = Runtime()
    pins = d.cache()
    once = np.zeros((4, 8, 16), dtype=np.float32)
    kept = np.zeros((4, 8, 16), dtype=np.float32)
    for k in (0, 1, 0, 1):
        pin = pins.lookup(once[k])
    pin.event = Event(d, "last")
    [pins.lookup(kept[k]) for k in (0, 0)]
    view = kept[3]
    addr, gone = once.ctypes.data, weakref.ref(once)
    del once, pin, kept
    assert pins.lookup(np.zeros(4)) is None
    assert d.log[-2:] == [("wait", "last"), ("unregister", addr)]
    assert gone() is None and pins.held() == [view.base]
    assert pins.used == view.base.nbytes
    assert pins.lookup(view) is not None and len(d.calls("unregister")) == 1


def test_dropped_tensor_storage_is_unregistered_without_close():
    """The same for a torch tensor handed as NumPy views: its storage is
    held while any tensor over it lives, and let go once none does."""
    d = Runtime()
    pins = d.cache()
    t = torch.zeros(3, 4, 32)
    assert pins.lookup(np.asarray(t[0])) is None
    assert pins.lookup(np.asarray(t[0])) is not None
    row = t[2]
    del t
    pins.lookup(np.zeros(4))
    assert len(pins.held()) == 1 and d.calls("unregister") == []
    del row
    pins.lookup(np.zeros(4))
    assert pins.held() == [] and pins.used == 0
    assert len(d.calls("unregister")) == 1


def test_release_while_the_cache_is_busy_waits_for_the_next_lookup():
    """A server collected while the lock is held (during a lookup or
    another thread's copy) has its claims withdrawn by the next lookup."""
    d = Runtime()
    pins = d.cache()
    pool = np.zeros((2, 64), np.float32)
    [pins.lookup(pool[k], "srv") for k in (0, 0)]
    with pins.lock:
        pins.release("srv")
        assert pins.held() == [pool]
    pins.lookup(np.zeros(4))
    assert pins.held() == [] and d.calls("unregister") == [
        ("unregister", pool.ctypes.data)]


TD = dict(samplerate=44100, blocksize=256, upsample_factor=2, numtaps=31,
          batch=16, cutoff=9000.0, eq_enabled=False, downsample_mode="decimate",
          conv_strategy="td_mxu", dither_kind="tpdf", dither_bits=16)


def _served(kind):
    """(server, blocks) of a landing that is never direct."""
    rng = np.random.default_rng(7)
    pool = (rng.standard_normal((3, 16, 256)) * 0.2).astype(np.float32)
    if kind == "sharded":
        sp = ShardedPipeline(StreamConfig(**TD),
                             make_mesh(2, ("streams",), devices=["cpu"] * 2))
        srv = RingServer(sp, slots=4, chunk=2, max_inflight=1, seed=3)
    elif kind == "packed":
        p = Pipeline(StreamConfig(**TD), "cpu")
        bank, pk = batch.with_per_stream_filters(
            p, [dict(cutoff=4000.0 if i % 2 else 12000.0) for i in range(16)],
            pack=True)
        srv = RingServer(p, bank, slots=4, chunk=2, max_inflight=1, seed=3,
                         packing=pk)
    elif kind == "pair":
        p = Pipeline(StreamConfig(**{**TD, "ingest": "pair"}), "cpu")
        srv = RingServer(p, slots=4, chunk=2, max_inflight=1, seed=3)
    else:
        p = Pipeline(StreamConfig(**{**TD, "ingest": "pcm16"}), "cpu")
        srv = RingServer(p, slots=4, chunk=2, max_inflight=1, seed=3)
        pool = (pool * 30000).astype(np.int16)
    return srv, [pool[k % 3] for k in range(7)]


@pytest.mark.parametrize("kind", ["sharded", "packed", "pair", "cpu"])
def test_staged_landings_never_consult_the_cache(kind, monkeypatch):
    """Each block of one reused pool, served twice: no cache, no landing
    stream, no lookup and no direct copy; the outputs are the same both
    times."""

    def never(*args, **kwargs):
        raise AssertionError("the cache was consulted")

    monkeypatch.setattr(HostPins, "lookup", never)
    monkeypatch.setattr(serving, "land", never)
    monkeypatch.setattr(staging, "land", never)
    srv, blks = _served(kind)
    assert srv._pins is None and srv._land_stream is None
    first = np.stack(list(srv.stream(iter(blks))))
    srv.close()
    srv, blks = _served(kind)
    assert np.array_equal(np.stack(list(srv.stream(iter(blks)))), first)


def test_direct_landing_only_on_one_card_without_packing_or_pair():
    """The server's choice, from what it can observe: a card, the one-device
    rings, no packing and no pair ingest."""
    lands = serving.lands_directly
    assert lands(True, None, None, False)
    assert not lands(False, None, None, False)  # the CPU
    assert not lands(True, object(), None, False)  # a sharded pipeline
    assert not lands(True, None, object(), False)  # a packing
    assert not lands(True, None, None, True)  # pair ingest
