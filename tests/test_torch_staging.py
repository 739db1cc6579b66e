"""The native staging copy (`afp_tpu_torch/utils/host_copy.py` over
`csrc/host_copy.cpp`, built here with g++) against numpy, byte for byte:
every dtype the rings land (float32, int16, bf16 as its uint16 bits), sizes
from empty to 64 MiB, source and destination offsets 0-63 bytes, and pools
of 1, 2 and the process's threads; the refusals; the pool's size; and the
shared pool under concurrent callers.  The ``threads`` count on the stage
span needs a card: `test_torch_cuda.py`.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from afp_tpu_torch.utils import host_copy as H

MiB = 1 << 20


@pytest.fixture(scope="module")
def pools():
    """Pools of 1 and 2 threads, and the process's, by name."""
    made = {1: H.Copier(1), 2: H.Copier(2)}
    yield {**made, "full": H.copier()}
    for c in made.values():
        c.close()


def _bytes(t: torch.Tensor) -> np.ndarray:
    if not t.numel():
        return np.zeros(0, dtype=np.uint8)
    return t.contiguous().view(torch.uint8).numpy()


def _source(dtype, n, seed=0):
    """n elements of `dtype`, random bits; bf16 made from uint16 bits."""
    rng = np.random.default_rng(seed)
    if dtype == "bf16":
        bits = rng.integers(0, 1 << 16, n, dtype=np.uint16)
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    if dtype == np.float32:
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return torch.from_numpy(rng.integers(-32768, 32768, n, dtype=np.int16))


def _itemsize(dtype) -> int:
    return 2 if dtype == "bf16" else np.dtype(dtype).itemsize


@pytest.mark.parametrize("dtype", [np.float32, np.int16, "bf16"],
                         ids=["f32", "i16", "bf16"])
@pytest.mark.parametrize("size", [0, 1, 15, 4097, MiB + 3, "64MiB"])
def test_native_copy_equals_numpy(pools, dtype, size):
    """Sizes are elements, and 64 MiB of the dtype's bytes; `copy_into`
    over the process's pool, and each pool at the tensors' addresses."""
    n = 64 * MiB // _itemsize(dtype) if size == "64MiB" else size
    src = _source(dtype, n, seed=n)
    ref = _bytes(src).copy()  # numpy's copy of the bytes
    dst = torch.full_like(src, 7) if n else torch.empty_like(src)
    assert H.copy_into(dst, src) == (pools["full"].threads if n else 1)
    assert np.array_equal(_bytes(dst), ref)
    if not n:
        return
    for pool in pools.values():
        dst.fill_(7)
        assert pool.copy(dst.data_ptr(), src.data_ptr(), src.nbytes) == \
            pool.threads
        assert np.array_equal(_bytes(dst), ref)
        assert np.array_equal(_bytes(src), ref)  # the source only read


@pytest.mark.parametrize("threads", [1, 2, "full"])
@pytest.mark.parametrize("nbytes", [15, 4097, MiB + 3])
def test_native_copy_at_every_offset(pools, threads, nbytes):
    """Source and destination at byte offsets 0-63 from a 64-byte line:
    the head, the streamed body, the tail and the slice edges all land,
    and no byte around the destination is written."""
    pool = pools[threads]
    rng = np.random.default_rng(nbytes)
    src_buf = np.zeros(nbytes + 192, dtype=np.uint8)
    dst_buf = np.zeros(nbytes + 192, dtype=np.uint8)
    base_s = -src_buf.ctypes.data % 64
    base_d = -dst_buf.ctypes.data % 64
    payload = rng.integers(0, 256, nbytes, dtype=np.uint8)
    dst_offsets = range(64) if nbytes < MiB else (0, 1, 17, 48, 63)
    for so in range(64):
        s0 = base_s + so
        src_buf[:] = 0
        src_buf[s0:s0 + nbytes] = payload
        for do in dst_offsets:
            d0 = base_d + do
            dst_buf[:] = 0xA5
            assert pool.copy(dst_buf.ctypes.data + d0,
                             src_buf.ctypes.data + s0, nbytes) == pool.threads
            assert np.array_equal(dst_buf[d0:d0 + nbytes], payload), (so, do)
            assert (dst_buf[:d0] == 0xA5).all() and \
                (dst_buf[d0 + nbytes:] == 0xA5).all(), (so, do)


def test_copy_into_refuses_what_it_cannot_copy():
    """A non-contiguous tensor is refused (`to_device` stages it with
    ``copy_``), as is a byte count that differs or a tensor off the
    host."""
    src = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        H.copy_into(torch.empty(8, 8), src.t())
    with pytest.raises(ValueError, match="contiguous"):
        H.copy_into(torch.empty(8, 8).t(), src)
    with pytest.raises(ValueError, match="bytes"):
        H.copy_into(torch.empty(8, 4), src)
    with pytest.raises(ValueError, match="host"):
        H.copy_into(torch.empty(8, 8, device="meta"), src)
    dst = torch.empty(8, 8)
    assert H.copy_into(dst, src) == H.copier().threads
    assert torch.equal(dst, src)


def test_pool_threads_follow_the_affinity_mask():
    """The process's pool takes one thread a CPU of the affinity mask, the
    caller's included, up to MAX_THREADS; a pool of 1 has no workers and
    below 1 counts as 1; a wide pool copies whole; close joins the
    workers."""
    assert H.copier().threads == min(len(os.sched_getaffinity(0)),
                                     H.MAX_THREADS)
    assert H.copier() is H.copier()
    for asked, threads in ((0, 1), (1, 1), (3, 3), (H.MAX_THREADS + 4,
                                                    H.MAX_THREADS + 4)):
        c = H.Copier(asked)
        try:
            assert c.threads == threads
            src = np.arange(1 << 16, dtype=np.uint8)
            dst = np.zeros_like(src)
            assert c.copy(dst.ctypes.data, src.ctypes.data,
                          src.nbytes) == threads
            assert np.array_equal(dst, src)
        finally:
            c.close()
        c.close()  # twice is harmless


def test_shared_pool_under_concurrent_callers():
    """More calling threads than CPUs, each copying its own blocks through
    the one pool at a short switch interval: every copy lands whole."""
    n_callers = 2 * H.copier().threads + 2
    errors = []

    def caller(i):
        rng = np.random.default_rng(i)
        src = torch.from_numpy(rng.integers(0, 256, 3 * MiB + i,
                                            dtype=np.uint8))
        dst = torch.empty_like(src)
        for _ in range(8):
            dst.fill_(0)
            H.copy_into(dst, src)
            if not torch.equal(dst, src):
                errors.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(n_callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
