"""Page-locking the memory a caller hands the pump, so that a block lands by
DMA straight from it (`utils/staging.py:land`), with no host stage copy.

:data:`PINS` is the process's one pin-down cache, as MPI and UCX keep one:
every server that lands directly shares it.  It is keyed by a block's
memory owner, the outermost object that owns the block's bytes (the NumPy
``.base`` chain followed to its end: an array that owns its data, or a CPU
tensor's storage).

- The first sighting of a block's bytes (its address and length) only
  records them, under their owner, in a table of weak references.  A
  caller that hands fresh memory each block keeps nothing alive here, and
  neither it nor one that walks once through one array pays for a
  registration: page-locking ran at 6-9 GiB/s beside an H100, against
  the stage copy's 13-28 GiB/s, so locking memory that is read once
  costs more than staging it.
- The second sighting of the same bytes in a live owner, by any server,
  page-locks the owner's whole byte range once (``cudaHostRegister``,
  traced as ``afp.h2d.register`` with ``bytes``) and holds a strong
  reference to it, so that its address stays its own while it is
  registered.  Every later block of the owner, any view of it, is a hit,
  for every server.
- A registered owner is let go, and unregistered once the event of the last
  copy that read it has completed, as soon as one of these holds:

  * nothing but the cache references it: the caller has dropped it
    (checked at every lookup);
  * no server that landed from it is left: each server releases its claims
    when it is closed or collected (:meth:`HostPins.release`);
  * the budget needs its room.  Registered bytes stay under a quarter of
    the host's physical memory (:func:`host_budget_bytes`); the least
    recently used owners are evicted to make room.

- An owner that cannot be used is staged as before and not tried again (a
  negative cache, weak as well): a registration that fails (read-only or
  file-backed pages, memory that is already page-locked, an owner over the
  budget) or a block that is not contiguous.  Memory that neither an array
  nor a CPU tensor owns (a ``bytes`` object, say) is staged every time.

Servers may pump on threads of their own: :attr:`HostPins.lock` is held
from a lookup to the record of its copy's event (`utils/staging.py:land`),
so that no eviction unregisters memory a copy is about to read.  The
register and unregister functions are injected in tests; on a card they
are the CUDA runtime's.
"""
from __future__ import annotations

import functools
import os
import sys
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from . import trace

__all__ = ["PINS", "HostPins", "Pin", "host_budget_bytes", "owner_of"]


def host_budget_bytes() -> int:
    """A quarter of the host's physical memory, in bytes."""
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4


def owner_of(a: np.ndarray):
    """(owner, address, byte length) of the memory behind the array `a`:
    the end of its ``.base`` chain, or None where its bytes cannot be
    named."""
    base = a
    while isinstance(base, np.ndarray) and base.base is not None:
        base = base.base
    if isinstance(base, np.ndarray):
        return base, base.ctypes.data, base.nbytes
    if isinstance(base, torch.Tensor) and base.device.type == "cpu":
        st = base.untyped_storage()
        return st, st.data_ptr(), st.nbytes()
    return None


def _cuda_register(ptr: int, nbytes: int) -> bool:
    rt = torch.cuda.cudart()
    if int(rt.cudaHostRegister(ptr, nbytes, 0)) == 0:
        return True
    # the runtime keeps the failure as its last error, which the next
    # kernel launch's check would raise: take it off here
    try:
        torch.zeros(1, device="cuda")
    except RuntimeError:
        pass
    return False


def _cuda_unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


class Pin:
    """A registered owner: held strongly, with the event of the last copy
    that read it (None before the first) and the servers that landed from
    it."""

    __slots__ = ("owner", "ptr", "nbytes", "event", "users")

    def __init__(self, owner, ptr: int, nbytes: int):
        self.owner, self.ptr, self.nbytes = owner, ptr, nbytes
        self.event = None
        self.users: set = set()


def _refs(owner) -> int:
    return sys.getrefcount(owner)


def _pin_only_refs() -> int:
    pin = Pin(np.empty(0), 0, 0)
    return _refs(pin.owner)


#: what `_refs(pin.owner)` reads when nothing but the pin holds the owner
_PIN_ONLY = _pin_only_refs()


def _forget(table: dict, key: int, ref) -> None:
    if table.get(key, (None,))[0] is ref:
        del table[key]


class HostPins:
    """The pin-down cache (see the module): :meth:`lookup` a block before
    its copy, under :attr:`lock`, and set the returned pin's ``event`` to
    the copy's."""

    def __init__(self, register: Optional[Callable[[int, int], bool]] = None,
                 unregister: Optional[Callable[[int], None]] = None,
                 limit: Optional[int] = None):
        self._register = register or _cuda_register
        self._unregister = unregister or _cuda_unregister
        #: the bytes that may stay registered at once, and those that are
        self.limit = host_budget_bytes() if limit is None else int(limit)
        self.used = 0
        self.lock = threading.Lock()
        #: id(owner) → (weakref, the (address, length) of each block of
        #: it sighted once); id(owner) → (weakref, None): never tried again
        self._seen: dict = {}
        self._refused: dict = {}
        self._held: OrderedDict = OrderedDict()  # id(owner) → Pin, LRU first
        self._gone: list = []  # servers released while the lock was held

    def _note(self, table: dict, owner, value=None) -> None:
        key = id(owner)
        try:
            ref = weakref.ref(owner, functools.partial(_forget, table, key))
        except TypeError:  # not weakly referable: neither kept nor counted
            return
        table[key] = (ref, value)

    @staticmethod
    def _get(table: dict, owner):
        """The value `owner` is noted with in `table`, or None."""
        entry = table.get(id(owner))
        if entry is not None and entry[0]() is owner:
            return entry
        return None

    def _in(self, table: dict, owner) -> bool:
        return self._get(table, owner) is not None

    def lookup(self, block: np.ndarray, user=None) -> Optional[Pin]:
        """The registration that covers `block`'s bytes, made now on the
        second sighting of those bytes, with `user` (a server's token)
        among its users; None where the block is to be staged.  First lets
        go of the owners the callers have dropped."""
        while self._gone:
            self._let_go(self._gone.pop())
        for key, pin in list(self._held.items()):
            if _refs(pin.owner) <= _PIN_ONLY and (
                    isinstance(pin.owner, np.ndarray)
                    or torch._C._storage_Use_Count(pin.owner._cdata) == 1):
                self._drop(self._held.pop(key))
        found = owner_of(block)
        if found is None:
            return None
        owner, ptr, nbytes = found
        key = id(owner)
        lo = block.ctypes.data
        if (not block.flags.c_contiguous or not block.nbytes or lo < ptr
                or lo + block.nbytes > ptr + nbytes):
            if key not in self._held:
                self._refuse(owner)
            return None
        pin = self._held.get(key)  # held strongly: `key` is still its id
        if pin is None:
            if self._in(self._refused, owner):
                return None
            seen = self._get(self._seen, owner)
            if seen is None:
                self._note(self._seen, owner, {(lo, block.nbytes)})
                return None
            if (lo, block.nbytes) not in seen[1]:
                seen[1].add((lo, block.nbytes))
                return None
            del self._seen[key]
            pin = self._pin(owner, ptr, nbytes)
            if pin is None:
                return None
        # an owner's range cannot move: NumPy resizes no array that is
        # referenced (the pin holds it), and torch no storage that has been
        # handed out as NumPy views
        self._held.move_to_end(key)
        pin.users.add(user)
        return pin

    def _refuse(self, owner) -> None:
        self._seen.pop(id(owner), None)
        self._note(self._refused, owner)

    def _pin(self, owner, ptr: int, nbytes: int) -> Optional[Pin]:
        if nbytes > self.limit:
            self._refuse(owner)
            return None
        while self.used + nbytes > self.limit:
            self._drop(self._held.popitem(last=False)[1])
        with trace.span("afp.h2d.register", nbytes=nbytes):
            ok = self._register(ptr, nbytes)
        if not ok:
            self._refuse(owner)
            return None
        self.used += nbytes
        pin = self._held[id(owner)] = Pin(owner, ptr, nbytes)
        return pin

    def _drop(self, pin: Pin) -> None:
        if pin.event is not None:
            pin.event.synchronize()
        self._unregister(pin.ptr)
        self.used -= pin.nbytes

    def _let_go(self, user) -> None:
        for key, pin in list(self._held.items()):
            pin.users.discard(user)
            if not pin.users:
                self._drop(self._held.pop(key))

    def held(self) -> list:
        """The owners held registered, least recently used first."""
        return [p.owner for p in self._held.values()]

    def release(self, user=None) -> None:
        """Withdraw `user`'s claims: unregister every owner no other server
        landed from, each after its last copy's event.  Where the lock is
        held (a server collected during a lookup, or another thread's
        copy), the next lookup does it."""
        if not self.lock.acquire(blocking=False):
            self._gone.append(user)
            return
        try:
            self._let_go(user)
        finally:
            self.lock.release()


#: the process's cache, shared by every server that lands directly
PINS = HostPins()
