"""The comparison that decides `correct`.

During the window the loop hands every output block the program returns
to a :class:`Keeper`, which keeps, of a sample of rows drawn from the seed
(one in each of 16 equal groups of the batch, so no half of the batch goes
unseen), a uniform sample of blocks drawn from the seed (a reservoir) and
the last blocks.  Once the window has closed, the program's memory peak has
been read and its state freed, the plain reference that the configuration
names (``"reference"``: `reference/<module>.py`, by default
`reference/chain.py`; `Bench.reference`) works out the same rows of the
same blocks from the generated inputs, and :func:`compare` measures:

* ``err_db`` (float outputs): the worst row's max |program − reference|
  over the row's max |reference|, in dB;
* ``err_lsb`` (int16 outputs): the max distance, in 16-bit steps, between
  the program's int16 sample and the reference's exact value before
  rounding, saturated as the quantizer saturates (0.5 is rounding alone);
* ``unanswered``: blocks fed to the program that never came back.

Each has its limit in the configuration's ``limits``.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["Keeper", "sample_rows", "compare"]

ROW_GROUPS = 16
KEEP_BLOCKS = 64
KEEP_LAST = 4
#: the number a comparison reports where the error is not finite
NOT_FINITE = 1e9


def sample_rows(batch: int, seed: int) -> np.ndarray:
    """One row drawn from the seed in each of `ROW_GROUPS` equal groups."""
    rng = np.random.default_rng([int(seed) & 0xFFFF_FFFF_FFFF_FFFF, 1])
    n = min(ROW_GROUPS, batch)
    edges = np.linspace(0, batch, n + 1).astype(int)
    return np.array([rng.integers(a, b) for a, b in zip(edges[:-1], edges[1:])])


class Keeper:
    """Keeps the sampled rows of a seeded reservoir of the window's blocks
    and of its last `KEEP_LAST` blocks, by global block index."""

    def __init__(self, rows: np.ndarray, seed: int):
        self.rows = rows
        self._rng = np.random.default_rng([int(seed) & 0xFFFF_FFFF_FFFF_FFFF, 2])
        self._res: list = []  # [(block index, rows)]
        self._last: deque = deque(maxlen=KEEP_LAST)
        self.offered = 0
        self.nonfinite = 0

    def offer(self, k: int, out: np.ndarray) -> None:
        """Block `k`'s output [batch, blocksize] (copied at once: the
        program may reuse its buffer)."""
        kept = out[self.rows]
        if kept.dtype != np.int16 and not np.isfinite(kept).all():
            self.nonfinite += 1
        item = (int(k), kept)
        self._last.append(item)
        if len(self._res) < KEEP_BLOCKS:
            self._res.append(item)
        else:
            j = int(self._rng.integers(0, self.offered + 1))
            if j < KEEP_BLOCKS:
                self._res[j] = item
        self.offered += 1

    def kept(self) -> tuple[list, np.ndarray]:
        """(sorted block indices, outputs [n, rows, blocksize])."""
        items = dict(self._res)
        items.update(dict(self._last))
        ks = sorted(items)
        if not ks:
            return [], np.zeros((0, len(self.rows), 0))
        return ks, np.stack([items[k] for k in ks])


def err_db(prog: np.ndarray, ref: np.ndarray) -> float:
    """Worst row's max-abs error over its max |reference|, in dB."""
    p = prog.astype(np.float64)
    num = np.abs(p - ref).max(axis=(0, 2))
    den = np.abs(ref).max(axis=(0, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        e = np.where(den > 0, num / den, np.inf)
    return float(20.0 * np.log10(max(float(np.max(e)), 1e-300)))


def err_lsb(prog: np.ndarray, ref: np.ndarray) -> float:
    """Max |int16 sample − reference value × 32768, saturated|."""
    r = np.clip(ref * 32768.0, -32768.0, 32767.0)
    return float(np.abs(prog.astype(np.float64) - r).max())


def compare(prog: np.ndarray, ref: np.ndarray, limits: dict,
            unanswered: int, nonfinite: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the kept outputs `prog`
    against the reference `ref` (before quantization)."""
    nums = {}
    if prog.size:
        if prog.dtype == np.int16:
            nums["err_lsb"] = {"value": err_lsb(prog, ref),
                               "limit": float(limits["err_lsb"])}
        else:
            nums["err_db"] = {"value": err_db(prog, ref),
                              "limit": float(limits["err_db"])}
    nums["unanswered"] = {"value": int(unanswered), "limit": 0}
    nums["nonfinite"] = {"value": int(nonfinite), "limit": 0}
    for v in nums.values():  # a NaN or an infinity reads as a huge error
        if not np.isfinite(v["value"]):
            v["value"] = NOT_FINITE
    ok = bool(prog.size) and all(v["value"] <= v["limit"] for v in nums.values())
    return ok, nums
