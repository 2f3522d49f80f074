"""Device-resident batch cache: copy each batch to the device once.

The port's copy of coalign_tpu/data/device_cache.py. A loop that visits a
fixed split every epoch (evaluation, a small training set) can keep its
padded, fixed-shape batches on the device and never assemble or copy them
again. An OPV2V-scale intermediate-fusion batch of 5 agents is ~2.5 MB a
frame, so the 2170-frame test split takes ~5.4 GB, beside the model in the
card's memory.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import torch

from coalign_tpu_torch.runtime import resolve_device


def _to_device(batch, device):
    """A batch (a dict of arrays or tensors, nested dicts allowed) as
    tensors on ``device``, and its size in bytes."""
    if isinstance(batch, dict):
        out, size = {}, 0
        for k, v in batch.items():
            out[k], n = _to_device(v, device)
            size += n
        return out, size
    t = torch.as_tensor(batch).to(device)
    return t, t.element_size() * t.numel()


class DeviceBatchCache:
    """Keeps device copies of batches across epochs, up to ``max_bytes``.

    The first epoch copies each batch of the source to ``device`` (CUDA
    unless named) and keeps the copies while they fit. Later epochs replay
    the kept copies, with no host or copy work, and take the rest from the
    source again. The cache is always a prefix of the source's (stable)
    order: once a batch does not fit, no later one is kept, even one that
    would. ``sharding`` has no meaning on one card, and is refused."""

    def __init__(self, max_bytes: int = 6 << 30, device=None, sharding=None):
        if sharding is not None:
            raise ValueError("DeviceBatchCache has no sharding on one card")
        self.max_bytes = int(max_bytes)
        self.device = resolve_device(device)
        self._cached: list = []
        self._bytes = 0
        self._complete = False
        self._overflowed = False

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def cached_bytes(self) -> int:
        return self._bytes

    def epoch(self, source: Iterable) -> Iterator:
        """Yield one epoch of device batches.

        ``source`` is a fresh iterable of host (or device) batches in a
        stable order, read only on the first epoch and for the batches past
        the cached prefix later. A source with ``__getitem__`` and
        ``__len__`` is indexed past the prefix, so the prefix costs no host
        work; a plain iterator is advanced past it (each skipped batch is
        still produced)."""
        yield from self._cached
        if self._complete:
            return
        if hasattr(source, "__getitem__") and hasattr(source, "__len__"):
            it = (source[i] for i in range(len(self._cached), len(source)))
        else:
            it = iter(source)
            for _ in range(len(self._cached)):
                next(it, None)
        full = self._bytes >= self.max_bytes or self._overflowed
        for batch in it:
            db, size = _to_device(batch, self.device)
            if not full and self._bytes + size <= self.max_bytes:
                self._cached.append(db)
                self._bytes += size
            else:
                full = self._overflowed = True
            yield db
        # reached only when the source ran out: an abandoned epoch never
        # marks the cache complete
        if not full:
            self._complete = True
