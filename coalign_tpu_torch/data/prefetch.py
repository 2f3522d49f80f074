"""Host -> device input pipeline: batches assembled and copied ahead.

Port of coalign_tpu/data/prefetch.py ``prefetch``. The reference hides its
host-side batch work in 4 DataLoader worker processes (ref
opencood/tools/train.py:42). Here a side thread assembles the next batches
while the device runs the current step and, on CUDA, puts each one into
pinned host memory and copies it to the card with ``non_blocking=True`` on
a side stream, so the copy overlaps the step too. Threads suffice: batch
assembly is numpy, which releases the interpreter lock for its array work,
and the consumer spends its time waiting on the device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from coalign_tpu_torch.runtime import resolve_device

_SENTINEL = object()


def _tree_map(fn, batch: dict) -> dict:
    """``fn`` on every array of a batch, into nested dicts (a camera
    batch's ``image_inputs``)."""
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in batch.items()}


def _copier(device: torch.device):
    """(batch of numpy arrays) -> (batch of tensors on ``device``, the CUDA
    event that marks the end of its copy or None)."""
    if device.type != "cuda":
        return lambda batch: (_tree_map(
            lambda v: torch.as_tensor(np.asarray(v), device=device),
            batch), None)
    stream = torch.cuda.Stream(device)

    def copy(batch):
        with torch.cuda.stream(stream):
            out = _tree_map(
                lambda v: torch.from_numpy(np.ascontiguousarray(v))
                .pin_memory().to(device, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    return copy


def prefetch(iterator, size: int = 2, device=None, to_device: bool = True):
    """Yield the batches of ``iterator`` as dicts of tensors on ``device``
    (CUDA unless named), assembled and copied ``size`` batches ahead in a
    side thread. On CUDA the consumer's stream waits for each batch's copy
    before it is yielded. With ``to_device`` False the batches stay the
    host dicts that ``iterator`` yields, assembled ahead all the same (an
    evaluation reads its gt on the host). An exception in the thread is
    raised here."""
    if to_device:
        dev = resolve_device(device)
        copy = _copier(dev)
    else:
        dev = None

        def copy(batch):
            return batch, None
    out_q: queue.Queue = queue.Queue(maxsize=max(1, size))
    errors: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(copy(item)):
                    return
        except BaseException as e:  # raised to the consumer below
            errors.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True, name="port-prefetch")
    t.start()
    try:
        while True:
            item = out_q.get()
            if item is _SENTINEL:
                break
            batch, done = item
            if done is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(done)
                for v in batch.values():
                    # the side stream allocated it; the consumer's stream
                    # uses it from here on
                    v.record_stream(current)
            yield batch
        if errors:
            raise errors[0]
    finally:
        stop.set()
        t.join()
