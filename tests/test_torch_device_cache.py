"""The port's DeviceBatchCache (coalign_tpu_torch/data/device_cache.py) on
the CPU device: the five behaviours tests/test_device_cache.py holds the
JAX package's to (everything cached under the cap and replayed as the same
tensors; only a prefix kept past the cap, in order; an abandoned epoch
does not mark the cache complete; the cached batches are usable tensors;
an indexable source's cached prefix is not read again), and the refusal of
``sharding`` on one card."""

import numpy as np
import pytest
import torch

from coalign_tpu_torch.data.device_cache import DeviceBatchCache


def _batches(n, nbytes=4096):
    for i in range(n):
        yield {"x": np.full((nbytes // 4,), i, np.float32),
               "i": np.array([i], np.int32)}


def _cache(**kw):
    return DeviceBatchCache(device="cpu", **kw)


def test_caches_everything_under_cap():
    cache = _cache(max_bytes=1 << 20)
    ep1 = list(cache.epoch(_batches(5)))
    assert cache.num_cached == 5 and cache._complete
    assert cache.cached_bytes == 5 * (4096 + 4)
    ep2 = list(cache.epoch(_batches(5)))
    assert len(ep2) == 5
    # replayed batches are the same tensors: no second copy
    assert all(a["x"] is b["x"] for a, b in zip(ep1, ep2))
    for i, b in enumerate(ep2):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        assert int(b["i"][0]) == i
        assert bool((b["x"] == i).all())


def test_cap_keeps_prefix_only():
    cache = _cache(max_bytes=10000)          # ~2.5 batches of ~4 KB
    ep1 = list(cache.epoch(_batches(6)))
    assert len(ep1) == 6
    assert cache.num_cached == 2
    assert not cache._complete
    ep2 = list(cache.epoch(_batches(6)))
    assert [int(b["i"][0]) for b in ep2] == list(range(6))
    # once over the cap, no later batch is kept, even one that fits
    cache2 = _cache(max_bytes=5000)
    big_then_small = [{"x": np.zeros(1024, np.float32)},
                      {"x": np.zeros(1024, np.float32)},
                      {"x": np.zeros(8, np.float32)}]
    list(cache2.epoch(iter(big_then_small)))
    assert cache2.num_cached == 1
    list(cache2.epoch(iter(big_then_small)))
    assert cache2.num_cached == 1


def test_abandoned_epoch_does_not_mark_complete():
    cache = _cache(max_bytes=1 << 20)
    it = cache.epoch(_batches(5))
    next(it)
    del it
    assert not cache._complete
    ep = list(cache.epoch(_batches(5)))
    assert [int(b["i"][0]) for b in ep] == list(range(5))
    assert cache._complete


def test_batches_stay_usable_in_a_computation():
    cache = _cache()
    ep = list(cache.epoch(_batches(3)))
    assert float(torch.sum(ep[2]["x"])) == 2.0 * 1024
    nested = list(_cache().epoch([{"a": {"b": np.ones(3, np.float32)}}]))
    assert torch.equal(nested[0]["a"]["b"], torch.ones(3))


def test_indexable_source_skipped_without_consumption():
    calls = []

    class Seq:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            calls.append(i)
            return {"x": np.full((2, 2), i, np.float32)}

    cache = _cache(max_bytes=3 * 16)          # 3 batches of one (2, 2) f32
    assert [int(b["x"][0, 0]) for b in cache.epoch(Seq())] == [0, 1, 2, 3, 4]
    assert calls == [0, 1, 2, 3, 4] and cache.num_cached == 3
    calls.clear()
    assert [int(b["x"][0, 0]) for b in cache.epoch(Seq())] == [0, 1, 2, 3, 4]
    assert calls == [3, 4]              # the prefix replayed, the tail read


def test_sharding_and_a_missing_gpu_are_refused():
    with pytest.raises(ValueError, match="sharding"):
        DeviceBatchCache(device="cpu", sharding=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceBatchCache()
