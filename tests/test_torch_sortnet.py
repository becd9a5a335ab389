"""The port's ``co_sort`` against the reference's (pbrt_tpu/ops/sortnet.py).

``network="bitonic"`` runs the plain PyTorch version of the bitonic
kernels here; the reference runs its Pallas network in interpret mode
under ``PBRT_TPU_BITONIC=1``.  The network is not stable, so sorted keys
alone prove nothing: keys and every payload column must be equal, bit for
bit.  The card's kernels are held against the plain version by
tests/test_torch_cuda.py and chip_smoke.py.

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu.ops.sortnet import co_sort as ref_co_sort


def _keys(n, seed):
    """uint32 keys with heavy duplicates (64 distinct low parts) and the
    dead bit 31 set on about half of them."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 64, n).astype(np.uint32) * np.uint32(977)
    return keys | (rng.integers(0, 2, n).astype(np.uint32) << np.uint32(31))


def test_bitonic_co_sort_matches_reference(monkeypatch):
    import torch

    from pbrt_tpu_torch.kernels import bitonic
    from pbrt_tpu_torch.ops.sortnet import co_sort

    monkeypatch.setenv("PBRT_TPU_BITONIC", "1")
    n = 1 << 15
    rng = np.random.default_rng(0)
    keys = _keys(n, 0)
    a = rng.normal(size=n).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    lane = np.arange(n, dtype=np.int32)
    want = [np.asarray(x) for x in ref_co_sort(
        (jnp.asarray(keys), jnp.asarray(a), jnp.asarray(lane)), interpret=True)]
    launches = dict(bitonic.LAUNCHES)
    got = co_sort((torch.as_tensor(keys.astype(np.int64)), torch.as_tensor(a),
                   torch.as_tensor(lane), torch.as_tensor(v)), network="bitonic")
    assert bitonic.LAUNCHES == launches  # CPU tensors: plain version, no launch
    np.testing.assert_array_equal(got[0].numpy(), want[0].astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    # a wider column rides the same permutation as the reference's columns
    np.testing.assert_array_equal(got[3].numpy(), v[want[2]])
    # the network's own order, not the stable one
    assert not np.array_equal(want[2], np.argsort(keys, kind="stable"))

    # padded to the next power of two: still a sorted pairing of every lane
    m = n + 1000
    keys_m = _keys(m, 1)
    k_s, lane_s = co_sort((torch.as_tensor(keys_m.astype(np.int64)),
                           torch.arange(m)), network="bitonic")
    np.testing.assert_array_equal(k_s.numpy(), np.sort(keys_m).astype(np.int64))
    np.testing.assert_array_equal(keys_m[lane_s.numpy()], np.sort(keys_m))
    assert len(np.unique(lane_s.numpy())) == m


def test_co_sort_fallbacks(monkeypatch):
    import torch

    from pbrt_tpu_torch.ops.sortnet import co_sort

    monkeypatch.setenv("PBRT_TPU_BITONIC", "1")
    n = 4096  # below 32768 both take the stable sort
    keys = _keys(n, 2)
    a = np.arange(n, dtype=np.float32)
    want = [np.asarray(x) for x in ref_co_sort((jnp.asarray(keys), jnp.asarray(a)),
                                               interpret=True)]
    for network in ("stable", "bitonic"):
        got = co_sort((torch.as_tensor(keys.astype(np.int64)), torch.as_tensor(a)),
                      network=network)
        np.testing.assert_array_equal(got[0].numpy(), want[0].astype(np.int64))
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    # above the reference's cap of 22 columns its split into (key, lane)
    # groups gives the stable order, whatever the network
    big = torch.as_tensor(_keys(1 << 15, 3).astype(np.int64))
    wide = torch.as_tensor(np.random.default_rng(4).normal(size=(1 << 15, 22)),
                           dtype=torch.float32)
    got = co_sort((big, wide), network="bitonic")
    order = torch.sort(big, stable=True).indices
    assert torch.equal(got[0], big[order]) and torch.equal(got[1], wide[order])
    with pytest.raises(ValueError, match="unknown network"):
        co_sort((big, big), network="radix")
