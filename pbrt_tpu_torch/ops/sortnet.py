"""``co_sort``: sort by one key and carry payload columns along
(counterpart of ``pbrt_tpu/ops/sortnet.py::co_sort``).

Keys are uint32 values (and the dead bit 31) carried in int64, so dead
lanes sort last as in the reference.  Two networks:

* ``"stable"`` (the default, the reference's ``lax.sort``): a stable
  ``torch.sort`` of the keys plus one gather per payload column gives the
  same permutation, so lanes come out in the same order;
* ``"bitonic"`` (the reference's ``PBRT_TPU_BITONIC=1``): the
  hierarchical bitonic network, taken exactly where the reference takes
  it (N >= 32768 and at most 22 columns; below 32768 the stable sort).
  Keys pad to a power of two with 0xFFFFFFFF; one local sort of every
  2048-lane block, then per merge size k > 2048 the passes at j >= 2048
  and one local tail (``kernels/bitonic.py``).  Only the lane
  permutation rides the network; each payload column is gathered once by
  it, bit-identical to the reference, which moves every column through
  every stage.  The network is not stable, but it is deterministic.

The reference splits a sort of more than 22 columns into groups (the
merged shadow+carry sort, not ported); here such a bitonic sort raises.
"""

from __future__ import annotations

import math

import torch

from pbrt_tpu_torch.kernels.bitonic import BLK, bitonic_local, bitonic_merge

MIN_N = 1 << 15  # below this the reference keeps lax.sort
MAX_COLUMNS = 22  # the reference's operand cap (sortnet.py:58)
KEY_PAD = 0xFFFFFFFF


def co_sort(operands, network="stable"):
    """operands[0]: int64 keys [N] (uint32 values); operands[1:]: payload
    tensors with leading dim N.  Returns the co-sorted tuple, ascending by
    key, in the lane order of ``network`` ("stable" or "bitonic")."""
    keys = operands[0]
    n = keys.shape[0]
    if network == "stable" or (network == "bitonic" and n < MIN_N):
        keys_s, order = torch.sort(keys, stable=True)
        return (keys_s,) + tuple(x[order] for x in operands[1:])
    if network != "bitonic":
        raise ValueError(f"co_sort: unknown network {network!r}")
    columns = sum(math.prod(x.shape[1:]) for x in operands)
    if columns > MAX_COLUMNS:
        raise ValueError(
            f"co_sort: {columns} columns exceed the reference's cap of {MAX_COLUMNS}; "
            "its split of wider sorts (the merged shadow+carry sort) is not ported"
        )
    keys_s, order = bitonic_order(keys)
    cols = operands[1:]
    if keys_s.shape[0] != n:  # padded: pad lanes carry zero payloads
        cols = tuple(torch.cat([x, x.new_zeros((keys_s.shape[0] - n,) + x.shape[1:])])
                     for x in cols)
        keys_s, order = keys_s[:n], order[:n]
    return (keys_s,) + tuple(x[order] for x in cols)


def bitonic_order(keys):
    """The bitonic network on int64 keys [N] (uint32 values) -> (sorted
    keys [N'], lane permutation [N'] int64), N' = N padded to a power of
    two >= 2048 with 0xFFFFFFFF keys."""
    n = keys.shape[0]
    n_pad = 1 << max((n - 1).bit_length(), BLK.bit_length() - 1)
    key = torch.full((n_pad,), KEY_PAD, dtype=torch.int64, device=keys.device)
    key[:n] = keys
    lane = torch.arange(n_pad, dtype=torch.int32, device=keys.device)
    bitonic_local(key, lane, 2, BLK)  # every block sorted (k = 2 .. 2048)
    k = 2 * BLK
    while k <= n_pad:
        j = k // 2
        while j >= BLK:
            bitonic_merge(key, lane, k, j)
            j //= 2
        bitonic_local(key, lane, k, k)  # the j < 2048 tail of merge size k
        k *= 2
    return key, lane.long()
