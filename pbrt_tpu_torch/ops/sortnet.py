"""``co_sort``: sort by one key and carry payload columns along
(counterpart of ``pbrt_tpu/ops/sortnet.py::co_sort``).

Keys are uint32 values (and the dead bit 31) carried in int64, so dead
lanes sort last as in the reference.  Two networks:

* ``"stable"`` (the default, the reference's ``lax.sort``): a stable
  ``torch.sort`` of the keys plus one gather per payload column gives the
  same permutation, so lanes come out in the same order;
* ``"bitonic"`` (the reference's ``PBRT_TPU_BITONIC=1``): the bitonic
  network, taken exactly where the reference takes it (N >= 32768 and at
  most 22 columns; below 32768 the stable sort), as one call of
  ``kernels/bitonic.bitonic_co_sort``: keys padded to a power of two with
  0xFFFFFFFF, the network's launches, and one gather of every payload
  column by the lane permutation -- bit-identical to the reference,
  which moves every column through every stage.  The network is not
  stable, but it is deterministic.

A sort of more than 22 columns (the merged shadow+carry sort's 32) takes
the reference's split whatever ``network`` says: groups of 20 payload
columns, each sorted by (key, lane).  That pair is unique per lane, so
every group gets the one stable order: here a stable ``torch.sort`` of
the keys and a gather per payload column, never the network.

Gradients: the stable network is a permutation by indexing, which
autograd differentiates.  The bitonic network is not differentiable (the
reference's raises under ``jax.grad``; the card's kernel writes through
raw pointers): where it would run, a payload that requires grad raises
while grad mode is on, on every device.
"""

from __future__ import annotations

import math

import torch

from pbrt_tpu_torch.kernels.bitonic import bitonic_co_sort

MIN_N = 1 << 15  # below this the reference keeps lax.sort
MAX_COLUMNS = 22  # the reference's operand cap (sortnet.py:58)


def co_sort(operands, network="stable"):
    """operands[0]: int64 keys [N] (uint32 values); operands[1:]: payload
    tensors with leading dim N.  Returns the co-sorted tuple, ascending by
    key, in the lane order of ``network`` ("stable" or "bitonic")."""
    keys = operands[0]
    n = keys.shape[0]
    if network not in ("stable", "bitonic"):
        raise ValueError(f"co_sort: unknown network {network!r}")
    columns = sum(math.prod(x.shape[1:]) for x in operands)
    if network == "stable" or n < MIN_N or columns > MAX_COLUMNS:
        keys_s, order = torch.sort(keys, stable=True)
        return (keys_s,) + tuple(x[order] for x in operands[1:])
    keys_s, _, cols = bitonic_co_sort(keys.contiguous(), operands[1:])
    return (keys_s,) + cols
