"""The bitonic sort network: CUDA kernels and their plain PyTorch version.

Two wrappers over the hand-written kernels in ``csrc/bitonic.cu``, which
together replace ``pbrt_tpu/ops/sortnet.py::_local_kernel`` (K5) and the
XLA passes between its calls (``_global_pass``):

* :func:`bitonic_local` runs, per 2048-lane block, every stage of merge
  sizes ``k_lo .. k_hi`` whose exchange distance is below the block;
* :func:`bitonic_merge` runs one pass at distance ``j >= 2048``.

Both work in place on a key array (int64 holding uint32 values, compared
as uint32) and the lane permutation that rides the network.  A wrapper
runs its plain version, the same stages as reshaped tensor butterflies,
only because its tensors lie on the CPU; on CUDA tensors it launches its
kernel or raises.  Both apply the reference's exact take rule, so the
permutation is bit-identical.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from pbrt_tpu_torch.kernels import build

BLK = 2048  # lanes per locally sorted block (pbrt_tpu/ops/sortnet.py)

LAUNCHES = {"bitonic_local": 0, "bitonic_merge": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library():
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    if _lib is None:
        lib = build.load("bitonic")
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.launch_bitonic_local.argtypes = [p, p, ll, ll, ll, p]
        lib.launch_bitonic_local.restype = ctypes.c_int
        lib.launch_bitonic_merge.argtypes = [p, p, ll, ll, ll, p]
        lib.launch_bitonic_merge.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, key, lane):
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    build.check_tensor("key", key, torch.int64, dev, 1)
    build.check_tensor("lane", lane, torch.int32, dev, 1)
    n = key.shape[0]
    if lane.shape[0] != n or n < BLK or n & (n - 1):
        raise ValueError(f"{name}: expected key and lane of one power-of-two length "
                         f">= {BLK}, got {n} and {lane.shape[0]}")
    return dev, n


def bitonic_local(key, lane, k_lo, k_hi):
    """In place: the stages of merge sizes k = k_lo, 2 k_lo, .., k_hi
    (powers of two) with exchange distance j = min(k, 2048)/2 .. 1, on
    key [N] int64 (uint32 values) and lane [N] int32, N a power of two
    >= 2048."""
    if key.device.type == "cpu":
        return bitonic_local_plain(key, lane, k_lo, k_hi)
    dev, n = _check("bitonic_local", key, lane)
    lib = load_library()
    build.launch_checked(lib, lib.launch_bitonic_local, key.data_ptr(), lane.data_ptr(),
                         n, int(k_lo), int(k_hi), torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["bitonic_local"] += 1


def bitonic_merge(key, lane, k, j):
    """In place: one compare-exchange pass at distance j (>= 2048) for
    merge size k, on the arrays of :func:`bitonic_local`."""
    if key.device.type == "cpu":
        return bitonic_merge_plain(key, lane, k, j)
    dev, n = _check("bitonic_merge", key, lane)
    if not BLK <= j < k <= n:
        raise ValueError(f"bitonic_merge: need {BLK} <= j < k <= {n}, got j={j} k={k}")
    lib = load_library()
    build.launch_checked(lib, lib.launch_bitonic_merge, key.data_ptr(), lane.data_ptr(),
                         n, int(k), int(j), torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["bitonic_merge"] += 1


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _stage(key, lane, k, j):
    """One network stage in place: pairs (i, i + j) with bit j of i clear,
    ascending where bit k of i is clear; a pair swaps only when its keys
    are strictly out of order (sortnet.py:88)."""
    n = key.shape[0]
    kv, lv = key.view(-1, 2, j), lane.view(-1, 2, j)
    lo = torch.arange(n, device=key.device).view(-1, 2, j)[:, 0]
    asc = (lo & k) == 0
    a, b = kv[:, 0], kv[:, 1]
    swap = torch.where(asc, b < a, b > a)
    a_new, b_new = torch.where(swap, b, a), torch.where(swap, a, b)
    la, lb = lv[:, 0], lv[:, 1]
    la_new, lb_new = torch.where(swap, lb, la), torch.where(swap, la, lb)
    kv[:, 0], kv[:, 1] = a_new, b_new
    lv[:, 0], lv[:, 1] = la_new, lb_new


def bitonic_local_plain(key, lane, k_lo, k_hi):
    """Plain version of :func:`bitonic_local` (any device)."""
    k = k_lo
    while k <= k_hi:
        j = min(k, BLK) // 2
        while j >= 1:
            _stage(key, lane, k, j)
            j //= 2
        k *= 2


def bitonic_merge_plain(key, lane, k, j):
    """Plain version of :func:`bitonic_merge` (any device)."""
    _stage(key, lane, k, j)
