"""The bitonic co-sort: CUDA kernels and their plain PyTorch versions.

The hand-written kernels in ``csrc/bitonic.cu`` together replace
``pbrt_tpu/ops/sortnet.py::_local_kernel`` (K5), the XLA passes between
its calls (``_global_pass``) and the payload columns the reference moves
through every stage.  Lanes travel as one int64 word each, the uint32
key in the high half (compared alone, unsigned) and the lane index in the
low half:

* :func:`bitonic_tile` runs, per 8192-lane tile, every stage of merge
  sizes ``k_lo .. k_hi`` whose exchange distance is below the tile (the
  first launch reads the int64 keys and pads, the last writes the sorted
  keys and the permutation);
* :func:`bitonic_merge` runs the stages ``j = 2^(b+g-1) .. 2^b`` (at
  most five, all >= 8192) of one merge size;
* :func:`gather_rows` writes every payload operand by the permutation in
  one launch;
* :func:`bitonic_co_sort` runs a whole sort -- the launches of
  :func:`schedule`, then the gather -- in ONE call into the library.

A wrapper runs its plain version, the same stages as reshaped tensor
butterflies grouped as the launches group them, only because its tensors
lie on the CPU; on CUDA tensors it launches its kernel or raises.  Both
apply the reference's exact take rule (a pair swaps only when its keys
are strictly out of order), and the permutation depends only on the
sequence of stages, so it is the reference's bit for bit.  ``LAUNCHES``
counts kernel launches, ``HOST_CALLS`` calls into the library.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pbrt_tpu_torch.kernels import build

TILE_LOG2 = 13
TILE = 1 << TILE_LOG2  # lanes per tile kernel CTA (64 KB of shared memory)
MERGE_MAX_LOG2 = 5  # stages per merge launch: groups of up to 32 lanes
MAX_GATHER = 24  # payload operands per gather launch
KEY_PAD = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF
# csrc/bitonic.cu is compiled with these values (build.flags)
NVCC_DEFINES = {"TILE_LOG2": TILE_LOG2, "MERGE_MAX_LOG2": MERGE_MAX_LOG2,
                "MAX_GATHER": MAX_GATHER, "KEY_PAD": f"{KEY_PAD:#x}u"}
STEP_KINDS = ("tile", "merge")  # a schedule step's code in the C step table

LAUNCHES = {"bitonic_tile": 0, "bitonic_merge": 0, "gather_rows": 0}
HOST_CALLS = {"launch_co_sort": 0, "launch_bitonic_tile": 0, "launch_bitonic_merge": 0,
              "launch_gather_rows": 0}

_lib = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, HOST_CALLS):
        for k in counts:
            counts[k] = 0


def load_library():
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    if _lib is None:
        lib = build.load("bitonic")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.launch_bitonic_tile.argtypes = [p, ll, p, p, p, ll, ll, ll, p]
        lib.launch_bitonic_merge.argtypes = [p, ll, ll, ll, ll, p]
        lib.launch_gather_rows.argtypes = [p, ll, p, p, p, i, p]
        lib.launch_co_sort.argtypes = [p, ll, ll, p, i, p, p, p, p, p, p, i, p, p]
        for fn in (lib.launch_bitonic_tile, lib.launch_bitonic_merge,
                   lib.launch_gather_rows, lib.launch_co_sort):
            fn.restype = i
        _lib = lib
    return _lib


def padded_size(n: int) -> int:
    """Lanes the network sorts for n keys: the next power of two, at
    least one tile."""
    return max(TILE, 1 << max(n - 1, 0).bit_length())


def schedule(n_pad: int):
    """The network launches of a sort of ``n_pad`` lanes, in order:
    ("tile", k_lo, k_hi) and ("merge", k, b, g).  Every stage k = 2 ..
    n_pad, j = k/2 .. 1 appears once, in the reference's order."""
    steps = [("tile", 2, min(TILE, n_pad))]
    k = 2 * TILE
    while k <= n_pad:
        hi = k.bit_length() - 1  # the stages j = 2^(hi-1) .. 2^TILE_LOG2, top first
        while hi > TILE_LOG2:
            g = min(MERGE_MAX_LOG2, hi - TILE_LOG2)
            steps.append(("merge", k, hi - g, g))
            hi -= g
        steps.append(("tile", k, k))
        k *= 2
    return steps


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_packed(name, packed):
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    build.check_tensor("packed", packed, torch.int64, dev, 1)
    n_pad = packed.shape[0]
    if n_pad < TILE or n_pad & (n_pad - 1) or n_pad > 1 << 31:
        raise ValueError(f"{name}: expected a power-of-two length in [{TILE}, 2^31], "
                         f"got {n_pad}")
    return dev, n_pad


def _gather_table(n, srcs, dsts, dev):
    """ctypes arrays (src, dst, row bytes) for the gather kernel."""
    if len(srcs) != len(dsts) or len(srcs) > MAX_GATHER:
        raise ValueError(f"gather: expected at most {MAX_GATHER} (src, dst) pairs")
    row_bytes = []
    for x, y in zip(srcs, dsts):
        if not (x.device == y.device == dev and x.is_contiguous() and y.is_contiguous()):
            raise ValueError(f"gather: operands must be contiguous tensors on {dev}")
        if x.dtype != y.dtype or x.shape != y.shape or x.shape[0] != n:
            raise ValueError(f"gather: src {tuple(x.shape)} {x.dtype} and dst "
                             f"{tuple(y.shape)} {y.dtype} must match, {n} rows")
        rb = x.element_size() * math.prod(x.shape[1:])
        if rb == 0 or rb % 4:
            raise ValueError(f"gather: rows of {rb} bytes; need a positive multiple of 4")
        row_bytes.append(rb)
    k = len(srcs)
    return ((ctypes.c_void_p * k)(*[x.data_ptr() for x in srcs]),
            (ctypes.c_void_p * k)(*[y.data_ptr() for y in dsts]),
            (ctypes.c_longlong * k)(*row_bytes), k)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def bitonic_tile(packed, k_lo, k_hi, keys=None, out=None):
    """One tile launch on ``packed`` [N] int64 (N a power of two >= 8192):
    the stages of merge sizes k = k_lo, 2 k_lo, .., k_hi with j =
    min(k, 8192)/2 .. 1.  ``keys`` [n] int64 (uint32 values): read lanes
    from them instead (lane = index, pad lanes keyed 0xFFFFFFFF); ``out``
    = (keys_out, perm_out) [n] int64: write the sorted keys and lane
    permutation there instead of back into ``packed``."""
    if packed.device.type == "cpu":
        return bitonic_tile_plain(packed, k_lo, k_hi, keys, out)
    dev, n_pad = _check_packed("bitonic_tile", packed)
    n = n_pad
    if keys is not None:
        build.check_tensor("keys", keys, torch.int64, dev, 1)
        n = keys.shape[0]
    if out is not None:
        for name, x in zip(("keys_out", "perm_out"), out):
            build.check_tensor(name, x, torch.int64, dev, 1)
        m = out[0].shape[0]
        if out[1].shape[0] != m or (keys is not None and m != n):
            raise ValueError("bitonic_tile: keys, keys_out and perm_out lengths differ")
        n = m
    if n > n_pad:
        raise ValueError(f"bitonic_tile: {n} keys exceed {n_pad} lanes")
    lib = load_library()
    HOST_CALLS["launch_bitonic_tile"] += 1
    build.launch_checked(
        lib, lib.launch_bitonic_tile, None if keys is None else keys.data_ptr(), n,
        packed.data_ptr(), None if out is None else out[0].data_ptr(),
        None if out is None else out[1].data_ptr(), n_pad, int(k_lo), int(k_hi), _stream(dev))
    LAUNCHES["bitonic_tile"] += 1


def bitonic_merge(packed, k, b, g):
    """One merge launch, in place: the stages j = 2^(b+g-1) .. 2^b of
    merge size k (b >= 13, 1 <= g <= 5, 2^(b+g) <= k)."""
    if packed.device.type == "cpu":
        return bitonic_merge_plain(packed, k, b, g)
    dev, n_pad = _check_packed("bitonic_merge", packed)
    if not (b >= TILE_LOG2 and 1 <= g <= MERGE_MAX_LOG2 and 1 << (b + g) <= k <= n_pad):
        raise ValueError(f"bitonic_merge: bad stages b={b} g={g} for k={k}, N={n_pad}")
    lib = load_library()
    HOST_CALLS["launch_bitonic_merge"] += 1
    build.launch_checked(lib, lib.launch_bitonic_merge, packed.data_ptr(), n_pad, int(k),
                         int(b), int(g), _stream(dev))
    LAUNCHES["bitonic_merge"] += 1


def gather_rows(perm, srcs, dsts):
    """One launch: ``dsts[c][i] = srcs[c][perm[i]]`` for every operand
    (contiguous, leading dim n = len(perm), rows a multiple of 4 bytes);
    a lane ``perm[i] >= n`` (a pad lane) gives a zero row."""
    if perm.device.type == "cpu":
        return gather_rows_plain(perm, srcs, dsts)
    dev = perm.device
    if dev.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {dev}")
    build.check_tensor("perm", perm, torch.int64, dev, 1)
    n = perm.shape[0]
    src_arr, dst_arr, rb_arr, k = _gather_table(n, srcs, dsts, dev)
    lib = load_library()
    HOST_CALLS["launch_gather_rows"] += 1
    build.launch_checked(lib, lib.launch_gather_rows, perm.data_ptr(), n, src_arr, dst_arr,
                         rb_arr, k, _stream(dev))
    LAUNCHES["gather_rows"] += k > 0


def _refuse_grad(payloads):
    """Raise where grad mode is on and a payload requires grad: the card's
    outputs are written through raw pointers and carry no autograd graph,
    so gradients would silently stop at the sort."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in payloads):
        raise RuntimeError(
            "the bitonic co_sort is not differentiable (nor is the reference's): a "
            "payload requires grad; take gradients with sort='stable'"
        )


def bitonic_co_sort(keys, payloads):
    """The whole co-sort: keys [n] int64 (uint32 values), payloads with
    leading dim n (f32, f64 under the double policy, i32, i64; rows a
    multiple of 4 bytes, each moved bit for bit).  Returns
    (sorted keys [n], lane permutation [n] int64, gathered payloads).  On
    the card: one call into the library, which makes the launches of
    ``schedule(padded_size(n))``, handed to it as a step table, and one
    gather launch.  Not differentiable, on any device: with grad mode on,
    a payload that requires grad raises (the reference's network cannot
    be differentiated either)."""
    _refuse_grad(payloads)
    if keys.device.type == "cpu":
        return bitonic_co_sort_plain(keys, payloads)
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"bitonic_co_sort: unsupported device {dev}")
    build.check_tensor("keys", keys, torch.int64, dev, 1)
    n = keys.shape[0]
    n_pad = padded_size(n)
    if n < 1 or n_pad > 1 << 31:
        raise ValueError(f"bitonic_co_sort: {n} keys; need 1 .. 2^31")
    srcs = [x.contiguous() for x in payloads]
    dsts = [torch.empty_like(x) for x in srcs]
    src_arr, dst_arr, rb_arr, k = _gather_table(n, srcs, dsts, dev)
    keys_out = torch.empty(n, dtype=torch.int64, device=dev)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    scratch = torch.empty(n_pad, dtype=torch.int64, device=dev)
    # the schedule as rows (0 = tile, k_lo, k_hi, 0) and (1 = merge, k, b, g)
    steps = [(STEP_KINDS.index(kind), *args, 0)[:4] for kind, *args in schedule(n_pad)]
    step_arr = (ctypes.c_longlong * (4 * len(steps)))(*[v for st in steps for v in st])
    launches = (ctypes.c_int * 3)()
    lib = load_library()
    HOST_CALLS["launch_co_sort"] += 1
    try:
        build.launch_checked(lib, lib.launch_co_sort, keys.data_ptr(), n, n_pad, step_arr,
                             len(steps), keys_out.data_ptr(), perm.data_ptr(),
                             scratch.data_ptr(), src_arr, dst_arr, rb_arr, k, launches,
                             _stream(dev))
    finally:
        for name, c in zip(LAUNCHES, launches):
            LAUNCHES[name] += c
    return keys_out, perm, tuple(dsts)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _pack(keys, n_pad):
    """int64 keys [n] (uint32 values) -> packed [n_pad] int64 words
    (key << 32 | lane), pad lanes keyed 0xFFFFFFFF."""
    key = torch.full((n_pad,), KEY_PAD, dtype=torch.int64, device=keys.device)
    key[: keys.shape[0]] = keys & MASK32
    hi = torch.where(key >= 1 << 31, key - (1 << 32), key)  # as int32: no overflow
    return (hi << 32) | torch.arange(n_pad, dtype=torch.int64, device=keys.device)


def _key(packed):
    return (packed >> 32) & MASK32


def _stage(packed, k, j):
    """One network stage in place: pairs (i, i + j) with bit j of i clear,
    ascending where bit k of i is clear; a pair swaps only when its keys
    are strictly out of order (sortnet.py:88)."""
    n = packed.shape[0]
    v = packed.view(-1, 2, j)
    lo = torch.arange(n, device=packed.device).view(-1, 2, j)[:, 0]
    a, b = v[:, 0], v[:, 1]
    ka, kb = _key(a), _key(b)
    swap = torch.where((lo & k) == 0, kb < ka, kb > ka)
    v[:, 0], v[:, 1] = torch.where(swap, b, a), torch.where(swap, a, b)


def bitonic_tile_plain(packed, k_lo, k_hi, keys=None, out=None):
    """Plain version of :func:`bitonic_tile` (any device).  With ``out``
    the result is written there; ``packed`` then holds it too, where the
    kernel leaves it as it was."""
    if keys is not None:
        packed.copy_(_pack(keys, packed.shape[0]))
    k = k_lo
    while k <= k_hi:
        j = min(k, TILE) // 2
        while j >= 1:
            _stage(packed, k, j)
            j //= 2
        k *= 2
    if out is not None:
        n = out[0].shape[0]
        out[0].copy_(_key(packed[:n]))
        out[1].copy_(packed[:n] & MASK32)


def bitonic_merge_plain(packed, k, b, g):
    """Plain version of :func:`bitonic_merge` (any device)."""
    for s in reversed(range(b, b + g)):
        _stage(packed, k, 1 << s)


def gather_rows_plain(perm, srcs, dsts):
    """Plain version of :func:`gather_rows` (any device)."""
    n = perm.shape[0]
    idx = perm.clamp(max=n)  # pad lanes read the zero row appended below
    for x, y in zip(srcs, dsts):
        y.copy_(torch.cat([x, x.new_zeros((1,) + x.shape[1:])])[idx])


def bitonic_co_sort_plain(keys, payloads):
    """Plain version of :func:`bitonic_co_sort` (any device): the same
    launches, one after the other."""
    n = keys.shape[0]
    n_pad = padded_size(n)
    packed = torch.empty(n_pad, dtype=torch.int64, device=keys.device)
    keys_out = torch.empty(n, dtype=torch.int64, device=keys.device)
    perm = torch.empty(n, dtype=torch.int64, device=keys.device)
    steps = schedule(n_pad)
    for i, (kind, *args) in enumerate(steps):
        if kind == "merge":
            bitonic_merge_plain(packed, *args)
        else:
            bitonic_tile_plain(packed, *args, keys=keys if i == 0 else None,
                               out=(keys_out, perm) if i == len(steps) - 1 else None)
    dsts = [torch.empty_like(x) for x in payloads]
    gather_rows_plain(perm, payloads, dsts)
    return keys_out, perm, tuple(dsts)
