"""Hash functions for ticketing, bit for bit with ``repro.core.hashing``.

PyTorch on the CPU cannot shift ``uint32`` tensors, and ``>>`` on int32 is
an arithmetic shift (``int32(0x80000000) >> 15 == -65536``).  So every hash
here runs in int64 holding the unsigned 32-bit value: inputs are masked with
``& 0xFFFFFFFF`` before the first shift, and every multiply is split into
two 16-bit halves so that no int64 product overflows, then masked again.

Hash outputs are int64 tensors holding the unsigned value (slots and
partitions fit any index).  Key columns themselves stay int32 bit patterns
with :data:`EMPTY_I32` as the sentinel.
"""
from __future__ import annotations

import math

import torch

# Sentinel of the ticketing machinery (the paper's reserved key and ticket 0).
EMPTY_KEY = 0xFFFFFFFF  # uint32 value
EMPTY_I32 = -1          # int32 bit pattern of EMPTY_KEY

_MASK = 0xFFFFFFFF
_LOW31 = (1 << 31) - 1


def table_capacity(max_groups: int, load_factor: float = 0.5) -> int:
    """Smallest power-of-two probe-table capacity that holds ``max_groups``
    distinct keys at ``load_factor`` occupancy (at least 16 slots).  THE
    capacity rule of every table in the port."""
    if max_groups < 0:
        raise ValueError(f"max_groups must be >= 0, got {max_groups}")
    if not 0.0 < load_factor <= 1.0:
        raise ValueError(f"load_factor must be in (0, 1], got {load_factor}")
    need = max(math.ceil(max_groups / load_factor), 16)
    cap = 16
    while cap < need:
        cap *= 2
    return cap


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor (int32 bit patterns included) → int64 holding its
    unsigned 32-bit value."""
    return x.to(torch.int64) & _MASK


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """Any integer key tensor → its uint32 value as an int32 bit pattern
    (flattened)."""
    x = x.reshape(-1)
    if x.dtype == torch.int32:
        return x
    u = as_u32(x)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``x`` in [0, 2**32) as int64, without an
    int64 product larger than 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def murmur3_fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def murmur3_fmix64(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 64-bit finalizer on int64 tensors holding the uint64 bit
    pattern (the reference's uint64 version needs x64 mode).  ``>> 33`` is
    made logical by masking the arithmetic shift to 31 bits; int64
    multiplication wraps exactly as uint64 multiplication does.  int32 key
    bit patterns are widened as their uint32 values."""
    x = as_u32(x) if x.dtype == torch.int32 else x.to(torch.int64)
    for c in (0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53, None):
        x = x ^ ((x >> 33) & _LOW31)
        if c is not None:
            x = x * (c - (1 << 64))
    return x


def xxhash32_mix(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """xxhash32-style avalanche with a seed."""
    x = (as_u32(x) + ((seed * 0x9E3779B1) & _MASK)) & _MASK
    x = x ^ (x >> 15)
    x = _mul32(x, 0x85EBCA77)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE3D)
    x = x ^ (x >> 16)
    return x


def multiply_shift(x: torch.Tensor, log2_buckets: int, seed: int = 0) -> torch.Tensor:
    """Dietzfelbinger multiply-shift: a bucket index in ``[0,
    2**log2_buckets)`` from one 32-bit multiply and one shift (int64)."""
    a = (0x9E3779B1 + 2 * seed + 1) & _MASK
    return _mul32(as_u32(x), a) >> (32 - log2_buckets)


def slot_hash(keys: torch.Tensor, table_size: int, seed: int = 0) -> torch.Tensor:
    """Initial probe slots of a power-of-two table (int64)."""
    if table_size & (table_size - 1):
        raise ValueError(f"table_size must be a power of 2, got {table_size}")
    return xxhash32_mix(keys, seed=seed) & (table_size - 1)


def slot_hash_i32(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """The fused kernel's slot hash on int32 bit patterns
    (``repro.kernels.ticket_hash._slot_hash_i32``): xxhash32 with seed 0
    masked to ``capacity``, identical to :func:`slot_hash` with seed 0."""
    return slot_hash(keys, capacity)


def partition_hash(keys: torch.Tensor, n_parts: int, seed: int = 0) -> torch.Tensor:
    """Partition keys into ``n_parts`` buckets: :func:`slot_hash`'s mask
    for a power-of-two count, the mixed hash modulo ``n_parts`` otherwise."""
    if n_parts & (n_parts - 1) == 0:
        return slot_hash(keys, n_parts, seed=seed)
    return xxhash32_mix(keys, seed=seed) % n_parts


def fingerprint(keys: torch.Tensor) -> torch.Tensor:
    """16-bit fingerprint for two-level designs."""
    return murmur3_fmix32(keys) >> 16
