"""Packed fixed-width integer row keys (paper §II, Fig 1); a numpy copy
of the reference's core/keypack.py, cut to what this package calls.

  event key : shard(7b) | rev_ts(30b) | hash(16b)   = 53 bits
  index key : field(10b) | value(22b) | rev_ts(30b) = 62 bits
  agg key   : field(10b) | value(22b) | bucket(30b) = 62 bits

rev_ts = TS_MAX - ts: newest entries sort first.
"""
from __future__ import annotations

import numpy as np

SHARD_BITS = 7
TS_BITS = 30
HASH_BITS = 16
FIELD_BITS = 10
VALUE_BITS = 22
BUCKET_BITS = 30

MAX_SHARDS = 1 << SHARD_BITS
TS_MAX = (1 << TS_BITS) - 1
HASH_MAX = (1 << HASH_BITS) - 1
MAX_FIELDS = 1 << FIELD_BITS
MAX_VALUES = 1 << VALUE_BITS
BUCKET_MAX = (1 << BUCKET_BITS) - 1

_EV_SHARD_SHIFT = TS_BITS + HASH_BITS
_EV_TS_SHIFT = HASH_BITS
IX_FIELD_SHIFT = VALUE_BITS + TS_BITS
IX_VALUE_SHIFT = TS_BITS
AG_FIELD_SHIFT = VALUE_BITS + BUCKET_BITS
AG_VALUE_SHIFT = BUCKET_BITS


def rev_ts(ts):
    """Reversed timestamp: newest-first sort order within a shard."""
    return TS_MAX - ts


def unrev_ts(rts):
    return TS_MAX - rts


def pack_event_key(shard, rts, h):
    shard = np.asarray(shard, dtype=np.int64)
    rts = np.asarray(rts, dtype=np.int64)
    h = np.asarray(h, dtype=np.int64)
    return (shard << _EV_SHARD_SHIFT) | (rts << _EV_TS_SHIFT) | h


def unpack_event_key(key):
    """int64 event keys -> (shard, rev_ts, hash) int64 arrays."""
    key = np.asarray(key, dtype=np.int64)
    shard = key >> _EV_SHARD_SHIFT
    rts = (key >> _EV_TS_SHIFT) & TS_MAX
    h = key & HASH_MAX
    return shard, rts, h


def event_key_range(shard, t_start, t_stop):
    """[lo, hi) of packed event keys for ts in [t_start, t_stop] within
    one shard (reversed timestamps: t_stop is the low end)."""
    lo = pack_event_key(shard, rev_ts(t_stop), 0)
    hi = pack_event_key(shard, rev_ts(t_start), HASH_MAX) + 1
    return lo, hi


def pack_index_key(field, value, rts):
    field = np.asarray(field, dtype=np.int64)
    value = np.asarray(value, dtype=np.int64)
    rts = np.asarray(rts, dtype=np.int64)
    return (field << IX_FIELD_SHIFT) | (value << IX_VALUE_SHIFT) | rts


def unpack_index_key(key):
    key = np.asarray(key, dtype=np.int64)
    field = key >> IX_FIELD_SHIFT
    value = (key >> IX_VALUE_SHIFT) & (MAX_VALUES - 1)
    rts = key & TS_MAX
    return field, value, rts


def index_key_range(field, value, t_start, t_stop):
    """[lo, hi) of packed index keys for one (field, value) over a time
    range."""
    lo = pack_index_key(field, value, rev_ts(t_stop))
    hi = pack_index_key(field, value, rev_ts(t_start)) + 1
    return lo, hi


def pack_agg_key(field, value, bucket):
    field = np.asarray(field, dtype=np.int64)
    value = np.asarray(value, dtype=np.int64)
    bucket = np.asarray(bucket, dtype=np.int64)
    return (field << AG_FIELD_SHIFT) | (value << AG_VALUE_SHIFT) | bucket


def unpack_agg_key(key):
    key = np.asarray(key, dtype=np.int64)
    field = key >> AG_FIELD_SHIFT
    value = (key >> AG_VALUE_SHIFT) & (MAX_VALUES - 1)
    bucket = key & BUCKET_MAX
    return field, value, bucket


def short_hash(*cols):
    """Deterministic 16-bit mixing hash over int arrays (fnv-ish)."""
    acc = np.uint64(0xCBF29CE484222325)
    for c in cols:
        c = np.asarray(c).astype(np.uint64)
        acc = (acc ^ c) * np.uint64(0x100000001B3)
        acc ^= acc >> np.uint64(29)
    return (acc & np.uint64(HASH_MAX)).astype(np.int64)


def assign_shards(n, n_shards, rng):
    """Uniform random shard per entry (the paper's sharding)."""
    return rng.integers(0, n_shards, size=n, dtype=np.int64)
