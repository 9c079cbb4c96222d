"""Event -> token bridge: renders stored events as token sequences for the
analytics LM ("next-event prediction"); a copy of the reference's
pipeline/tokenizer.py.

Token layout per event (fixed width, field-tagged):
    [BOS_EVENT] [TIME_BUCKET tok] [field0 tok] [field1 tok] ...
Field tokens are offset-partitioned per field so one vocab covers all
dictionaries: tok(field f, code c) = base_f + (c % field_span).

Batches come out of the sharded store through time-range scans, so the LM
consumes exactly what ingest produced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..core import keypack
from ..core.scan import scan_events
from ..core.store import EventStore


@dataclass
class EventTokenizer:
    store: EventStore
    vocab_size: int
    time_buckets: int = 256

    def __post_init__(self):
        n_fields = self.store.schema.n_fields
        reserved = 2 + self.time_buckets  # BOS, PAD, time tokens
        span = (self.vocab_size - reserved) // n_fields
        if span < 16:
            raise ValueError("vocab too small for field spans")
        self.bos = 0
        self.pad = 1
        self.time_base = 2
        self.field_span = span
        self.field_base = [reserved + i * span for i in range(n_fields)]
        self.tokens_per_event = 2 + n_fields  # BOS + time + fields

    def encode_block(self, ts: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """(n,), (n, F) -> (n, tokens_per_event) int32."""
        n, f = cols.shape
        out = np.empty((n, self.tokens_per_event), dtype=np.int32)
        out[:, 0] = self.bos
        tb = (ts * self.time_buckets // max(int(keypack.TS_MAX), 1)) % self.time_buckets
        out[:, 1] = self.time_base + tb
        for j in range(f):
            out[:, 2 + j] = self.field_base[j] + (cols[:, j] % self.field_span)
        return out

    def sequences(self, t_start: int, t_stop: int, seq_len: int, batch: int,
                  seed: int = 0) -> Iterator[np.ndarray]:
        """Yield (batch, seq_len) int32 token batches from a store time
        range, tiling events into fixed-length sequences. ``seed`` is kept
        for the reference's signature; the tiling draws nothing."""
        buf = np.empty((0,), dtype=np.int32)
        need = batch * seq_len
        while True:
            for blk in scan_events(self.store, t_start, t_stop):
                toks = self.encode_block(blk.ts(), blk.cols).reshape(-1)
                buf = np.concatenate([buf, toks])
                while buf.size >= need:
                    chunk, buf = buf[:need], buf[need:]
                    yield chunk.reshape(batch, seq_len)
            if buf.size == 0:
                # No events in range at all: padding batches rather than
                # spinning.
                yield np.full((batch, seq_len), self.pad, dtype=np.int32)
