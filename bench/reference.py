"""The plain reference: what the store must answer, worked out from the
generated events alone (plain PyTorch; it runs on the card or the CPU).

It knows the store's semantics and nothing of the program: the events as
the benchmark made them (timestamps, codes, and the tablet each row was
sent to), the queries as the benchmark drew them (in codes), and the
published key formats of the three tables (paper §II, Fig 1):

    event row    tablet, rev_ts = 2**30 - 1 - ts, the 12 field codes
    index key    field << 52 | code << 30 | rev_ts        (unique per tablet)
    aggregate    field << 52 | code << 30 | ts // bucket  (counts summed)

Each ``*_off`` function compares the program's output with the expected
one and returns how many entries differ: 0 is the only passing reading.
Predicates are tuples: ("eq", field, code), ("in", field, codes),
("and", p, q, ...), ("or", p, q, ...), ("true",).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

TS_MAX = (1 << 30) - 1
IX_FIELD_SHIFT = 52
IX_VALUE_SHIFT = 30
TAB_SHIFT = 56  # a tablet id above the 56 bits any key of 12 fields uses
KEY_LIMIT = 1 << TAB_SHIFT


# ------------------------------------------------------------ multisets
def _pack_rows(rows: torch.Tensor) -> torch.Tensor:
    """(n, w) int32/int64 rows -> (n, ceil(w / 2)) int64 words, two 32-bit
    lanes a word: equal rows give equal words."""
    r = rows.to(torch.int64) & 0xFFFFFFFF
    if r.shape[1] % 2:
        r = torch.cat([r, torch.zeros_like(r[:, :1])], dim=1)
    return (r[:, 0::2] << 32) | r[:, 1::2]


def _lexsort(words: torch.Tensor) -> torch.Tensor:
    order = torch.arange(words.shape[0], device=words.device)
    for j in range(words.shape[1] - 1, -1, -1):
        order = order[torch.sort(words[order, j], stable=True).indices]
    return order


def multiset_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    """Size of the symmetric difference of two multisets of rows ((n, w)
    integer tensors): rows the program has that the reference has not,
    plus the reverse, counted with multiplicity."""
    if got.shape[0] == 0 or want.shape[0] == 0:
        return int(got.shape[0] + want.shape[0])
    words = torch.cat([_pack_rows(got), _pack_rows(want)])
    sign = torch.cat([torch.ones(got.shape[0], dtype=torch.int64, device=words.device),
                      -torch.ones(want.shape[0], dtype=torch.int64, device=words.device)])
    order = _lexsort(words)
    _, inv = torch.unique_consecutive(words[order], dim=0, return_inverse=True)
    net = torch.zeros(int(inv.max()) + 1, dtype=torch.int64, device=words.device)
    net.scatter_add_(0, inv, sign[order])
    return int(net.abs().sum())


def keyed_sum_diff(got_keys: torch.Tensor, got_vals: torch.Tensor, want_keys: torch.Tensor,
                   want_vals: torch.Tensor) -> int:
    """Keys whose summed values differ between the two sides, plus keys
    present on one side only."""
    keys = torch.cat([got_keys, want_keys])
    if keys.numel() == 0:
        return 0
    uniq, inv = torch.unique(keys, return_inverse=True)
    net = torch.zeros(uniq.shape[0], dtype=torch.int64, device=keys.device)
    net.scatter_add_(0, inv, torch.cat([got_vals.to(torch.int64), -want_vals.to(torch.int64)]))
    n_got = got_keys.shape[0]
    on_got = torch.zeros(uniq.shape[0], dtype=torch.bool, device=keys.device)
    on_got[inv[:n_got]] = True
    on_want = torch.zeros(uniq.shape[0], dtype=torch.bool, device=keys.device)
    on_want[inv[n_got:]] = True
    return int(((net != 0) | (on_got != on_want)).sum())


# ----------------------------------------------------------- the tables
class StoreReference:
    """The three tables' contents for events ``ts`` (n,) int64, ``cols``
    (n, F) int32 and their tablets ``tab`` (n,), on ``device``; every
    field indexed, aggregate buckets of ``bucket_s`` seconds."""

    def __init__(self, ts: np.ndarray, cols: np.ndarray, tab: np.ndarray, bucket_s: int,
                 device: torch.device):
        self.device = device
        self.ts = torch.from_numpy(np.ascontiguousarray(ts, np.int64)).to(device)
        self.cols = torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(device)
        self.tab = torch.from_numpy(np.ascontiguousarray(tab, np.int64)).to(device)
        self.bucket_s = int(bucket_s)

    def event_rows(self) -> torch.Tensor:
        """(n, 2 + F) int64: tablet, rev_ts, codes."""
        return torch.cat([self.tab[:, None], (TS_MAX - self.ts)[:, None],
                          self.cols.to(torch.int64)], dim=1)

    def _field_keys(self, low: torch.Tensor) -> torch.Tensor:
        """(F * n,) tablet-tagged keys field | code | low, field-major."""
        f = self.cols.shape[1]
        fid = torch.arange(f, device=self.device, dtype=torch.int64)[:, None]
        code = self.cols.T.to(torch.int64)
        keys = (fid << IX_FIELD_SHIFT) | (code << IX_VALUE_SHIFT) | low[None, :]
        return ((self.tab[None, :] << TAB_SHIFT) | keys).reshape(-1)

    def index_keys(self) -> torch.Tensor:
        """Sorted unique tablet-tagged index keys."""
        return torch.unique(self._field_keys(TS_MAX - self.ts))

    def aggregate_counts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sorted unique tablet-tagged aggregate keys and their counts."""
        return torch.unique(self._field_keys(self.ts // self.bucket_s), return_counts=True)


def tag_keys(tab: torch.Tensor, keys: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Keys tagged with their tablet, and how many keys lie outside any
    key the reference could hold (negative, or past 56 bits): those count
    as wrong as they are."""
    bad = (keys < 0) | (keys >= KEY_LIMIT)
    return (tab.to(torch.int64) << TAB_SHIFT) | torch.where(bad, 0, keys), int(bad.sum())


def level_faults(levels) -> Dict[str, int]:
    """The order and combining of a plane's levels, each (family,
    combined, keys (slabs, width) int64, live (slabs,)): every slab's live
    keys are sorted (ties allowed: runs keep repeats until a fold), and a
    combined level holds each key once. Returns {level_order_off: live
    neighbours out of order, combined_repeats_off: live neighbours equal
    in a combined level}."""
    order = repeats = 0
    for _, combined, keys, live in levels:
        if keys.shape[-1] < 2:
            continue
        both = torch.arange(1, keys.shape[-1], device=keys.device) < live[:, None].to(torch.int64)
        step = keys[:, 1:] - keys[:, :-1]
        order += int(((step < 0) & both).sum())
        if combined:
            repeats += int(((step == 0) & both).sum())
    return {"level_order_off": order, "combined_repeats_off": repeats}


def plane_off(ref: StoreReference, ev_rows: torch.Tensor, ix_tab: torch.Tensor,
              ix_keys: torch.Tensor, ag_tab: torch.Tensor, ag_keys: torch.Tensor,
              ag_counts: torch.Tensor, levels) -> Dict[str, int]:
    """A published plane's contents against the reference: ``ev_rows``
    (n, 2 + F) every live event row (tablet, rev_ts, codes) of every
    level; ``ix_*`` every live index key and its tablet (levels may
    repeat a key: the table is their set); ``ag_*`` every live aggregate
    key, its tablet and count (levels may repeat a key: they sum);
    ``levels`` as level_faults takes them. Returns {ev_rows_off,
    ix_keys_off, ag_sums_off, level_order_off, combined_repeats_off}."""
    out = {"ev_rows_off": multiset_diff(ev_rows.to(ref.device), ref.event_rows())}
    tagged, bad = tag_keys(ix_tab.to(ref.device), ix_keys.to(ref.device))
    got = torch.unique(tagged)
    want = ref.index_keys()
    both = torch.isin(got, want).sum()
    out["ix_keys_off"] = int(got.numel() + want.numel() - 2 * both) + bad
    tagged, bad = tag_keys(ag_tab.to(ref.device), ag_keys.to(ref.device))
    wk, wc = ref.aggregate_counts()
    out["ag_sums_off"] = keyed_sum_diff(tagged, ag_counts.to(ref.device), wk, wc) + bad
    out.update(level_faults(levels))
    return out


# -------------------------------------------------------------- queries
class QueryReference:
    """Answers to the analysts' queries over events ``ts`` (sorted), codes
    ``cols`` and tablets ``tab``: counts, the rows a batch returns,
    scan-time aggregates and the planner's densities."""

    def __init__(self, ts: np.ndarray, cols: np.ndarray, tab: np.ndarray,
                 numeric: Dict[int, np.ndarray], radix: Dict[int, int], device: torch.device):
        if len(ts) > 1 and np.any(np.diff(ts) < 0):
            raise ValueError("the reference wants the events sorted by time")
        self.device = device
        self.ts = torch.from_numpy(np.ascontiguousarray(ts, np.int64)).to(device)
        self.cols = torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(device)
        self.tab = torch.from_numpy(np.ascontiguousarray(tab, np.int64)).to(device)
        self.numeric = {f: torch.from_numpy(np.asarray(v, np.int64)).to(device)
                        for f, v in numeric.items()}
        self.radix = dict(radix)

    def mask(self, pred) -> torch.Tensor:
        """Rows that pass a predicate."""
        op = pred[0]
        if op == "true":
            m = torch.ones(self.ts.shape[0], dtype=torch.bool, device=self.device)
        elif op == "eq":
            m = self.cols[:, pred[1]] == int(pred[2])
        elif op == "in":
            codes = torch.as_tensor(np.asarray(pred[2], np.int64), device=self.device)
            m = torch.isin(self.cols[:, pred[1]].to(torch.int64), codes)
        elif op in ("and", "or"):
            parts = [self.mask(p) for p in pred[1:]]
            m = parts[0]
            for p in parts[1:]:
                m = (m & p) if op == "and" else (m | p)
        else:
            raise ValueError(f"unknown predicate {op!r}")
        return m

    def _span(self, lo: int, hi: int) -> Tuple[int, int]:
        """Row range of ts in [lo, hi]."""
        probe = torch.tensor([int(lo), int(hi)], dtype=torch.int64, device=self.device)
        a = torch.searchsorted(self.ts, probe[:1])
        b = torch.searchsorted(self.ts, probe[1:], right=True)
        return int(a), int(b)

    def count(self, pred, lo: int, hi: int) -> int:
        """Rows passing ``pred`` with ts in [lo, hi]."""
        if hi < lo:
            return 0
        a, b = self._span(lo, hi)
        return int(self.mask(pred)[a:b].sum())

    def batch_off(self, pred, lo: int, hi: int, top_k: int, got_ts: np.ndarray,
                  got_cols: np.ndarray) -> int:
        """The rows one batch returned for ts in [lo, hi] — per tablet the
        ``top_k`` newest matching rows, unordered across tablets — against
        the events: returned rows that are no matching event of the
        range, plus the entries by which the returned timestamps differ
        from each tablet's top_k newest matches (ties may pick either
        row, never another timestamp)."""
        a, b = self._span(lo, hi)
        idx = torch.nonzero(self.mask(pred)[a:b]).flatten() + a
        ts, tab = self.ts[idx], self.tab[idx]
        # Newest first within each tablet: sort by ts descending, then by
        # tablet (stable), and keep each tablet's first top_k.
        o = torch.sort(ts, descending=True, stable=True).indices
        o = o[torch.sort(tab[o], stable=True).indices]
        t_sorted = tab[o]
        start = torch.searchsorted(t_sorted, t_sorted)
        keep = (torch.arange(t_sorted.shape[0], device=self.device) - start) < top_k
        want_ts = ts[o][keep]
        got_t = torch.as_tensor(np.asarray(got_ts, np.int64), device=self.device)
        off = multiset_diff(got_t[:, None], want_ts[:, None])
        if got_t.numel():
            g = torch.as_tensor(np.asarray(got_cols, np.int32), device=self.device)
            got_rows = _pack_rows(torch.cat([got_t[:, None], g.to(torch.int64)], dim=1))
            near = torch.isin(ts, got_t)  # only rows at a returned timestamp can match
            ref_rows = _pack_rows(torch.cat([ts[near][:, None],
                                             self.cols[idx[near]].to(torch.int64)], dim=1))
            off += int((~_rows_in(got_rows, ref_rows)).sum())
        return off

    def aggregate(self, pred, group_by: Sequence[int], op: str, value_field: Optional[int],
                  bucket_s: Optional[int], t0: int, t1: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Scan-time aggregation over ts in [t0, t1]: (group ids, values,
        counts) of the groups with a matching row, by group id. A group id
        packs the group fields' codes (mixed radix over each field's
        dictionary size) and the time bucket counted from t0's."""
        a, b = self._span(t0, t1)
        idx = torch.nonzero(self.mask(pred)[a:b]).flatten() + a
        if bucket_s is not None:
            b_lo = int(t0) // bucket_s
            n_buckets = int(t1) // bucket_s - b_lo + 1
        else:
            b_lo, n_buckets = 0, 1
        gid = torch.zeros(idx.shape[0], dtype=torch.int64, device=self.device)
        stride = n_buckets
        for f in reversed(list(group_by)):
            gid += self.cols[idx, f].to(torch.int64) * stride
            stride *= self.radix[f]
        if bucket_s is not None:
            gid += self.ts[idx] // bucket_s - b_lo
        uniq, inv, counts = torch.unique(gid, return_inverse=True, return_counts=True)
        if op == "count":
            values = counts.to(torch.int64)
        else:
            v = self.numeric[value_field][self.cols[idx, value_field].to(torch.int64)]
            values = torch.zeros(uniq.shape[0], dtype=torch.int64, device=self.device)
            if op == "sum":
                values.scatter_add_(0, inv, v)
            else:  # every group has a row: its own values set the extreme
                values.scatter_reduce_(0, inv, v, "amin" if op == "min" else "amax",
                                       include_self=False)
        return uniq.cpu().numpy(), values.cpu().numpy(), counts.to(torch.int64).cpu().numpy()

    def density(self, fid: int, code: Optional[int], t0: int, t1: int, bucket_s: int) -> int:
        """The planner's density: rows with field = code in the whole
        buckets that [t0, t1] touches."""
        if code is None:
            return 0
        lo = (int(t0) // bucket_s) * bucket_s
        hi = (int(t1) // bucket_s + 1) * bucket_s - 1
        return self.count(("eq", fid, code), lo, hi)


def _rows_in(rows: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Which of ``rows`` ((n, w) int64 words) occur among ``pool``."""
    if pool.shape[0] == 0:
        return torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    words = torch.cat([pool, rows])
    _, inv = torch.unique(words, dim=0, return_inverse=True)
    return torch.isin(inv[pool.shape[0]:], inv[: pool.shape[0]])


def aggregate_off(got: Tuple[np.ndarray, np.ndarray, np.ndarray],
                  want: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> int:
    """Groups whose id, value or count differ, plus groups on one side only."""
    g_ids, g_vals, g_cnts = (np.asarray(x, np.int64) for x in got)
    w_ids, w_vals, w_cnts = (np.asarray(x, np.int64) for x in want)
    common, gi, wi = np.intersect1d(g_ids, w_ids, return_indices=True)
    off = len(g_ids) + len(w_ids) - 2 * len(common)
    off += int(np.sum((g_vals[gi] != w_vals[wi]) | (g_cnts[gi] != w_cnts[wi])))
    return off
