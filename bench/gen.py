"""The benchmark's web-proxy events, made from a seed (NumPy only).

A frozen copy of the distributions of the port's synthetic web-proxy
source (``pipeline/sources.py::SyntheticWebProxySource``, the paper's
§IV data): domains by a Zipf law over 2,000 domains (a = 1.3), the
method and status mixes, 12 agents, 5 content types, bytes out in
[64, 4096), bytes in in [128, 2**20), 4,000 paths, and source addresses
``10.x.y.(i % 251)`` for the event's index i. It emits each field's
dictionary codes straight away, with no text lines and no parsing: a
field's codes are the ranks of its distinct raw keys, and its vocabulary
(the strings, in code order) is built only when asked for.

Also here, frozen: the row hash a port writer routes rows by (the store's
``short_hash`` over the codes, the timestamp, the writer's running row
count and its id), so that the benchmark knows every row's tablet
without asking the program.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

FIELDS = ("src_ip", "dst_ip", "domain", "url_path", "method", "status",
          "user_agent", "content_type", "bytes_out", "bytes_in", "referer", "scheme")
FID = {f: i for i, f in enumerate(FIELDS)}
METHODS = ("GET", "POST", "PUT", "HEAD")
METHOD_P = (0.78, 0.15, 0.02, 0.05)
STATUS = ("200", "304", "404", "500", "302")
STATUS_P = (0.8, 0.08, 0.07, 0.02, 0.03)
AGENTS = tuple(f"agent/{i}.0" for i in range(12))
CTYPES = ("text/html", "application/json", "image/png", "text/css", "video/mp4")
N_DOMAINS = 2000
ZIPF_A = 1.3
SRC_SPACE = 1 << 16
SRC_SUFFIX = 251
DST_SPACE = 1 << 16
PATHS = 4000
BYTES_OUT = (64, 4096)
BYTES_IN = (128, 1 << 20)

TS_MAX = (1 << 30) - 1  # the store's 30-bit timestamps; rev_ts = TS_MAX - ts
VALUE_BITS = 22  # a code takes 22 bits of an index or aggregate key
HASH_MAX = (1 << 16) - 1

# Each field's raw-key space: codes are ranks of the keys present.
KEY_SPACE = {
    "src_ip": SRC_SPACE * SRC_SUFFIX, "dst_ip": DST_SPACE, "domain": N_DOMAINS,
    "url_path": PATHS, "method": len(METHODS), "status": len(STATUS),
    "user_agent": len(AGENTS), "content_type": len(CTYPES), "bytes_out": BYTES_OUT[1],
    "bytes_in": BYTES_IN[1], "referer": N_DOMAINS, "scheme": 1,
}


def domain_p() -> np.ndarray:
    """Popularity of domain index 0..1999 (0 the most popular)."""
    ranks = np.arange(1, N_DOMAINS + 1, dtype=np.float64)
    p = ranks ** (-ZIPF_A)
    return p / p.sum()


def _domain_name(k: int) -> str:
    return f"d{k:05d}.example.com"


def key_string(fname: str, k: int) -> str:
    """The value string of raw key k of a field."""
    if fname == "src_ip":
        s, r = divmod(int(k), SRC_SUFFIX)
        return f"10.{(s >> 8) & 255}.{s & 255}.{r}"
    if fname == "dst_ip":
        return f"93.{(k >> 8) & 255}.{k & 255}.7"
    if fname == "domain":
        return _domain_name(k)
    if fname == "url_path":
        return f"/p/{k}"
    if fname == "method":
        return METHODS[k]
    if fname == "status":
        return STATUS[k]
    if fname == "user_agent":
        return AGENTS[k]
    if fname == "content_type":
        return CTYPES[k]
    if fname in ("bytes_out", "bytes_in"):
        return str(int(k))
    if fname == "referer":
        return f"https://{_domain_name(k)}/r"
    return "https"


def _draw(rng: np.random.Generator, n: int, span_s: int) -> Tuple:
    """The events' timestamps and raw keys, in the source's order of draws."""
    ts = np.sort(rng.integers(0, span_s, n))
    dom = rng.choice(N_DOMAINS, p=domain_p(), size=n)
    src = rng.integers(0, SRC_SPACE, n)
    dst = rng.integers(0, DST_SPACE, n)
    method = rng.choice(len(METHODS), size=n, p=METHOD_P)
    status = rng.choice(len(STATUS), size=n, p=STATUS_P)
    agent = rng.integers(0, len(AGENTS), n)
    ctype = rng.integers(0, len(CTYPES), n)
    b_out = rng.integers(*BYTES_OUT, n)
    b_in = rng.integers(*BYTES_IN, n)
    path = rng.integers(0, PATHS, n)
    suffix = np.arange(n) % SRC_SUFFIX
    keys = {
        "src_ip": src * SRC_SUFFIX + suffix, "dst_ip": dst, "domain": dom, "url_path": path,
        "method": method, "status": status, "user_agent": agent, "content_type": ctype,
        "bytes_out": b_out, "bytes_in": b_in, "referer": dom, "scheme": np.zeros(n, np.int64),
    }
    return ts.astype(np.int64), keys


@dataclass
class Events:
    """Events as the store holds them: ts (n,) int64 in [0, span_s - 1],
    sorted; cols (n, 12) int32 codes. ``keys[f]`` holds field f's distinct
    raw keys in code order."""

    ts: np.ndarray
    cols: np.ndarray
    keys: Dict[str, np.ndarray]
    span_s: int
    _vocab: Dict[str, List[str]] = field(default_factory=dict, repr=False)
    _codes: Dict[str, Dict[str, int]] = field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return len(self.ts)

    def vocab(self, fname: str) -> List[str]:
        """Field fname's value strings in code order."""
        if fname not in self._vocab:
            self._vocab[fname] = [key_string(fname, int(k)) for k in self.keys[fname]]
        return self._vocab[fname]

    def numeric(self, fname: str) -> np.ndarray:
        """int64 numeric value of each code of a bytes field."""
        return self.keys[fname].astype(np.int64)

    def code(self, fname: str, key: int) -> Optional[int]:
        """The code of raw key ``key`` of a field, None when no event has it."""
        ks = self.keys[fname]
        i = int(np.searchsorted(ks, key))
        return i if i < len(ks) and ks[i] == key else None

    def value_code(self, fname: str, value: str) -> Optional[int]:
        """The code of a value string, None when no event has it."""
        if fname not in self._codes:
            self._codes[fname] = {v: c for c, v in enumerate(self.vocab(fname))}
        return self._codes[fname].get(value)


def make_events(seed: int, n: int, span_s: int) -> Events:
    """``n`` events with timestamps uniform in [0, span_s - 1], from ``seed``."""
    rng = np.random.default_rng(int(seed))
    ts, raw_keys = _draw(rng, n, span_s)
    cols = np.empty((n, len(FIELDS)), np.int32)
    keys = {}
    for f in FIELDS:
        raw = raw_keys[f].astype(np.int64)
        present = np.zeros(KEY_SPACE[f], bool)
        present[raw] = True
        rank = np.cumsum(present, dtype=np.int64) - 1
        cols[:, FID[f]] = rank[raw]
        keys[f] = np.flatnonzero(present)
        if len(keys[f]) > 1 << VALUE_BITS:
            raise ValueError(f"{f}: {len(keys[f])} distinct values do not fit "
                             f"{VALUE_BITS}-bit codes; make fewer events")
    return Events(ts, cols, keys, span_s)


def short_hash(*cols) -> np.ndarray:
    """The store's 16-bit FNV-like mixing hash over int arrays."""
    acc = np.uint64(0xCBF29CE484222325)
    for c in cols:
        c = np.asarray(c).astype(np.uint64)
        acc = (acc ^ c) * np.uint64(0x100000001B3)
        acc ^= acc >> np.uint64(29)
    return (acc & np.uint64(HASH_MAX)).astype(np.int64)


@dataclass
class Chunk:
    """One pre-encoded, row-hashed append: rev_ts int32, codes (n, F)
    int32, global tablet ids int64; ``rows`` indexes the events."""

    rts: np.ndarray
    cols: np.ndarray
    tab: np.ndarray
    rows: np.ndarray


def writer_chunks(ev: Events, rows: np.ndarray, n_tablets: int, chunk: int, n_writers: int,
                  writer_base: int = 0) -> List[List[Chunk]]:
    """Events ``rows`` cut into chunks of ``chunk`` rows; writer i takes
    every n_writers-th chunk and routes each row by the hash a port
    writer with id writer_base + i computes (codes, ts, its running row
    count, its id)."""
    out: List[List[Chunk]] = [[] for _ in range(n_writers)]
    count = [0] * n_writers
    for i, off in enumerate(range(0, len(rows), chunk)):
        w = i % n_writers
        r = rows[off: off + chunk]
        t, c = ev.ts[r], ev.cols[r]
        nonce = np.arange(count[w], count[w] + len(r), dtype=np.int64)
        count[w] += len(r)
        h = short_hash(*(c[:, j] for j in range(c.shape[1])), t, nonce,
                       np.int64(writer_base + w))
        out[w].append(Chunk((TS_MAX - t).astype(np.int32), np.ascontiguousarray(c),
                            h % n_tablets, r))
    return out


def radical_inverse(n: int, base: int) -> np.ndarray:
    """The first n terms of van der Corput's sequence in ``base``: term j
    is j's digits mirrored after the point. Every prefix spreads evenly
    over [0, 1)."""
    j = np.arange(n, dtype=np.int64)
    out = np.zeros(n)
    scale = 1.0 / base
    while j.any():
        out += (j % base) * scale
        j //= base
        scale /= base
    return out


def balanced(rng: np.random.Generator, n: int, base: int) -> np.ndarray:
    """n uniforms in [0, 1) whose every prefix is spread evenly: the van
    der Corput sequence in ``base``, shifted by one uniform from the seed
    (a Cranley-Patterson rotation). Every seed draws nearly the same set
    at every length, in another order; coordinates of one draw take
    different prime bases."""
    return (radical_inverse(n, base) + rng.random()) % 1.0


def weighted_sequence(shares, n: int) -> np.ndarray:
    """n picks among len(shares) kinds in proportion to their shares, every
    prefix as near its shares as integers allow (smooth weighted round
    robin)."""
    w = np.asarray(shares, dtype=np.float64)
    cur = np.zeros_like(w)
    out = np.empty(n, np.int64)
    for j in range(n):
        cur += w
        out[j] = i = int(np.argmax(cur))
        cur[i] -= w.sum()
    return out


def domains_by_popularity(u: np.ndarray) -> np.ndarray:
    """Domain indexes drawn by their Zipf popularity at uniforms u."""
    return np.minimum(np.searchsorted(np.cumsum(domain_p()), u, side="right"), N_DOMAINS - 1)


def tiers(ev: Events) -> Dict[str, Tuple[int, int]]:
    """The paper's query tiers by the repo's rule (chip_smoke.py's
    pick_tiers): A the most popular domain, B a moderately popular one
    (at most 15% of A's count and over max(2% of it, 100)), C the least
    popular with at least 30 hits, among the domains at popularity
    quantiles 0..0.5. Returns {tier: (domain key, event count)}, a tier
    left out when no domain meets its rule."""
    counts = np.bincount(ev.cols[:, FID["domain"]], minlength=len(ev.keys["domain"]))
    by_key = {int(k): int(counts[c]) for c, k in enumerate(ev.keys["domain"])}
    cand = {}
    for q in np.linspace(0, 0.5, 100):
        k = min(int(q * (N_DOMAINS - 1)), N_DOMAINS - 1)
        cand[k] = by_key.get(k, 0)
    ranked = sorted(cand.items(), key=lambda kv: (-kv[1], kv[0]))
    top = ranked[0][1]
    out = {"A": ranked[0]}
    b = [kc for kc in ranked if top * 0.02 < kc[1] <= top * 0.15 and kc[1] > 100]
    if b:
        out["B"] = b[0]
    c = [kc for kc in reversed(ranked) if kc[1] >= 30]
    if c:
        out["C"] = c[0]
    return out
