"""Synthetic web-proxy log source — the paper's experimental data (§IV);
a numpy copy of the reference's pipeline/sources.py.

The generator emits raw tab-separated text lines, so ingest workers do
real parsing work (the paper puts its per-client ceiling on client-side
costs). Domain popularity follows a Zipf law, which gives the paper's
Query A/B/C selectivity tiers. Files written with the same seed are
byte-identical to the reference's."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

FIELDS = [
    "src_ip", "dst_ip", "domain", "url_path", "method", "status",
    "user_agent", "content_type", "bytes_out", "bytes_in", "referer", "scheme",
]

_METHODS = ["GET", "POST", "PUT", "HEAD"]
_STATUS = ["200", "304", "404", "500", "302"]
_AGENTS = [f"agent/{i}.0" for i in range(12)]
_CTYPES = ["text/html", "application/json", "image/png", "text/css", "video/mp4"]


@dataclass
class SyntheticWebProxySource:
    n_domains: int = 2000
    zipf_a: float = 1.3
    seed: int = 7

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._domains = np.asarray([f"d{i:05d}.example.com" for i in range(self.n_domains)])
        ranks = np.arange(1, self.n_domains + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_a)
        self._p = p / p.sum()

    def domain_by_popularity(self, quantile: float) -> str:
        """Domain at a popularity quantile: 0.0 = most popular."""
        idx = min(int(quantile * (self.n_domains - 1)), self.n_domains - 1)
        return str(self._domains[idx])

    def gen_lines(self, n: int, t_start: int, t_stop: int) -> List[str]:
        """n raw tab-separated log lines, timestamps uniform in
        [t_start, t_stop]."""
        rng = self._rng
        ts = np.sort(rng.integers(t_start, t_stop + 1, n))
        dom = rng.choice(self._domains, p=self._p, size=n)
        src = rng.integers(0, 1 << 16, n)
        dst = rng.integers(0, 1 << 16, n)
        methods = rng.choice(_METHODS, size=n, p=[0.78, 0.15, 0.02, 0.05])
        status = rng.choice(_STATUS, size=n, p=[0.8, 0.08, 0.07, 0.02, 0.03])
        agents = rng.choice(_AGENTS, size=n)
        ctypes = rng.choice(_CTYPES, size=n)
        b_out = rng.integers(64, 4096, n)
        b_in = rng.integers(128, 1 << 20, n)
        paths = rng.integers(0, 4000, n)
        return [
            "\t".join((
                str(ts[i]),
                f"10.{(src[i] >> 8) & 255}.{src[i] & 255}.{i % 251}",
                f"93.{(dst[i] >> 8) & 255}.{dst[i] & 255}.7",
                str(dom[i]),
                f"/p/{paths[i]}",
                str(methods[i]),
                str(status[i]),
                str(agents[i]),
                str(ctypes[i]),
                str(b_out[i]),
                str(b_in[i]),
                f"https://{dom[i]}/r",
                "https",
            ))
            for i in range(n)
        ]

    def write_files(self, directory: str, n_files: int, lines_per_file: int, t_start: int,
                    t_stop: int) -> List[str]:
        """Stage files on the 'central filesystem' (paper §II): file i holds
        lines_per_file lines over its own slice of [t_start, t_stop]."""
        os.makedirs(directory, exist_ok=True)
        paths = []
        span = (t_stop - t_start) // max(n_files, 1)
        for i in range(n_files):
            p = os.path.join(directory, f"webproxy_{i:05d}.log")
            lo = t_start + i * span
            with open(p, "w") as f:
                f.write("\n".join(self.gen_lines(lines_per_file, lo, lo + span)) + "\n")
            paths.append(p)
        return paths


def parse_web_proxy_line(line: str) -> Tuple[int, Dict[str, str]]:
    """Parse one raw line -> (ts, field values)."""
    parts = line.rstrip("\n").split("\t")
    return int(parts[0]), dict(zip(FIELDS, parts[1:]))


def parse_web_proxy_lines(lines: Sequence[str]) -> Tuple[np.ndarray, Dict[str, List[str]]]:
    """Bulk parse -> (ts array, columnar field values)."""
    ts = np.empty(len(lines), dtype=np.int64)
    cols: Dict[str, List[str]] = {f: [] for f in FIELDS}
    for i, line in enumerate(lines):
        parts = line.rstrip("\n").split("\t")
        ts[i] = int(parts[0])
        for f, v in zip(FIELDS, parts[1:]):
            cols[f].append(v)
    return ts, cols
