"""Read a published snapshot of the port's device plane back as plain
tensors, for the reference to judge: every live entry of every LSM level
(base, run slots, sealed memtable) of the three table families, with the
global tablet each sits in. Levels past their live counts hold stale or
sentinel entries, which are left out. Each level's live keys are also
handed over in their slabs, for the checks of order and combining.
``store_bytes`` counts the bytes the snapshot's levels hold."""
from __future__ import annotations

from typing import Dict, List

import torch


def _live(counts: torch.Tensor, width: int) -> torch.Tensor:
    """Mask of the entries before each slab's live count: counts (T,) or
    (T, K), entries along a last dim of ``width``."""
    return torch.arange(width, device=counts.device) < counts[..., None].to(torch.int64)


def _tablets(shape, t0: int, device) -> torch.Tensor:
    """Global tablet id of every entry of a (T, ...) level."""
    t = torch.arange(shape[0], device=device, dtype=torch.int64) + t0
    return t.view(-1, *([1] * (len(shape) - 1))).expand(shape)


def _slabs(keys: torch.Tensor, live: torch.Tensor):
    """A level's keys as (slabs, width) int64 and each slab's live count."""
    return keys.reshape(-1, keys.shape[-1]).to(torch.int64), live.reshape(-1)


def plane_contents(pub) -> Dict[str, object]:
    """{ev_rows (n, 2 + F) tablet, rev_ts, codes; ix_tab, ix_keys;
    ag_tab, ag_keys, ag_counts; levels} of a published DistStore, a
    sharded plane's composite included (its groups in global tablet
    order). ``levels`` lists (family, combined, keys (slabs, width), live
    (slabs,)) of every level: event rows keyed by rev_ts, index and
    aggregate keys; ``combined`` marks the index and aggregate bases,
    whose keys a fold combined."""
    subs = pub.groups if pub.groups is not None else (pub,)
    ev: List[torch.Tensor] = []
    ix_t: List[torch.Tensor] = []
    ix_k: List[torch.Tensor] = []
    ag_t: List[torch.Tensor] = []
    ag_k: List[torch.Tensor] = []
    ag_c: List[torch.Tensor] = []
    levels: List[tuple] = []
    t0 = 0
    for sub in subs:
        for rev, cols, live in sub.ev_levels():
            levels.append(("ev", False, *_slabs(rev, live)))
            m = _live(live, rev.shape[-1])
            tab = _tablets(rev.shape, t0, rev.device)
            ev.append(torch.cat([tab[m][:, None], rev[m].to(torch.int64)[:, None],
                                 cols[m].to(torch.int64)], dim=1))
        for i, (keys, live) in enumerate(sub.ix_levels()):
            levels.append(("ix", i == 0, *_slabs(keys, live)))
            m = _live(live, keys.shape[-1])
            ix_t.append(_tablets(keys.shape, t0, keys.device)[m])
            ix_k.append(keys[m])
        for i, (keys, vals, live) in enumerate(sub.ag_levels()):
            levels.append(("ag", i == 0, *_slabs(keys, live)))
            m = _live(live, keys.shape[-1])
            ag_t.append(_tablets(keys.shape, t0, keys.device)[m])
            ag_k.append(keys[m])
            ag_c.append(vals[..., 0][m])
        t0 += sub.rev_ts.shape[0]
    return {"ev_rows": torch.cat(ev), "ix_tab": torch.cat(ix_t), "ix_keys": torch.cat(ix_k),
            "ag_tab": torch.cat(ag_t), "ag_keys": torch.cat(ag_k),
            "ag_counts": torch.cat(ag_c), "levels": levels}


def store_bytes(pub) -> int:
    """Bytes held by every level of every family of a published DistStore
    (a sharded plane's composite included): each tensor's whole storage,
    slabs at their allocated size, a storage shared by several levels
    counted once."""
    subs = pub.groups if pub.groups is not None else (pub,)
    seen: Dict[int, int] = {}
    for sub in subs:
        for level in (*sub.ev_levels(), *sub.ix_levels(), *sub.ag_levels()):
            for t in level:
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())
