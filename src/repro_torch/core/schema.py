"""Event schema and per-field string dictionaries; a copy of the
reference's core/schema.py, cut to what this package calls."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import keypack


class FieldDictionary:
    """Bidirectional str <-> int32 code map for one field. Thread-safe."""

    def __init__(self, name: str):
        self.name = name
        self._fwd: Dict[str, int] = {}
        self._rev: List[str] = []
        self._lock = threading.Lock()

    def encode(self, value: str) -> int:
        code = self._fwd.get(value)
        if code is not None:
            return code
        with self._lock:
            code = self._fwd.get(value)
            if code is None:
                code = len(self._rev)
                if code >= keypack.MAX_VALUES:
                    raise ValueError(
                        f"field {self.name!r}: dictionary overflow "
                        f"(> {keypack.MAX_VALUES} distinct values)"
                    )
                self._fwd[value] = code
                self._rev.append(value)
            return code

    def encode_many(self, values: Sequence[str]) -> np.ndarray:
        return np.fromiter(
            (self.encode(v) for v in values), dtype=np.int32, count=len(values)
        )

    def lookup(self, value: str) -> Optional[int]:
        """Code for a value if it was ever ingested, else None."""
        return self._fwd.get(value)

    def decode(self, code: int) -> str:
        return self._rev[int(code)]

    def decode_many(self, codes) -> List[str]:
        return [self._rev[int(c)] for c in codes]

    def prefix_codes(self, prefix: str) -> np.ndarray:
        """All codes whose value starts with ``prefix``, in insertion order:
        the host-side resolution of a Match condition."""
        return np.asarray(
            [c for s, c in self._fwd.items() if s.startswith(prefix)],
            dtype=np.int32,
        )

    def __len__(self):
        return len(self._rev)


@dataclass(frozen=True)
class FieldSpec:
    name: str
    indexed: bool = True


@dataclass
class EventSchema:
    """One data source ('event type' in LLCySA)."""

    source: str
    fields: List[FieldSpec]
    _field_ids: Dict[str, int] = dc_field(default_factory=dict)

    def __post_init__(self):
        if len(self.fields) >= keypack.MAX_FIELDS:
            raise ValueError("too many fields")
        self._field_ids = {f.name: i for i, f in enumerate(self.fields)}

    def field_id(self, name: str) -> int:
        return self._field_ids[name]

    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def is_indexed(self, name: str) -> bool:
        return self.fields[self._field_ids[name]].indexed

    @property
    def n_fields(self) -> int:
        return len(self.fields)


def web_proxy_schema() -> EventSchema:
    """The paper's experimental data source (§IV): web proxy logs."""
    names = [
        "src_ip", "dst_ip", "domain", "url_path", "method", "status",
        "user_agent", "content_type", "bytes_out", "bytes_in", "referer", "scheme",
    ]
    return EventSchema("web_proxy", [FieldSpec(n) for n in names])
