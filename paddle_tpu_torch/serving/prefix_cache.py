"""Device-resident prefix cache for generation serving
(paddle_tpu/serving/prefix_cache.py).

A request's raw feed row is hashed (`prefix_row_key`), and hot prefix states
(the boots and per-example rows the prefix ops computed) stay on the device
in a byte-budgeted LRU. A hit admits by copying the cached state into a free
slot, as a fresh prefix's state is copied: no prefix run at all.

Two storage modes:

- fp   - entries hold the prefix's own output rows. A hit admits the same
         values a fresh prefix would: the answer is bit-identical.
- int8 - entries hold per-tensor symmetric int8 payloads and f32 scales
         (absmax/127, round, clip: the quant recipe), dequantized in the
         admit copy. The same budget holds about 4x more f32 prefixes; a
         hit's answer is approximate, with a bounded delta.

The class is host-side bookkeeping only (an OrderedDict of opaque device
payloads and their byte counts); quantizing and dequantizing live in the
scheduler, next to the admit copy. `get()` is on the admission path: a dict
move and two counter bumps.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["PrefixCache", "prefix_row_key"]


def prefix_row_key(model_fingerprint: str, feed: Dict[str, Any],
                   row: int) -> str:
    """Cache identity of ONE request row: sha256 over the model's
    program fingerprint plus every feed's (name, dtype, shape, bytes)
    for that row. Scalar (0-d) feeds hash whole — they are shared
    across rows by construction. Hashing the RAW feed (not the padded
    bucket) means two requests that differ only in their batch
    neighbours still share an entry."""
    h = hashlib.sha256()
    h.update(model_fingerprint.encode())
    for name in sorted(feed):
        v = np.asarray(feed[name])
        r = v if v.ndim == 0 else v[row]
        r = np.ascontiguousarray(r)
        h.update(name.encode())
        h.update(str(r.dtype).encode())
        h.update(str(r.shape).encode())
        h.update(r.tobytes())
    return h.hexdigest()


class PrefixCache:
    """Byte-budgeted LRU of device-resident prefix states.

    Payloads are opaque to the cache (tuples of device arrays, plus
    scales in int8 mode); `nbytes` is accounted by the caller because
    only it knows which leaves are device-resident. An entry larger
    than the whole budget is refused (counted as an overflow, never
    admitted, never evicts the working set for one giant request)."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError(
                f"prefix cache capacity must be positive, got "
                f"{capacity_bytes} bytes")
        self.capacity_bytes = int(capacity_bytes)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.insertions = 0
        self.overflows = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        # membership probe WITHOUT hit/miss accounting or LRU motion
        # (insert-path dedup, not a lookup)
        return key in self._entries

    def get(self, key: str) -> Optional[dict]:
        # HOT PATH (admission): dict move + counters only
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return ent[0]

    def put(self, key: str, payload: dict, nbytes: int) -> int:
        """Insert (or refresh) an entry; returns the number of LRU
        entries evicted to fit it."""
        if nbytes > self.capacity_bytes:
            self.overflows += 1
            return 0
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old[1]
        evicted = 0
        while self._entries and self.bytes + nbytes > self.capacity_bytes:
            _, (_, ev_bytes) = self._entries.popitem(last=False)
            self.bytes -= ev_bytes
            self.evictions += 1
            evicted += 1
        self._entries[key] = (payload, nbytes)
        self.bytes += nbytes
        self.insertions += 1
        return evicted

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, Any]:
        return {
            "entries": len(self._entries),
            "bytes": self.bytes,
            "capacity_bytes": self.capacity_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate(), 4),
            "evictions": self.evictions,
            "insertions": self.insertions,
            "overflows": self.overflows,
        }
