"""Mergeable fixed-bucket log2 latency histogram.

A copy of ``handyrl_tpu.telemetry.histogram``; the ``to_dict`` wire
form is the same, so either package merges the other's histograms.

The serving tier's per-request latency accounting (p50/p99/max +
request counts riding metrics.jsonl and the status endpoint), reusable
for any span family: buckets are FIXED powers of two over milliseconds,
so histograms recorded by different processes (or different epochs)
merge by elementwise addition — the same property that lets the
per-process span logs merge skew-free.

Bucket ``i`` covers ``(LO_MS * 2**(i-1), LO_MS * 2**i]`` (bucket 0 is
everything at or below ``LO_MS``); ``percentile`` answers the upper
edge of the bucket where the cumulative count crosses the rank, so a
reported quantile is an upper bound within one power of two of the
true value.  The maximum is tracked exactly.  Admission-control
decisions that need exact quantiles should keep a small sliding window
of raw samples (the serving frontend does); the histogram is the
unbounded-horizon, mergeable record.

Stdlib only: this is control-plane bookkeeping.
"""

import math
from typing import Dict, List, Optional


class LatencyHistogram:
    """Fixed log2 buckets over milliseconds; cheap observe, exact max,
    elementwise merge."""

    LO_MS = 1e-3       # bucket 0 upper edge: one microsecond
    BUCKETS = 48       # top edge ~ LO_MS * 2**47 ms ≈ 1.6 days

    __slots__ = ("counts", "count", "max_ms", "sum_ms")

    def __init__(self, counts: Optional[List[int]] = None,
                 max_ms: float = 0.0, sum_ms: float = 0.0):
        if counts is None:
            counts = [0] * self.BUCKETS
        elif len(counts) != self.BUCKETS:
            raise ValueError(
                f"expected {self.BUCKETS} buckets, got {len(counts)}")
        self.counts = list(counts)
        self.count = sum(self.counts)
        self.max_ms = float(max_ms)
        self.sum_ms = float(sum_ms)

    @classmethod
    def bucket_index(cls, ms: float) -> int:
        if ms <= cls.LO_MS:
            return 0
        return min(cls.BUCKETS - 1,
                   1 + int(math.floor(math.log2(ms / cls.LO_MS))))

    def observe(self, ms: float):
        ms = max(0.0, float(ms))
        self.counts[self.bucket_index(ms)] += 1
        self.count += 1
        self.sum_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms

    def percentile(self, q: float) -> float:
        """Upper bucket edge at quantile ``q`` in [0, 1] (0.0 when
        empty); the top populated bucket answers the exact max."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        top = 0
        for i, n in enumerate(self.counts):
            if n:
                top = i
            seen += n
            if seen >= rank:
                if i == top and seen == self.count:
                    return self.max_ms  # rank lands in the top bucket
                return self.LO_MS * (2.0 ** i) if i else self.LO_MS
        return self.max_ms  # pragma: no cover - rank <= count above

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    @property
    def mean(self) -> float:
        return self.sum_ms / self.count if self.count else 0.0

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold another histogram in (cross-process / cross-epoch
        reduction); buckets are fixed, so this is elementwise add."""
        for i, n in enumerate(other.counts):
            self.counts[i] += n
        self.count += other.count
        self.sum_ms += other.sum_ms
        self.max_ms = max(self.max_ms, other.max_ms)
        return self

    # -- wire format (cross-process merge like the span logs) ---------
    def to_dict(self) -> Dict:
        """Sparse, JSON-able form: only populated buckets ship."""
        return {
            "buckets": {str(i): n for i, n in enumerate(self.counts)
                        if n},
            "max_ms": round(self.max_ms, 6),
            "sum_ms": round(self.sum_ms, 6),
        }

    @classmethod
    def from_dict(cls, raw: Dict) -> "LatencyHistogram":
        counts = [0] * cls.BUCKETS
        for key, n in (raw.get("buckets") or {}).items():
            counts[int(key)] = int(n)
        return cls(counts, max_ms=float(raw.get("max_ms", 0.0)),
                   sum_ms=float(raw.get("sum_ms", 0.0)))

    def summary(self, prefix: str = "") -> Dict[str, float]:
        """The metrics-record reduction: count + p50/p99/max ms."""
        return {
            f"{prefix}count": self.count,
            f"{prefix}p50_ms": round(self.p50, 3),
            f"{prefix}p99_ms": round(self.p99, 3),
            f"{prefix}max_ms": round(self.max_ms, 3),
        }
