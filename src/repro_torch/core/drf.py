"""Dominant Resource Fairness (Ghodsi et al.) — Mesos' default allocator.

The broker offers resources to the framework with the *lowest dominant
share*; dominant share = max over resource dimensions of
(framework's allocation / cluster total).  The paper relies on Mesos/DRF for
multi-framework fairness; we reproduce it so multi-tenant experiments
(benchmarks/cosched_utilization.py) carry the same semantics.

The allocator is generic over the resource vector: any type supporting
``+``/``-``, ``nonneg()`` and ``dominant_share(total)`` works.  The
cluster scheduler accounts in ``ResourceSpec`` (chips, HBM); the serving
front-end reuses the same allocator with its own (slots, KV) vector
(``runtime/scheduler.ServeResource``) for per-tenant admission fairness.

Weighted DRF (Ghodsi et al. §4.2): each framework carries a weight and
the offer order is by *weighted* dominant share — ``dominant_share /
weight`` — so a weight-3 framework converges to 3x the share of a
weight-1 one.  Serving maps SLO tiers onto these weights
(``ServeConfig.tenant_weights``); unweighted callers see identical
behavior (all weights default to 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .resources import ResourceSpec


@dataclass
class FrameworkAccount:
    name: str
    allocated: ResourceSpec = field(default_factory=ResourceSpec)


class DRFAllocator:
    def __init__(self, total, zero=None, weights=None):
        self.total = total
        self._zero = zero if zero is not None else type(total)()
        self.weights: dict[str, float] = dict(weights or {})
        self.accounts: dict[str, FrameworkAccount] = {}

    def register(self, name: str) -> None:
        self.accounts.setdefault(name, FrameworkAccount(name, self._zero))

    def weight(self, name: str) -> float:
        w = float(self.weights.get(name, 1.0))
        assert w > 0, f"non-positive DRF weight for {name}: {w}"
        return w

    def dominant_share(self, name: str) -> float:
        return self.accounts[name].allocated.dominant_share(self.total)

    def weighted_share(self, name: str) -> float:
        """Dominant share normalized by the framework's weight — the
        quantity weighted DRF equalizes at convergence."""
        return self.dominant_share(name) / self.weight(name)

    def weighted_share_if(self, name: str, extra) -> float:
        """Weighted share ``name`` would have after an extra charge —
        what an admission/preemption decision compares before committing."""
        self.register(name)
        alloc = self.accounts[name].allocated + extra
        return alloc.dominant_share(self.total) / self.weight(name)

    def next_framework(self, candidates=None) -> str | None:
        """Framework with the lowest weighted dominant share (Mesos offer
        order; plain DRF when no weights are set)."""
        names = [n for n in (candidates if candidates is not None
                             else self.accounts) if n in self.accounts]
        if not names:
            return None
        return min(names, key=lambda n: (self.weighted_share(n), n))

    def charge(self, name: str, res: ResourceSpec) -> None:
        self.register(name)
        self.accounts[name].allocated = self.accounts[name].allocated + res

    def credit(self, name: str, res: ResourceSpec) -> None:
        acct = self.accounts[name]
        acct.allocated = acct.allocated - res
        assert acct.allocated.nonneg(), f"negative allocation for {name}"

    def shares(self) -> dict[str, float]:
        """Dominant-share snapshot per framework (fairness telemetry)."""
        return {n: self.dominant_share(n) for n in self.accounts}

    def weighted_shares(self) -> dict[str, float]:
        """Weighted-share snapshot — equal values mean weighted-DRF
        convergence (each framework at its entitlement)."""
        return {n: self.weighted_share(n) for n in self.accounts}

    def set_total(self, total: ResourceSpec) -> None:
        self.total = total
