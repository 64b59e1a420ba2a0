"""QoS priority tiers: low-tier-first shedding on the r9 admission path.

The r9 overload machinery (docs/router.md "Overload protection") sheds
*uniformly*: past ``--max-inflight`` every request gets the same 429.
Under a saturating fleet that is the wrong shape — an interactive chat
request and a batch summarization job are not worth the same slot.
This module grades the existing gates by priority tier so the fleet
degrades *by tier* instead:

- **Tiers** come from ``--qos-tiers`` (``name=admit_fraction,...``,
  highest priority first, e.g. ``tier0=1.0,tier1=0.85,tier2=0.7``).
  A request names its tier in the ``x-priority-class`` header (tier
  name or index); untagged traffic lands in tier 0, so enabling QoS
  never penalizes clients that predate it.
- **Graduated admission.** Tier *k* is admitted only while the
  router's proxied in-flight count is under
  ``admit_fraction[k] × --max-inflight``: as pressure rises the
  background tiers hit their (lower) ceilings first and shed with the
  standard 429 + ``Retry-After`` — low-tier-first, and tier 0 keeps
  the full gate. Sheds are intentional backpressure: counted
  (``tpu:router_qos_sheds_total{tier}``), never breaker signals.
- **Per-tier token buckets** (``--qos-tier-rates name=req_per_s``)
  bound a tier's *rate* outright, pressure or not — the lever for a
  contractual background-tier budget.
- **Per-tenant token buckets inside each tier**
  (``--qos-tenant-rate req_per_s``, ``x-tenant-id`` header): every
  (tier, tenant) pair gets its own lazily created bucket, so a noisy
  tenant's burst sheds against ITS budget — its tier peers' buckets,
  and the tier's shared admission fraction, are untouched
  (noisy-neighbor containment, docs/multitenancy.md). Tenant sheds
  carry reason ``tenant`` and are counted per (tenant, tier) in
  ``tpu:router_tenant_sheds_total``; untagged requests (no tenant
  header) are never tenant-bucketed. The bucket table is a bounded
  LRU (``max_tenants``), so label cardinality and memory stay fixed
  no matter how many tenant ids clients invent.
- **Deadline budgets, low-tier-first.** The downstream deadline the
  router injects when the client sent none (``--request-timeout``)
  scales by the tier's admit fraction, so under queueing the engine
  expires background work first (the r9 ``expire_waiting`` sweep is
  the actual preemption point engine-side).
- **Preemption.** Tiers at or past ``--qos-preempt-from`` register as
  preemptable while their backend dispatch is in flight and no byte
  has reached the client. A tier-0 arrival that would otherwise shed
  at the full gate cancels the newest such victim (it gets a
  structured 503 ``preempted`` + ``Retry-After``) and takes the slot.
  Once a response byte has been relayed a request is never preempted
  — bytes cannot be un-sent.
- **Per-tier SLO classes.** Tiered requests feed the burn-rate engine
  (slo.py) under their tier name as the request class, so
  ``tier0_shed_rate`` (default objective set) pages when the one tier
  that must never shed starts shedding.

Closed loop: the saturation sweep in ``python -m
production_stack_tpu_torch.loadgen multirouter`` holds tier-0 goodput flat
(≥95% of pre-saturation) while tier-2 sheds ≥50%
(``MULTIROUTER_r16.json``).
"""

import collections
import itertools
import time
from typing import Dict, List, Optional, Tuple

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

PRIORITY_HEADER = "x-priority-class"
TENANT_HEADER = "x-tenant-id"

# canonical three-tier spec (docs/router.md "QoS priority tiers")
DEFAULT_TIER_SPEC = "tier0=1.0,tier1=0.85,tier2=0.7"

SHED_REASONS = ("bucket", "pressure", "preempted", "tenant")


class _TokenBucket:
    """Continuous-refill token bucket: ``rate`` admissions/second
    sustained, ``burst`` instantaneous."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 now_fn=time.monotonic):
        self.rate = rate
        self.burst = burst if burst is not None else max(1.0, rate)
        self.tokens = self.burst
        self._now = now_fn
        self._last = now_fn()

    def try_take(self) -> bool:
        now = self._now()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class QosTier:
    __slots__ = ("name", "index", "admit_fraction", "bucket")

    def __init__(self, name: str, index: int, admit_fraction: float,
                 bucket: Optional[_TokenBucket] = None):
        self.name = name
        self.index = index
        self.admit_fraction = admit_fraction
        self.bucket = bucket


class _PreemptSlot:
    """One preemptable in-flight request. The proxy races its backend
    dispatch against ``event``; a preemptor sets it."""

    __slots__ = ("tier", "event", "key")

    def __init__(self, tier: QosTier, event, key: int):
        self.tier = tier
        self.event = event
        self.key = key


def parse_tier_spec(spec: str) -> List[Tuple[str, float]]:
    """``"tier0=1.0,tier1=0.85,tier2=0.7"`` -> ordered (name, frac)
    pairs. Order is priority order (first = highest); fractions must
    be non-increasing in (0, 1] — a background tier admitted deeper
    into the gate than an interactive one is a config error, not a
    policy."""
    pairs: List[Tuple[str, float]] = []
    seen = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"--qos-tiers entry {part!r} is not "
                             f"name=admit_fraction")
        name, _, frac_s = part.partition("=")
        name = name.strip()
        frac = float(frac_s)
        if not name or name in seen:
            raise ValueError(f"--qos-tiers: duplicate/empty tier name "
                             f"{name!r}")
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"--qos-tiers: {name} admit fraction "
                             f"{frac} outside (0, 1]")
        if pairs and frac > pairs[-1][1]:
            raise ValueError(f"--qos-tiers: {name} admits at {frac} > "
                             f"the higher-priority {pairs[-1][0]}'s "
                             f"{pairs[-1][1]} (fractions must be "
                             f"non-increasing)")
        seen.add(name)
        pairs.append((name, frac))
    if not pairs:
        raise ValueError("--qos-tiers parsed to zero tiers")
    return pairs


class QosPolicy:
    """Tier resolution + graduated admission + preemption registry for
    one router process. Event-loop-single-threaded like the rest of
    the router: no locks."""

    def __init__(self, spec: str = DEFAULT_TIER_SPEC,
                 tier_rates: str = "",
                 preempt_from: Optional[int] = None,
                 tenant_rate: float = 0.0,
                 max_tenants: int = 256,
                 now_fn=time.monotonic):
        rates: Dict[str, float] = {}
        for part in (tier_rates or "").split(","):
            part = part.strip()
            if not part:
                continue
            name, _, rate_s = part.partition("=")
            rates[name.strip()] = float(rate_s)
        self.tiers: List[QosTier] = []
        self._by_name: Dict[str, QosTier] = {}
        for idx, (name, frac) in enumerate(parse_tier_spec(spec)):
            rate = rates.pop(name, 0.0)
            bucket = _TokenBucket(rate, now_fn=now_fn) if rate > 0 \
                else None
            tier = QosTier(name, idx, frac, bucket)
            self.tiers.append(tier)
            self._by_name[name.lower()] = tier
        if rates:
            raise ValueError(f"--qos-tier-rates names unknown tiers: "
                             f"{sorted(rates)}")
        # preemptable tiers: index >= preempt_from (default: only the
        # lowest tier; len(tiers) disables preemption entirely)
        self.preempt_from = len(self.tiers) - 1 if preempt_from is None \
            else preempt_from
        # newest-last per tier so a preemptor cancels the request with
        # the least progress to lose
        self._preemptable: List["collections.OrderedDict[int, _PreemptSlot]"] = [
            collections.OrderedDict() for _ in self.tiers]
        self._slot_ids = itertools.count()
        # telemetry (delta-synced into tpu:router_qos_* at scrape)
        self.admitted = [0] * len(self.tiers)
        self.completed = [0] * len(self.tiers)
        self.inflight = [0] * len(self.tiers)
        self.sheds: Dict[Tuple[str, str], int] = collections.defaultdict(int)
        self.preemptions = [0] * len(self.tiers)   # as victim
        # per-tenant buckets nested inside tiers: (tier, tenant) ->
        # bucket, bounded LRU. tenant_sheds keys (tenant, tier) —
        # metrics label order — and is evicted WITH the bucket so the
        # exported label set stays bounded by max_tenants too.
        self.tenant_rate = float(tenant_rate)
        self.max_tenants = max_tenants
        self._now_fn = now_fn
        self._tenant_buckets: \
            "collections.OrderedDict[Tuple[str, str], _TokenBucket]" = \
            collections.OrderedDict()
        self.tenant_sheds: Dict[Tuple[str, str], int] = \
            collections.defaultdict(int)

    # -- tier resolution ------------------------------------------------

    def resolve(self, headers) -> QosTier:
        """``x-priority-class`` by tier name or index; absent/unknown
        lands in tier 0 (the top tier) so untagged traffic — every
        client that predates QoS — is never penalized."""
        raw = headers.get(PRIORITY_HEADER) if headers is not None else None
        if not raw:
            return self.tiers[0]
        key = raw.strip().lower()
        tier = self._by_name.get(key)
        if tier is not None:
            return tier
        try:
            idx = int(key)
        except ValueError:
            return self.tiers[0]
        if 0 <= idx < len(self.tiers):
            return self.tiers[idx]
        return self.tiers[0]

    def resolve_tenant(self, headers) -> Optional[str]:
        """``x-tenant-id`` value, or None when absent or tenant
        bucketing is off — None short-circuits every tenant check, so
        untagged traffic (every client that predates tenancy) pays
        nothing."""
        if self.tenant_rate <= 0 or headers is None:
            return None
        raw = headers.get(TENANT_HEADER)
        return raw.strip() if raw else None

    # -- admission ------------------------------------------------------

    def _tenant_allows(self, tier: QosTier,
                       tenant: Optional[str]) -> bool:
        """One draw on the (tier, tenant) bucket — lazily created at
        the flat per-tenant rate, LRU-bounded. An evicted tenant's
        next request simply re-creates a full bucket: the LRU bound is
        a memory cap, not a policy (an attacker cycling tenant ids is
        the admission fraction's problem, not this table's)."""
        if tenant is None:
            return True
        key = (tier.name, tenant)
        bucket = self._tenant_buckets.get(key)
        if bucket is None:
            bucket = _TokenBucket(self.tenant_rate, now_fn=self._now_fn)
            self._tenant_buckets[key] = bucket
            while len(self._tenant_buckets) > self.max_tenants:
                old_key, _ = self._tenant_buckets.popitem(last=False)
                self.tenant_sheds.pop((old_key[1], old_key[0]), None)
        else:
            self._tenant_buckets.move_to_end(key)
        return bucket.try_take()

    def _shed_tenant(self, tier: QosTier, tenant: str) -> None:
        self.sheds[(tier.name, "tenant")] += 1
        self.tenant_sheds[(tenant, tier.name)] += 1

    def admit(self, tier: QosTier, inflight: int, max_inflight: int,
              tenant: Optional[str] = None
              ) -> Tuple[str, Optional[_PreemptSlot]]:
        """One admission decision. Returns ``(verdict, victim)``:
        ``("admit", None)`` / ``("admit", slot)`` (slot preempted to
        make room — caller delivers the victim its 503) /
        ``("shed", None)`` (reason already counted).

        The pressure gate runs BEFORE the token bucket: a request that
        is going to be pressure-shed anyway must not drain the tier's
        contractual rate budget, or sustained pressure double-charges
        the bucket and starves the tier after the pressure clears.
        The TENANT bucket is drawn before the tier bucket for the same
        reason in the other direction: a tenant-shed request must not
        drain the tier's shared budget (one tenant's burst would spend
        its peers' rate), and tenant-refused requests never preempt."""
        if max_inflight and inflight >= max_inflight * tier.admit_fraction:
            victim = None
            if tier.index < self.preempt_from:
                victim = self._pick_victim(tier)
            if victim is None:
                self.sheds[(tier.name, "pressure")] += 1
                return "shed", None
            if not self._tenant_allows(tier, tenant):
                # over the TENANT's rate even with a victim available:
                # put the victim back and shed — never burn a
                # background dispatch for a request this tenant's own
                # budget refuses anyway
                self._preemptable[victim.tier.index][victim.key] = victim
                self._shed_tenant(tier, tenant)
                return "shed", None
            if tier.bucket is not None and not tier.bucket.try_take():
                # over its rate even with a victim available: shed
                # WITHOUT preempting (never burn a background dispatch
                # for a request the bucket refuses anyway)
                self._preemptable[victim.tier.index][victim.key] = victim
                self.sheds[(tier.name, "bucket")] += 1
                return "shed", None
            victim.event.set()
            self.preemptions[victim.tier.index] += 1
            self.sheds[(victim.tier.name, "preempted")] += 1
            self.admitted[tier.index] += 1
            return "admit", victim
        if not self._tenant_allows(tier, tenant):
            self._shed_tenant(tier, tenant)
            return "shed", None
        if tier.bucket is not None and not tier.bucket.try_take():
            self.sheds[(tier.name, "bucket")] += 1
            return "shed", None
        self.admitted[tier.index] += 1
        return "admit", None

    def on_start(self, tier: QosTier) -> None:
        self.inflight[tier.index] += 1

    def on_complete(self, tier: QosTier) -> None:
        self.inflight[tier.index] = max(0, self.inflight[tier.index] - 1)
        self.completed[tier.index] += 1

    # -- preemption registry --------------------------------------------

    def _pick_victim(self, preemptor: QosTier) -> Optional[_PreemptSlot]:
        """Newest request in the worst occupied preemptable tier that
        is strictly lower-priority than the preemptor."""
        for idx in range(len(self.tiers) - 1, self.preempt_from - 1, -1):
            if idx <= preemptor.index:
                break
            slots = self._preemptable[idx]
            if slots:
                _, slot = slots.popitem(last=True)
                return slot
        return None

    def register_preemptable(self, tier: QosTier,
                             event) -> Optional[_PreemptSlot]:
        """Called by the proxy when a preemptable-tier request starts
        its backend dispatch; returns None for tiers that never
        preempt-register (the hot path for tier 0)."""
        if tier.index < self.preempt_from:
            return None
        slot = _PreemptSlot(tier, event, next(self._slot_ids))
        self._preemptable[tier.index][slot.key] = slot
        return slot

    def unregister_preemptable(self, slot: Optional[_PreemptSlot]) -> None:
        if slot is not None:
            self._preemptable[slot.tier.index].pop(slot.key, None)

    # -- deadlines ------------------------------------------------------

    def deadline_factor(self, tier: QosTier) -> float:
        """Scale for the router-injected downstream deadline: tier 0
        keeps the full ``--request-timeout`` budget; background tiers
        get proportionally less, so the engine's queue-expiry sweep
        drops THEIR queued work first when delay builds."""
        return tier.admit_fraction

    # -- introspection --------------------------------------------------

    def snapshot(self) -> Dict:
        tiers = []
        for t in self.tiers:
            shed = {r: self.sheds.get((t.name, r), 0)
                    for r in SHED_REASONS}
            tiers.append({
                "tier": t.name, "index": t.index,
                "admit_fraction": t.admit_fraction,
                "rate_limited": t.bucket is not None,
                "admitted": self.admitted[t.index],
                "completed": self.completed[t.index],
                "in_flight": self.inflight[t.index],
                "sheds": shed,
                "shed_total": sum(shed.values()),
                "preempted": self.preemptions[t.index],
            })
        out = {"preempt_from": self.preempt_from, "tiers": tiers}
        if self.tenant_rate > 0:
            out["tenant_rate"] = self.tenant_rate
            out["tenants_tracked"] = len(self._tenant_buckets)
            out["tenant_sheds"] = {
                f"{tenant}/{tier}": n
                for (tenant, tier), n in sorted(self.tenant_sheds.items())}
        return out

    def shed_totals(self) -> Dict[str, int]:
        out: Dict[str, int] = {t.name: 0 for t in self.tiers}
        for (name, _reason), n in self.sheds.items():
            out[name] += n
        return out
