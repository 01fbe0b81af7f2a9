"""Credit-based admission control: O(1) per request.

The regulator's job is a yes/no per incoming request, fast enough to
sit in front of every frame at 10k+ sessions. Reading the pipeline
occupancy per request would already be O(1), but credits make the
common case one integer decrement with NO cross-object reads: one
occupancy read mints a batch of credits equal to the commit pipeline's
free capacity, and each admission spends one. When the batch is spent
the next request pays for a fresh occupancy read — so admissions track
the pipeline exactly (a minted batch fills the pipeline precisely to
its cap if nothing commits meanwhile, and a commit frees capacity the
next refill observes).

Two saturation signals gate a refill:

- `Replica.ingress_occupancy()` — quorum-pending pipeline entries plus
  the dispatched-but-unfinalized backlog beyond the steady async
  window, against the same cap `_on_request` backpressures at. The
  gateway sheds with a typed busy reply just BEFORE the replica would
  start dropping silently.
- the bus `MessagePool` budget — when the shared send budget is nearly
  exhausted the replica could commit but not reply; admitting more
  requests would turn reply-path backpressure into client timeouts, so
  the regulator holds admissions until the pool drains below the
  headroom line.
"""

from __future__ import annotations


class CreditRegulator:
    def __init__(self, replica, pool=None, pool_headroom: float = 0.25):
        self.replica = replica
        self.pool = pool  # bus MessagePool (None: no pool signal)
        self.pool_headroom = pool_headroom
        self._credits = 0
        self.refills = 0  # observability: occupancy reads paid

    def try_admit(self) -> bool:
        """One request's admission. Spends a credit, or mints a fresh
        batch from the pipeline's free capacity; False = shed (typed
        busy reply, the client retries with backoff)."""
        if self._credits > 0:
            self._credits -= 1
            return True
        used, cap = self.replica.ingress_occupancy()
        free = cap - used
        if free <= 0:
            return False
        pool = self.pool
        if (
            pool is not None
            and pool.used > pool.capacity * (1.0 - self.pool_headroom)
        ):
            return False  # reply budget nearly gone: replies first
        self.refills += 1
        self._credits = free - 1  # this admission spends the first
        return True

    def drain(self) -> None:
        """Drop minted credits (tests / a saturation flip must observe
        fresh occupancy immediately)."""
        self._credits = 0
