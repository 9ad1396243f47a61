"""Size-bucket policy for multi-tenant batched serving.

A copy of the JAX package's ``repro.serving.bucket`` (it imports only
``dataclasses``), unchanged but for this paragraph.

A fleet multiplexes many independent (graph, activity) tenants onto one
device by stacking their padded operator arrays along a lane axis and
running the Power-ψ iteration vmapped over that axis.  Lanes can only stack
when their arrays share a shape, so every tenant is padded up to a
**bucket**: a ``(n_pad, e_pad)`` capacity pair drawn from a small ladder of
sizes.  The ladder trades two costs against each other:

* too few rungs → tiny tenants share buckets with huge ones and burn HBM /
  flops on padding (low *occupancy*);
* too many rungs → every bucket shape compiles its own batched solver and
  admits few co-tenants to amortize it over.

:class:`BucketPolicy` owns that ladder.  Node capacities come from an
explicit ascending tuple (extended by doubling past the last rung, so any
graph is admissible); edge capacities are geometric levels
``edge_quantum · edge_growth^k``, which leaves every tenant headroom for
O(Δ) edge inserts before it must *rebucket* — migrate, warm state intact,
to the next rung (:meth:`BucketPolicy.needs_rebucket`).
"""
from __future__ import annotations

import dataclasses

__all__ = ["BucketSpec", "BucketPolicy"]


@dataclasses.dataclass(frozen=True, order=True)
class BucketSpec:
    """One rung of the ladder: padded node / edge capacities of a batch."""

    n_pad: int
    e_pad: int

    def fits(self, n: int, m: int) -> bool:
        return n <= self.n_pad and m <= self.e_pad

    def node_occupancy(self, n: int) -> float:
        return n / self.n_pad

    def edge_occupancy(self, m: int) -> float:
        return m / self.e_pad

    def __str__(self) -> str:
        return f"bucket[n≤{self.n_pad}, m≤{self.e_pad}]"


class BucketPolicy:
    """Maps a tenant's (n, m) to the smallest bucket that holds it.

    Args:
      node_sizes: ascending node-capacity rungs.  A graph larger than the
        last rung gets a doubled extension (the ladder is open-ended).
      edge_quantum: smallest edge capacity.
      edge_growth: geometric factor between edge rungs (> 1); the average
        edge padding waste is bounded by ``edge_growth − 1``.
      lane_quantum: batch sizes are rounded up to a multiple of this, so a
        bucket's compiled loop survives small membership churn (the padded
        lanes are inert — zero operators converge in one masked step).
    """

    def __init__(self, node_sizes: tuple[int, ...] = (256, 1024, 4096,
                                                      16_384, 65_536),
                 *, edge_quantum: int = 1024, edge_growth: float = 2.0,
                 lane_quantum: int = 1):
        if not node_sizes or list(node_sizes) != sorted(set(node_sizes)):
            raise ValueError("node_sizes must be ascending and non-empty")
        if min(node_sizes) < 1 or edge_quantum < 1:
            raise ValueError("capacities must be positive")
        if edge_growth <= 1.0:
            raise ValueError("edge_growth must exceed 1")
        self.node_sizes = tuple(int(s) for s in node_sizes)
        self.edge_quantum = int(edge_quantum)
        self.edge_growth = float(edge_growth)
        self.lane_quantum = max(1, int(lane_quantum))

    @classmethod
    def from_spec(cls, spec: str, **kw) -> "BucketPolicy":
        """Parse a ``--bucket-sizes``-style comma list, e.g. ``"512,4096"``."""
        sizes = tuple(int(tok) for tok in spec.replace(" ", "").split(",")
                      if tok)
        return cls(sizes, **kw)

    # ------------------------------------------------------------------ #
    def node_capacity(self, n: int) -> int:
        for size in self.node_sizes:
            if n <= size:
                return size
        cap = self.node_sizes[-1]
        while cap < n:                       # open-ended: keep doubling
            cap *= 2
        return cap

    def edge_capacity(self, m: int) -> int:
        cap = self.edge_quantum
        while cap < m:
            cap = int(cap * self.edge_growth)
        return cap

    def bucket_for(self, n: int, m: int) -> BucketSpec:
        if n < 1:
            raise ValueError("empty graph has no bucket")
        return BucketSpec(self.node_capacity(n),
                          self.edge_capacity(max(1, m)))

    def needs_rebucket(self, spec: BucketSpec, n: int, m: int) -> bool:
        """True once growth has escaped ``spec`` — time to migrate."""
        return not spec.fits(n, m)

    def lanes_padded(self, count: int) -> int:
        q = self.lane_quantum
        return max(q, -(-count // q) * q)

    # ------------------------------------------------------------------ #
    def occupancy(self, spec: BucketSpec,
                  tenants: list[tuple[int, int]]) -> dict:
        """Accounting for one bucket: how much of the padded batch is real.

        ``tenants`` is a list of (n, m) pairs; returns node/edge/lane
        occupancy fractions plus the padded lane count the batch compiles
        for.  The fleet surfaces this per bucket so an operator can see
        which rungs are wasting device memory.
        """
        lanes = self.lanes_padded(len(tenants)) if tenants else 0
        if not tenants:
            return dict(tenants=0, lanes=0, node_occupancy=0.0,
                        edge_occupancy=0.0, lane_occupancy=0.0)
        node = sum(spec.node_occupancy(n) for n, _ in tenants) / len(tenants)
        edge = sum(spec.edge_occupancy(m) for _, m in tenants) / len(tenants)
        return dict(tenants=len(tenants), lanes=lanes,
                    node_occupancy=node, edge_occupancy=edge,
                    lane_occupancy=len(tenants) / lanes)
