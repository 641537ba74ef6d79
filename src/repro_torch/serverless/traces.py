"""Per-node run traces + §3.5 cost assembly for the serverless runtime.

Every invocation (Coordinator, each QueryAllocator chunk, each
QueryProcessor chunk) leaves one :class:`NodeTrace` carrying its virtual
timeline, payload bytes, DRE outcome and billed duration. A finished run
folds them into a :class:`RunTrace`: the makespan, aggregate DRE stats, the
:class:`~repro_torch.core.cost_model.LambdaFleet` inputs and the Eqs. 3–8 dollar
breakdown.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.cost_model import (LambdaFleet, PricingConstants,
                                   squash_query_cost)
from repro_torch.core.dre import DreStats
from repro_torch.core.pipeline import SearchStats

__all__ = ["NodeTrace", "RunTrace", "assemble_run_trace", "attribute_cost"]


def _from_fields(cls, data: Dict):
    """Build a dataclass from a dict, ignoring unknown keys (forward
    compatibility: a trace written by a newer build still loads)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in names})


@dataclasses.dataclass
class NodeTrace:
    """One invocation's timeline (virtual seconds) and payload accounting."""

    node: str                 # "co", "qa:<id>", "qp:<pid>"
    kind: str                 # "co" | "qa" | "qp"
    parent: str               # invoking node's name ("client" for the CO)
    chunk: int                # chunk index within the logical request
    t_issue: float            # parent issued the invocation
    t_start: float            # container entered the handler
    t_end: float              # response sent (billing stops here)
    invoke_s: float           # cold/warm invocation overhead
    fetch_s: float            # DRE-miss S3 fetch time (0 on a hit)
    compute_s: float          # handler busy time (measured or configured)
    request_bytes: int
    response_bytes: int
    warm: bool
    dre_hit: bool
    queries: int              # queries carried by this chunk's request
    own_queries: int = 0      # queries in the node's *own* slice (QA/QP work)
    response_chunks: int = 1  # >1 → response exceeded the cap and paginated
    cache_hits: int = 0       # CO only: queries served from the §5.6 cache
    setup_s: float = 0.0      # QP derived-state build (0 on a retained hit)
    # Measured wall-clock twin of the modeled timeline (seconds relative to
    # the run's submit instant). Under LocalTransport these record where the
    # host actually spent time executing the virtual schedule; under
    # ProcessTransport they are the *real* distributed execution — submit →
    # wire → worker handler → response — so ``RunTrace`` can report modeled
    # vs measured side by side.
    wall_issue_s: float = 0.0
    wall_start_s: float = 0.0
    wall_end_s: float = 0.0
    wall_compute_s: float = 0.0
    worker_pid: int = 0       # OS pid of the serving worker (host pid local)
    worker_host: str = ""     # "host:port" that served it (socket transport)
    retries: int = 0          # re-invocations after worker crashes
    # QP pruning accounting (0 for CO/QA nodes): candidates entering the
    # Hamming stage, survivors of it, and ADC table evaluations — the knob
    # the autotune profile turns, so the §3.5 cost fold can attribute
    # GB-second savings to fewer ADC evals per invocation.
    hamming_in: int = 0
    hamming_kept: int = 0
    adc_evals: int = 0
    refined: int = 0          # stage-5 full-precision rows this node read

    @property
    def billed_s(self) -> float:
        """Lambda bills wall time from handler entry to response."""
        return max(self.t_end - self.t_start, 0.0)

    def to_json(self) -> Dict:
        """Plain JSON-able dict (all fields are scalars already)."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(data: Dict) -> "NodeTrace":
        return _from_fields(NodeTrace, data)


@dataclasses.dataclass
class RunTrace:
    """Aggregate accounting for one ``ServerlessRuntime.search`` run."""

    nodes: List[NodeTrace]
    makespan_s: float
    escalations: int          # (query, partition) visits past the Alg. 1 cut
    request_bytes: int
    response_bytes: int
    dre: DreStats
    efs_reads: int
    efs_read_bytes: int
    stats: SearchStats
    fleet: Optional[LambdaFleet] = None
    cost: Optional[Dict] = None
    cache_hits: int = 0       # queries served from the §5.6 result cache
    cache_misses: int = 0     # queries that traversed the Alg. 2 tree
    transport: str = "local"  # which Transport backend executed the run
    measured_makespan_s: float = 0.0   # real wall-clock of the whole search
    worker_retries: int = 0   # Σ re-invocations after worker crashes
    # Per-node dollar attribution: one row per invocation (plus a synthetic
    # "co" row when a run billed the coordinator without tracing one), each
    # splitting the Eqs. 3–8 components. Rows sum to ``cost`` — see
    # :func:`attribute_cost`.
    dollars_attributed: Optional[List[Dict]] = None

    @property
    def payload_bytes(self) -> int:
        return self.request_bytes + self.response_bytes

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def invocations(self, kind: Optional[str] = None) -> int:
        return sum(1 for n in self.nodes if kind is None or n.kind == kind)

    @property
    def worker_hosts(self) -> List[str]:
        """Distinct hosts that served this run (socket transport; else [])."""
        return sorted({n.worker_host for n in self.nodes if n.worker_host})

    def to_json(self) -> Dict:
        """JSON-able dict; inverse of :meth:`from_json`.

        ``cost`` is already a plain dict; the nested dataclasses
        (``nodes``/``dre``/``stats``/``fleet``) flatten via ``asdict``.
        """
        out = dataclasses.asdict(self)
        out["nodes"] = [n.to_json() for n in self.nodes]
        out["fleet"] = (None if self.fleet is None
                        else dataclasses.asdict(self.fleet))
        return out

    @staticmethod
    def from_json(data: Dict) -> "RunTrace":
        data = dict(data)
        data["nodes"] = [NodeTrace.from_json(n) for n in data.get("nodes", ())]
        data["dre"] = _from_fields(DreStats, data.get("dre") or {})
        data["stats"] = _from_fields(SearchStats, data.get("stats") or {})
        fleet = data.get("fleet")
        data["fleet"] = None if fleet is None else _from_fields(LambdaFleet,
                                                                fleet)
        return _from_fields(RunTrace, data)


def _distribute(rows: List[Dict], key: str, weights: List[float],
                total: float) -> None:
    """Split ``total`` over ``rows[key]`` proportional to ``weights``.

    Zero totals distribute nothing; an all-zero weight vector falls back to
    a uniform split (the component was billed but no node claimed it). The
    float residual of the proportional split lands on the largest share, so
    the rows sum back to ``total`` to within one rounding of the final add.
    """
    if not total or not rows:
        return
    w_sum = math.fsum(weights)
    if w_sum <= 0.0:
        weights = [1.0] * len(rows)
        w_sum = float(len(rows))
    shares = [total * w / w_sum for w in weights]
    big = max(range(len(shares)), key=lambda i: shares[i])
    shares[big] += total - math.fsum(shares)
    for row, share in zip(rows, shares):
        row[key] += share


def attribute_cost(nodes: List[NodeTrace], *, fleet: LambdaFleet,
                   cost: Dict, prices: PricingConstants) -> List[Dict]:
    """Fold the Eqs. 3–8 run cost back onto the invocations that caused it.

    Returns one row per node — ``{"node", "kind", "chunk", "invocation",
    "runtime", "s3", "efs", "total"}`` — whose component columns sum to the
    matching ``cost`` entries (and totals to ``cost["total"]``), so the
    dashboard's $/query view and the §3.5 aggregate can never disagree:

    * **invocation** — each QA/QP node is one Lambda invocation; the cost
      model's ``+1`` coordinator charge splits over the CO's chunks (a
      synthetic CO row is added when the model billed a coordinator but no
      CO node ran, e.g. the empty-batch trace).
    * **runtime** — each node's own ``billed_s × mem_mb`` GB-seconds.
    * **s3** — DRE-miss gets, weighted by each miss's fetch time (uniform
      over the misses when fetches were instantaneous).
    * **efs** — stage-5 refinement reads, weighted by each node's
      ``refined`` row count (falling back to ``adc_evals``, then uniform
      over QP nodes, when refinement accounting is absent).
    """
    mem_mb = {"qa": fleet.mem_qa_mb, "qp": fleet.mem_qp_mb,
              "co": fleet.mem_co_mb}
    rows = [{"node": n.node, "kind": n.kind, "chunk": n.chunk,
             "invocation": 0.0, "runtime": 0.0, "s3": 0.0, "efs": 0.0}
            for n in nodes]
    billed = [n.billed_s for n in nodes]
    if not any(n.kind == "co" for n in nodes):
        rows.append({"node": "co", "kind": "co", "chunk": -1,
                     "invocation": 0.0, "runtime": 0.0, "s3": 0.0,
                     "efs": 0.0})
        billed.append(0.0)

    # Invocations: one per QA/QP node, one (total) for the coordinator.
    per_inv = prices.lambda_per_invocation
    n_co = sum(1 for r in rows if r["kind"] == "co")
    for row in rows:
        row["invocation"] = (per_inv / n_co if row["kind"] == "co"
                             else per_inv)
    big = max(range(len(rows)), key=lambda i: rows[i]["invocation"])
    rows[big]["invocation"] += (cost["lambda_invocation"]
                                - math.fsum(r["invocation"] for r in rows))

    # Runtime: each node's own GB-seconds (residual → largest consumer).
    _distribute(rows, "runtime",
                [b * mem_mb[r["kind"]] for r, b in zip(rows, billed)],
                cost["lambda_runtime"])

    # S3: DRE misses, weighted by fetch time; uniform over misses when the
    # modeled fetches were free.
    s3_w = [0.0 if n.dre_hit else n.fetch_s for n in nodes]
    if math.fsum(s3_w) <= 0.0:
        s3_w = [0.0 if n.dre_hit else 1.0 for n in nodes]
    s3_w += [0.0] * (len(rows) - len(nodes))
    _distribute(rows, "s3", s3_w, cost["s3"])

    # EFS: refinement reads; adc_evals approximates when refined counts are
    # missing (older traces), then uniform over the QP fleet.
    efs_w = [float(n.refined) for n in nodes]
    if math.fsum(efs_w) <= 0.0:
        efs_w = [float(n.adc_evals) for n in nodes]
    if math.fsum(efs_w) <= 0.0:
        efs_w = [1.0 if n.kind == "qp" else 0.0 for n in nodes]
    efs_w += [0.0] * (len(rows) - len(nodes))
    _distribute(rows, "efs", efs_w, cost["efs"])

    for row in rows:
        row["total"] = math.fsum((row["invocation"], row["runtime"],
                                  row["s3"], row["efs"]))
    big = max(range(len(rows)), key=lambda i: rows[i]["total"])
    rows[big]["total"] += (cost["total"]
                           - math.fsum(r["total"] for r in rows))
    return rows


def assemble_run_trace(
    nodes: List[NodeTrace],
    *,
    makespan_s: float,
    escalations: int,
    dre: DreStats,
    efs_reads: int,
    efs_read_bytes: int,
    stats: SearchStats,
    mem_qa_mb: int,
    mem_qp_mb: int,
    mem_co_mb: int,
    prices: PricingConstants,
    cache_hits: int = 0,
    cache_misses: int = 0,
    transport: str = "local",
    measured_makespan_s: float = 0.0,
) -> RunTrace:
    """Fold node traces into fleet inputs and the Eqs. 3–8 breakdown."""
    t_qa = sum(n.billed_s for n in nodes if n.kind == "qa")
    t_qp = sum(n.billed_s for n in nodes if n.kind == "qp")
    t_co = sum(n.billed_s for n in nodes if n.kind == "co")
    fleet = LambdaFleet(
        n_qa=sum(1 for n in nodes if n.kind == "qa"),
        n_qp=sum(1 for n in nodes if n.kind == "qp"),
        mem_qa_mb=mem_qa_mb,
        mem_qp_mb=mem_qp_mb,
        mem_co_mb=mem_co_mb,
        t_qa_s=t_qa,
        t_qp_s=t_qp,
        t_co_s=t_co,
        s3_gets=dre.s3_gets,
        efs_reads=efs_reads,
        efs_read_bytes=efs_read_bytes,
    )
    cost = squash_query_cost(fleet, prices)
    return RunTrace(
        nodes=nodes,
        makespan_s=makespan_s,
        escalations=escalations,
        request_bytes=sum(n.request_bytes for n in nodes),
        response_bytes=sum(n.response_bytes for n in nodes),
        dre=dre,
        efs_reads=efs_reads,
        efs_read_bytes=efs_read_bytes,
        stats=stats,
        fleet=fleet,
        cost=cost,
        dollars_attributed=attribute_cost(nodes, fleet=fleet, cost=cost,
                                          prices=prices),
        cache_hits=cache_hits,
        cache_misses=cache_misses,
        transport=transport,
        measured_makespan_s=measured_makespan_s,
        worker_retries=sum(n.retries for n in nodes),
    )
