"""Serverless cost model for distributed vector search (paper §3.5, Eqs. 3–8).

C_total = C_λ + C_S3 + C_EFS, with λ split into per-invocation and
MB-second runtime charges. Constants default to public AWS eu-west-1 prices
(the paper's region); all are overridable so the model stays provider-agnostic.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["PricingConstants", "LambdaFleet", "squash_query_cost",
           "server_baseline_cost", "daily_cost_curve"]


@dataclasses.dataclass(frozen=True)
class PricingConstants:
    lambda_per_invocation: float = 2.0e-7        # $/request
    lambda_per_mb_second: float = 1.6279e-8      # $/MB-s  (== $1.66667e-5 per GB-s)
    s3_per_get: float = 4.0e-7                   # $/GET
    efs_per_byte: float = 3.0e-11                # $/byte (Elastic Throughput reads)

    # Server-baseline comparison points (on-demand, eu-west-1).
    ec2_c7i_16xlarge_hour: float = 2.8560
    ec2_c7i_4xlarge_hour: float = 0.7140


@dataclasses.dataclass
class LambdaFleet:
    """One query batch's worth of FaaS activity (inputs to Eqs. 5–8)."""

    n_qa: int
    n_qp: int
    mem_qa_mb: int = 1770
    mem_qp_mb: int = 1770
    mem_co_mb: int = 512
    t_qa_s: float = 0.0        # summed QA runtimes (Σ T_A_i)
    t_qp_s: float = 0.0        # summed QP runtimes (Σ T_P_i)
    t_co_s: float = 0.0
    s3_gets: int = 0           # L
    efs_reads: int = 0         # S (count of random full-precision reads)
    efs_read_bytes: int = 0    # S · R_size


def squash_query_cost(
    fleet: LambdaFleet, prices: PricingConstants = PricingConstants()
) -> dict:
    """Evaluate Eqs. 3–8 for one batch. Returns per-component dollars."""
    c_invoc = (fleet.n_qa + fleet.n_qp + 1) * prices.lambda_per_invocation
    c_run = (
        fleet.mem_qa_mb * fleet.t_qa_s
        + fleet.mem_qp_mb * fleet.t_qp_s
        + fleet.mem_co_mb * fleet.t_co_s
    ) * prices.lambda_per_mb_second
    c_s3 = fleet.s3_gets * prices.s3_per_get
    c_efs = fleet.efs_read_bytes * prices.efs_per_byte
    total = c_invoc + c_run + c_s3 + c_efs
    return {
        "lambda_invocation": c_invoc,
        "lambda_runtime": c_run,
        "s3": c_s3,
        "efs": c_efs,
        "total": total,
    }


def server_baseline_cost(
    hours: float,
    instances: int = 2,
    hourly: float = PricingConstants().ec2_c7i_16xlarge_hour,
) -> float:
    """Provisioned-server comparison (paper Fig. 8 assumes 2 instances)."""
    return hours * instances * hourly


def daily_cost_curve(
    per_batch_cost: float,
    batch_queries: int,
    daily_volumes: Sequence[int],
) -> list:
    """SQUASH daily cost at uniform arrival volumes (x-axis of Fig. 8)."""
    return [v / batch_queries * per_batch_cost for v in daily_volumes]
