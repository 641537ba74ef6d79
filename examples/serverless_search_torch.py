"""End-to-end serverless hybrid search with the PyTorch port.

    PYTHONPATH=src python examples/serverless_search_torch.py
        [--device cpu] [--scale 0.02] [--skip-process]

The twin of ``examples/serverless_search.py``: drives batched hybrid
queries through the port's serverless runtime (``repro_torch.serverless``).
The Coordinator fans out over the Alg. 2 ID-jump tree (F=4, l_max=3), each
QueryAllocator runs attribute filtering + Alg. 1 partition selection on its
query slice, each QueryProcessor runs Stages 3–5 of the torch plane on its
partition shard (on the card unless ``--device cpu``; raises without
CUDA), and results merge back up the tree. Payload bytes are budgeted
against the Lambda 6 MB cap, warm containers reuse their index singletons
(DRE, §3.2), and the run is priced by the §3.5 cost model.

Prints recall, cold/warm makespans, QPS, DRE savings and dollars per 1k
queries, and checks the runtime's ids against the single-host torch
plane. A third pass re-runs the batch with the §5.6 result cache on: the
Coordinator serves every repeated query itself. A fourth runs the same
choreography over real worker processes (one per QP partition + an
allocator pool; ``--skip-process`` leaves it out).
"""

import argparse

import numpy as np

from repro_torch.core.pipeline import SquashConfig, SquashIndex
from repro_torch.data.synthetic import (default_predicates, ground_truth,
                                        make_vector_dataset)
from repro_torch.serve.engine import resolve_device
from repro_torch.serverless import RuntimeConfig, ServerlessRuntime

N_QA_F, N_QA_L = 4, 3          # F=4, l_max=3 → N_QA = 84 (paper sweet spot)
NUM_QUERIES, K = 50, 10


def main(argv=None) -> dict:
    """Runs the example; returns the cold and warm ``SearchResult``s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.02,
                    help="share of the 1M-row preset (default 0.02)")
    ap.add_argument("--skip-process", action="store_true",
                    help="leave out the process-transport pass")
    args = ap.parse_args(argv)
    dev = str(resolve_device(args.device))

    ds = make_vector_dataset("sift1m", scale=args.scale,
                             num_queries=NUM_QUERIES)
    preds = default_predicates(ds.attr_cardinality)
    idx = SquashIndex.build(ds.vectors, ds.attributes,
                            SquashConfig(num_partitions=10))

    rt = ServerlessRuntime(idx, RuntimeConfig(
        branching=N_QA_F, max_level=N_QA_L, warm_prob=0.95, device=dev))
    cold = rt.search(ds.queries, preds, k=K)       # cold fleet
    warm = rt.search(ds.queries, preds, k=K)       # warm containers + DRE

    gt_ids, _ = ground_truth(ds, preds, k=K)
    hits = sum(len(set(warm.ids[i]) & set(gt_ids[i]))
               for i in range(len(warm.ids)))
    recall = hits / gt_ids.size

    # The runtime must agree bit-for-bit with the single-host torch plane.
    ids_ref, _, _ = idx.search(ds.queries, preds, k=K, backend="torch",
                               device=dev)
    assert np.array_equal(warm.ids, ids_ref), "runtime diverged from the plane"

    t = warm.trace
    qps = ds.queries.shape[0] / t.makespan_s
    cost_per_1k = t.cost["total"] * 1000 / ds.queries.shape[0]
    print(f"recall@10            = {recall:.3f} (QPs on {dev})")
    print(f"fleet                = 1 CO + {t.invocations('qa')} QA + "
          f"{t.invocations('qp')} QP invocations "
          f"(N_QA={t.invocations('qa')}, F={N_QA_F}, l_max={N_QA_L})")
    print(f"makespan cold → warm = {cold.trace.makespan_s * 1e3:.0f} ms → "
          f"{t.makespan_s * 1e3:.0f} ms "
          f"({ds.queries.shape[0]} queries)")
    print(f"simulated QPS        = {qps:.0f}")
    print(f"DRE                  : {t.dre.s3_gets} S3 GETs for "
          f"{t.dre.invocations} invocations ({t.dre.dre_hits} singleton hits;"
          f" cold wave paid {cold.trace.dre.s3_gets})")
    print(f"payload moved        = {t.payload_bytes / 1e6:.2f} MB "
          f"(≤ {rt.cfg.max_payload_bytes // 2**20} MB per invocation)")
    print(f"escalated visits     = {t.escalations} (§2.5 filter-count "
          f"guarantee)")
    print(f"cost per 1k queries  = ${cost_per_1k:.4f} "
          f"(λ-runtime {t.cost['lambda_runtime'] / t.cost['total']:.0%})")
    assert recall >= 0.9
    assert t.dre.s3_gets < cold.trace.dre.s3_gets

    # §5.6 result cache: same batch twice through a cache-enabled runtime —
    # the repeat pass is served entirely at the Coordinator.
    rt_c = ServerlessRuntime(idx, RuntimeConfig(
        branching=N_QA_F, max_level=N_QA_L, warm_prob=0.95,
        cache_enabled=True, device=dev))
    rt_c.search(ds.queries, preds, k=K)                  # populate
    cached = rt_c.search(ds.queries, preds, k=K)         # all hits
    tc = cached.trace
    assert np.array_equal(cached.ids, ids_ref), "cached ids diverged"
    assert tc.cache_hits == ds.queries.shape[0]
    print(f"result cache repeat  = {tc.cache_hits}/{ds.queries.shape[0]} "
          f"hits; {len(tc.nodes)} invocation(s) vs {len(t.nodes)}, "
          f"${tc.cost['total'] * 1000 / ds.queries.shape[0]:.6f} per 1k "
          f"(was ${cost_per_1k:.4f}), makespan "
          f"{tc.makespan_s * 1e3:.0f} ms")
    assert tc.cost["total"] < t.cost["total"]
    out = {"cold": cold, "warm": warm}
    if args.skip_process:
        return out

    # Real multi-process transport: the same choreography over long-lived
    # worker processes (one per QP partition, each on the runtime's device,
    # + an allocator pool on the CPU) — payloads cross real process
    # boundaries, warm starts are real, and the measured wall-clock sits
    # next to the modeled timeline in the trace.
    rt_p = ServerlessRuntime(idx, RuntimeConfig(
        branching=2, max_level=1, transport="process", qa_workers=2,
        device=dev))
    try:
        p_cold = rt_p.search(ds.queries, preds, k=K)
        p_warm = rt_p.search(ds.queries, preds, k=K)
    finally:
        rt_p.close()
    assert np.array_equal(p_warm.ids, ids_ref), "process transport diverged"
    tw = p_warm.trace
    print(f"process transport    = {tw.invocations('qa')} QA + "
          f"{tw.invocations('qp')} QP real invocations; measured "
          f"{p_cold.trace.measured_makespan_s * 1e3:.0f} ms cold → "
          f"{tw.measured_makespan_s * 1e3:.0f} ms warm "
          f"(modeled {tw.makespan_s * 1e3:.0f} ms); "
          f"{tw.dre.dre_hits}/{tw.dre.invocations} pid-keyed warm hits, "
          f"{tw.worker_retries} retries")
    assert tw.dre.s3_gets == 0, "live workers must serve the repeat warm"
    out["process_warm"] = p_warm
    return out


if __name__ == "__main__":
    main()
