"""Quickstart with the PyTorch port: build a SQUASH index and run hybrid
(filtered) queries on the card.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
        [--scale 0.02]

The twin of ``examples/quickstart.py``: builds the full OSQ pipeline
(partitions → KLT → non-uniform bits → segment packing → low-bit index →
quantized attributes) on a SIFT-like synthetic dataset (``--scale`` of the
1M-row preset; 20,000 × 128 by default), then answers attribute-filtered
top-10 queries through ``search(backend="torch")`` (kernel 1 and a Stage 4
kernel on the card) and reports recall against exact brute force. Runs on
the CUDA card unless ``--device cpu``; raises without CUDA.
"""

import argparse

import numpy as np

from repro_torch.core.attributes import Predicate
from repro_torch.core.pipeline import SquashConfig, SquashIndex
from repro_torch.data.synthetic import (default_predicates, ground_truth,
                                        make_vector_dataset)
from repro_torch.serve.engine import resolve_device

NUM_QUERIES, K = 20, 10
# Hybrid query: "attr0 in [0, 2] AND attr1 < 6 AND attr2 >= 3"
PREDICATES = [Predicate(attr=0, op="B", lo=0, hi=2),
              Predicate(attr=1, op="<", lo=6),
              Predicate(attr=2, op=">=", lo=3)]


def recall(ids: np.ndarray, gt_ids: np.ndarray) -> float:
    hits = sum(len(set(ids[i]) & set(gt_ids[i])) for i in range(len(ids)))
    return hits / gt_ids.size


def main(argv=None) -> dict:
    """Runs the example; returns each predicate set's ids and stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.02,
                    help="share of the 1M-row preset (default 0.02)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_vector_dataset("sift1m", scale=args.scale,
                             num_queries=NUM_QUERIES)
    print(f"building dataset (SIFT-like, {ds.n} × {ds.d}d, 4 attributes)...")

    print("building SQUASH index (10 partitions, b = 4d, S = 8)...")
    idx = SquashIndex.build(ds.vectors, ds.attributes,
                            SquashConfig(num_partitions=10))
    sizes = idx.index_bytes()
    full = sizes.pop("full_precision")
    print(f"  index: {sum(sizes.values()) / 1e6:.1f} MB quantized "
          f"(vs {full / 1e6:.1f} MB full precision)")

    out = {}
    ids, _, stats = idx.search(ds.queries, PREDICATES, k=K, backend="torch",
                               device=dev)
    gt_ids, _ = ground_truth(ds, PREDICATES, k=K)
    print(f"  recall@10 = {recall(ids, gt_ids):.3f} on {dev}  "
          f"({stats.partitions_visited / stats.queries:.1f} partitions/query, "
          f"{stats.hamming_kept / max(stats.hamming_in, 1):.0%} kept "
          f"after Hamming prune)")
    out["hybrid"] = (ids, stats)

    # The §5.1 benchmark predicates (~8 % joint selectivity).
    preds = default_predicates(ds.attr_cardinality)
    ids, _, stats = idx.search(ds.queries, preds, k=K, backend="torch",
                               device=dev)
    gt_ids, _ = ground_truth(ds, preds, k=K)
    print(f"  paper-benchmark predicates: recall@10 = "
          f"{recall(ids, gt_ids):.3f}")
    out["paper"] = (ids, stats)
    return out


if __name__ == "__main__":
    main()
