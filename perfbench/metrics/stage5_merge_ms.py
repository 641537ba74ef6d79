"""Stage 5 and the merge (gather, L2, sorts): device ms a batch of the
operations launched inside ``bench.stage5``."""


def read(rec):
    s = (rec.get("stage_device_s") or {}).get("stage5", 0.0)
    b = rec.get("batches") or []
    return 1e3 * s / len(b) if b and s > 0 else None
