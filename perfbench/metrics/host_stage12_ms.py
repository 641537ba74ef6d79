"""Host Stage 1–2 (the attribute filter and Algorithm 1, in
``SquashIndex.select``): mean host-clock ms a batch, from the
``bench.select`` span around each batch's ``select``."""


def read(rec):
    b = rec.get("batches") or []
    return 1e3 * sum(x["select_s"] for x in b) / len(b) if b else None
