"""Host prep and uploads (``SquashIndex._search_torch`` up to the plane):
mean host-clock ms a batch from entering ``_search_torch`` to the plane's
``mark("start")``: dense candidate masks, counts and the copies to the
card."""


def read(rec):
    b = rec.get("batches") or []
    return 1e3 * sum(x["prep_s"] for x in b) / len(b) if b else None
