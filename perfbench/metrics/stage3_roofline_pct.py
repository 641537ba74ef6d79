"""Stage 3 (query bits, kernel 1, the survivor select): the least bytes of
every traced batch (``bounds.stage3_bytes``) at the HBM rate, over the
device time of the operations launched inside ``bench.stage3``."""

from perfbench import bounds


def read(rec):
    s = (rec.get("stage_device_s") or {}).get("stage3", 0.0)
    b = rec.get("batches") or []
    if not b or s <= 0:
        return None
    sh = rec["shape"]
    nbytes = sum(bounds.stage3_bytes(x["queries"], sh["P"], sh["n_max"],
                                     sh["G"], sh["keep_s"]) for x in b)
    return bounds.roofline_pct(nbytes, s)
