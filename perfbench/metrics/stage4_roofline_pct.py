"""Stage 4 (kernel 2 or 2b, its tables or cells, the stable sort): the
least bytes of every traced batch (``bounds.stage4_bytes``, with the
batch's live survivor slots) at the HBM rate, over the device time of the
operations launched inside ``bench.stage4``."""

from perfbench import bounds


def read(rec):
    s = (rec.get("stage_device_s") or {}).get("stage4", 0.0)
    b = rec.get("batches") or []
    if not b or s <= 0:
        return None
    sh = rec["shape"]
    nbytes = sum(bounds.stage4_bytes(x["queries"], sh["P"], sh["m1"], sh["d"],
                                     x["live_slots"], sh["take_s"]) for x in b)
    return bounds.roofline_pct(nbytes, s)
