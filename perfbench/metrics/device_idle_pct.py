"""Device idle share (%) of the traced window: the time in which no
kernel, copy or fill ran on the card, from the profiler's trace."""


def read(rec):
    w = rec.get("window_s")
    if not w or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / w)
