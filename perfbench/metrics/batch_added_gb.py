"""Device memory one batch adds over the resident index (GB): the peak of
one batch of the cell's shape run alone after the window, less what was
allocated before it."""


def read(rec):
    v = rec.get("batch_added_bytes")
    return v / 1e9 if v else None
