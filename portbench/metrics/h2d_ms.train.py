"""Host-to-device copy time on the device per train step: the batch staged
by ``Trainer._put`` in the prefetch thread (pageable copies)."""

H2D = r"Memcpy HtoD"


def read(m):
    if not m.rec["calls"] or not m.trace.count(H2D):
        return None
    return m.trace.seconds(H2D) / m.rec["calls"] * 1e3
