"""Host-to-device copy time on the device per ``Ranker.rank`` call: the
request's feature arrays staged by ``Ranker._prepare`` (pageable copies)."""

H2D = r"Memcpy HtoD"


def read(m):
    if not m.rec["calls"] or not m.trace.count(H2D):
        return None
    return m.trace.seconds(H2D) / m.rec["calls"] * 1e3
