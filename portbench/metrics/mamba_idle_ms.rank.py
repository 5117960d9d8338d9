"""Device idle time a ``Ranker.rank`` call inside the port's span
``drin.granite.mamba`` (the granite tower's Mamba-2 mixer: in_proj, the
conv, the scan, the gated norm, out_proj), in ms: the window's idle
stretches intersected with the spans' host intervals
(``portbench/spans.py``), the launch gaps between the mixer's small
operations.  None where the port keeps no spans, or none of these."""

from portbench import spans

SPAN = "drin.granite.mamba"


def read(m):
    log = spans.window_spans(m)
    if log is None:
        return None
    mixer = spans.merged((a, b) for name, a, b in log if name == SPAN)
    if not mixer:
        return None
    return spans.overlap(spans.merged(m.trace.gaps()), mixer) / 1e3 / m.rec["calls"]
