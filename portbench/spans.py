"""The port's own spans (``drin_tpu_torch/common/spans.py``) on the profiler's
clock, split against the device's idle stretches of a traced window.

The port keeps its closed spans in a log in memory, timed by
``perf_counter_ns``.  The timed loop takes ``rec["t0"]`` and ``rec["t1"]``
(``perf_counter`` seconds) just inside the host range ``portbench.window``,
whose start the trace holds in the profiler's microseconds, so a log time of
``t`` ns lies at ``t / 1e3 + window[0] - rec["t0"] * 1e6`` on the profiler's
clock.  The two clocks must agree on the window's length within 1 ms, and
the window's ``drin.serve.rank`` spans must number ``rec["calls"]``, or the
reading raises.  Where the port keeps no span log (a program from before
it), every function here returns None.

The serve path's children of ``drin.serve.rank`` (:data:`CHILDREN`) run one
after another on the caller's thread, so the device's idle time in the
window splits exactly into the idle time inside each child and the
remainder outside every child: the caller's loop and the Python between the
children.
"""

from __future__ import annotations

ROOT = "drin.serve.rank"
CHILDREN = ("drin.serve.prepare", "drin.serve.gather", "drin.serve.forward",
            "drin.serve.result")
OUTSIDE = "outside"
SKEW_US = 1000.0


def port_log():
    """The port's closed spans, or None where the port keeps no log."""
    try:
        from drin_tpu_torch.common import spans
    except ImportError:
        return None
    return spans.spans()


def window_spans(m, log=None):
    """The spans that lie inside ``[rec["t0"], rec["t1"]]`` as ``(name,
    start_us, end_us)`` on the profiler's clock, or None where the
    port keeps no log.  ``log`` defaults to the port's."""
    log = port_log() if log is None else log
    if log is None:
        return None
    t0, t1 = m.rec["t0"], m.rec["t1"]
    w0, w1 = m.trace.window
    skew = (t1 - t0) * 1e6 - (w1 - w0)
    if abs(skew) > SKEW_US:
        raise RuntimeError(f"the span log's clock and the profiler's disagree on the window's "
                           f"length by {skew:.1f} us (limit {SKEW_US:.0f})")
    offset = w0 - t0 * 1e6
    lo, hi = t0 * 1e9, t1 * 1e9
    out = [(s.name, s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset)
           for s in log if s.start_ns >= lo and s.end_ns <= hi]
    n = sum(1 for s in out if s[0] == ROOT)
    if n != m.rec["calls"]:
        raise RuntimeError(f"{n} {ROOT} spans in the window for {m.rec['calls']} calls")
    return out


def merged(intervals) -> list:
    """Sorted, disjoint ``[start, end]`` pairs covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(m, log=None):
    """The window's device idle time in microseconds, by the serve child
    whose host interval it falls in, and :data:`OUTSIDE` every child; None
    where the port keeps no log."""
    spans = window_spans(m, log)
    if spans is None:
        return None
    gaps = merged(m.trace.gaps())
    out = {}
    for name in CHILDREN:
        out[name] = overlap(gaps, merged((a, b) for n, a, b in spans if n == name))
    cover = merged((a, b) for n, a, b in spans if n in CHILDREN)
    out[OUTSIDE] = sum(b - a for a, b in gaps) - overlap(gaps, cover)
    return out


def idle_ms(m, names, log=None):
    """Device idle time a call inside the spans ``names``, in ms."""
    split = idle_split(m, log)
    if split is None:
        return None
    return sum(split[n] for n in names) / 1e3 / m.rec["calls"]
