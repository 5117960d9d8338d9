"""Device idle time a ``Ranker.rank`` call inside the port's span
``drin.serve.prepare`` (``Ranker._prepare``: the request's host arrays
checked and staged to the card), in ms: the window's idle stretches
intersected with the span's host intervals (``portbench/spans.py``).  None
where the port keeps no spans."""

from portbench import spans


def read(m):
    return spans.idle_ms(m, ("drin.serve.prepare",))
