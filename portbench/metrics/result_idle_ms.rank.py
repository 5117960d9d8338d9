"""Device idle time a ``Ranker.rank`` call inside the port's span
``drin.serve.result`` (the top-k and the copy of its answer back to the
host), in ms (``portbench/spans.py``).  None where the port keeps no
spans."""

from portbench import spans


def read(m):
    return spans.idle_ms(m, ("drin.serve.result",))
