"""Device idle time a ``Ranker.rank`` call inside the port's spans
``drin.serve.gather`` (the store's gather, kernel 2) and
``drin.serve.forward`` (the model's forward), in ms: the launch gaps that a
captured graph of the scoring would close (``portbench/spans.py``).  None
where the port keeps no spans."""

from portbench import spans


def read(m):
    return spans.idle_ms(m, ("drin.serve.gather", "drin.serve.forward"))
