"""Several processes on ``torch.distributed`` (port of ``drin_tpu/parallel``):
the (data, model) grid of ranks and its process groups (``mesh``), and
joining the process group (``distributed``)."""
