"""Kernel 1 (``gcn_layer``, the float32 form) in the train step's forward
against its bound, read as ``gcn_fwd_roofline.rank`` reads it: the backward
runs through the plain version and launches no kernel 1."""

from portbench import harness


def read(m):
    return harness.load_file_module("metrics", "gcn_fwd_roofline.rank").read(m)
