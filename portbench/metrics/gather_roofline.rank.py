"""Kernel 2 (``gather_dequant``) against its bound: each launch gathers the
call's B·C rows of the packed int8 DRIN slab (pooled and CLS text, image,
object) and writes them in the compute dtype; the bound is those bytes at
the card's memory rate, over the kernel's device time."""

from portbench import counts

KERNEL = r"gather_dequant"


def read(m):
    ops = m.trace.ops(KERNEL)
    if not ops:
        return None
    cfg = m.run.config
    widths = (2 * cfg["bert_embed_dim"], cfg["resnet_embed_dim"],
              cfg["entity_object_topk"] * cfg["resnet_embed_dim"])
    calls = [s for s in m.rec["shapes"]]
    if len(ops) != len(calls):
        raise RuntimeError(f"{len(ops)} gather launches traced for {len(calls)} calls")
    pk = m.peaks
    bound = sum(counts.gather_bytes(s["B"] * s["C"], widths, cfg["compute_dtype"])
                for s in calls) / pk["bytes_per_s"]
    return 100.0 * bound / m.trace.seconds(KERNEL)
