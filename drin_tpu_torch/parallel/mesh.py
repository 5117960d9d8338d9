# -*- coding: utf-8 -*-
"""The (data, model) grid of ranks (port of ``drin_tpu/parallel/mesh.py``).

In the JAX package a mesh lays out devices and GSPMD inserts the
collectives.  Here one process is one rank with one device, the mesh lays out
the ranks of the process group, and the code that needs a collective names
its group:

  * ``data``: the batch axis.  Each data index owns a contiguous block of the
    global batch's rows; the loss gathers the scores of its *data group* (the
    ranks of one model column) and the gradients are summed over it.
  * ``model``: the candidate axis of every model's compute and the
    entity-row axis of the row-sharded store (``data/device_store.py``).
    The ranks of one data row form its *model group*.  Each model computes
    its entity side over this rank's block of the candidates
    (:class:`CandidateSplit`; the trainer pads C to a multiple of the axis,
    :func:`padded_candidate_count`), its mention side whole on every rank,
    and gathers the score blocks: DRIN also sums the mention means'
    messages over the group, MELHI ORs its image gate over it, and the
    online GHMFC in zipped mode splits its entity sentences (S) instead,
    each rank's sentences pooling to its own contiguous block of candidate
    slots.  A model whose split dim the axis does not divide (a zipped S)
    replicates its compute along the axis.  A row-sharded store's gather
    hands each rank its block of the candidates with one reduce-scatter
    (whole on every rank when the axis does not divide C).

``make_hybrid_mesh`` lays the model axis within a host and the data axis
across hosts: the per-step gathers of the store stay on one host, and only
the gradient and counter sums cross hosts.
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """``ranks`` [data, model] laid out over the process group, seen from
    rank ``rank``.  With ``groups=True`` (the process group must be joined)
    every rank of the world builds every group in the same order, as
    ``torch.distributed.new_group`` requires, and keeps its own:
    ``data_group`` (its model column), ``model_group`` (its data row) and
    ``group`` (all of the mesh's ranks; ``None``, the world, when the mesh
    covers it).  A rank outside the grid is idle: ``active`` is False and
    its groups are None."""

    def __init__(self, ranks, rank: int = 0, groups: bool = False):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        assert self.ranks.ndim == 2 and len(set(self.ranks.ravel())) == self.ranks.size, self.ranks
        self.rank = int(rank)
        where = np.argwhere(self.ranks == self.rank)
        self.active = len(where) == 1
        self.data_index, self.model_index = (int(i) for i in where[0]) if self.active else (-1, -1)
        self.group = self.data_group = self.model_group = None
        # the data group's ranks in data-index order, as group ranks (a group
        # numbers its members in ascending global rank)
        column = self.ranks[:, max(self.model_index, 0)].tolist()
        self.data_order = [sorted(column).index(r) for r in column]
        # and the model group's ranks in model-index order
        row = self.ranks[max(self.data_index, 0), :].tolist()
        self.model_order = [sorted(row).index(r) for r in row]
        if groups:
            self._new_groups()

    def _new_groups(self):
        import torch.distributed as dist

        world = dist.get_world_size()
        nd, nm = self.ranks.shape
        columns = [dist.new_group(self.ranks[:, m].tolist()) for m in range(nm)]
        rows = [dist.new_group(self.ranks[d, :].tolist()) for d in range(nd)]
        whole = None if self.ranks.size == world else dist.new_group(sorted(self.ranks.ravel().tolist()))
        if self.active:
            self.data_group = columns[self.model_index]
            self.model_group = rows[self.data_index]
            self.group = whole

    @property
    def shape(self) -> dict:
        nd, nm = self.ranks.shape
        return {DATA_AXIS: nd, MODEL_AXIS: nm}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def main(self) -> bool:
        """The rank that logs, writes checkpoints and dumps test results."""
        return self.rank == int(self.ranks[0, 0])

    def candidate_split(self) -> Optional["CandidateSplit"]:
        """This rank's share of the candidate dim over its model group, or
        None when the model axis has one rank."""
        nm = self.shape[MODEL_AXIS]
        if nm == 1 or not self.active:
            return None
        return CandidateSplit(self.model_group, self.model_index, nm, self.model_order)

    def __repr__(self):
        return f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, rank={self.rank})"


def _world(world_size: Optional[int], rank: Optional[int]) -> tuple:
    if world_size is not None:
        return world_size, rank or 0
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(cfg=None, data: Optional[int] = None, model: Optional[int] = None, *,
              world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the world's ranks in rank order.

    Sizes come from ``cfg.mesh_data`` / ``cfg.mesh_model`` or the explicit
    ``data`` / ``model``; ``data = -1`` means "all remaining ranks".  The
    world is the joined process group (its groups are built), or
    ``world_size`` / ``rank`` given without one (a layout only)."""
    n, me = _world(world_size, rank)
    nd = data if data is not None else (cfg.mesh_data if cfg else -1)
    nm = model if model is not None else (cfg.mesh_model if cfg else 1)
    if nd == -1:
        nd = n // nm
    if nd < 1 or nm < 1 or nd * nm > n:
        raise ValueError(f"a mesh of data={nd} x model={nm} needs {max(nd, 1) * max(nm, 1)} "
                         f"ranks; the process group has {n} (num_processes)")
    if nd * nm < n:
        # loud, like make_hybrid_mesh: a non-dividing mesh_model silently
        # idling ranks is invisible on divisible test meshes
        print(f"make_mesh: using {nd * nm} of {n} ranks ({n - nd * nm} idle — data={nd} x "
              f"model={nm} does not cover the process group)", file=sys.stderr, flush=True)
    return Mesh(np.arange(nd * nm).reshape(nd, nm), me, groups=world_size is None and n > 1)


def group_by_host(hostnames: Optional[Sequence[str]] = None,
                  local_world_size: Optional[int] = None, world_size: Optional[int] = None) -> list:
    """The world's ranks grouped by host, in host order of first rank, rank
    order within a host.  The host of each rank comes from ``hostnames`` (one
    per rank), else from ``local_world_size`` (``LOCAL_WORLD_SIZE``, which
    launchers set: consecutive ranks share a host), else from every rank's
    host name, gathered over the joined process group (one group without
    one)."""
    n = world_size if world_size is not None else _world(None, None)[0]
    if hostnames is None:
        local = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
        if local:
            return [list(range(i, min(i + local, n))) for i in range(0, n, local)]
        if n == 1:
            return [[0]]
        import socket

        import torch.distributed as dist

        hostnames = [None] * n
        dist.all_gather_object(hostnames, socket.gethostname())
    groups: dict = {}
    for r, h in enumerate(hostnames):
        groups.setdefault(h, []).append(r)
    return list(groups.values())


def hybrid_layout(slices: Sequence[Sequence[int]], model: int = 1,
                  data: Optional[int] = None, main: bool = True) -> np.ndarray:
    """The [data, model] rank grid of :func:`make_hybrid_mesh`: every host
    (``slices``: one list of ranks a host) gives the same number of rows of
    ``model`` ranks, the model axis within a host.  Hosts contribute
    ``min(len(slice)) // model`` rows each, or ``data // n_hosts`` when the
    total ``data`` width is given; ranks beyond that are left out with a
    warning, and an implicit layout that would idle half the ranks or more
    is refused."""
    smallest = min(len(s) for s in slices)
    if data is not None:
        if data % len(slices):
            raise ValueError(f"data={data} must divide over {len(slices)} hosts")
        rows = data // len(slices)
        if rows * model > smallest:
            raise ValueError(f"data={data} x model={model} needs {rows * model} ranks a host; "
                             f"the smallest host has {smallest}")
    else:
        rows = smallest // model
    per = rows * model
    if per < model or rows < 1:
        raise ValueError(f"each host must hold >= model={model} ranks (smallest: {smallest})")
    total = sum(len(s) for s in slices)
    dropped = total - per * len(slices)
    if dropped:
        msg = (f"hybrid mesh uses {per} ranks per host; {dropped}/{total} rank(s) left out of "
               "the mesh")
        # an explicit data width asks for a smaller mesh (warn only); an
        # implicit one dropping half the ranks means the hosts do not fit the
        # layout at all
        if data is None and dropped * 2 >= total:
            raise ValueError(msg + " — over half the ranks would sit idle; fix "
                             "mesh_data/mesh_model to match the hosts")
        import warnings

        warnings.warn(msg)
        if main:
            print(f"WARNING: {msg}", file=sys.stderr, flush=True)
    return np.concatenate([np.asarray(s[:per], np.int64).reshape(rows, model) for s in slices])


def make_hybrid_mesh(slices: Optional[Sequence[Sequence[int]]] = None, model: int = 1,
                     data: Optional[int] = None) -> Mesh:
    """(data, model) mesh over several hosts (:func:`hybrid_layout`), its
    groups built over the joined process group.  ``slices`` defaults to
    :func:`group_by_host`."""
    n, me = _world(None, None)
    if slices is None:
        slices = group_by_host()
    return Mesh(hybrid_layout(slices, model, data, main=me == 0), me, groups=n > 1)


def candidate_range(Cp: int, n: int, index: int) -> tuple:
    """The [lo, hi) candidates of model index ``index`` when ``n`` ranks
    split ``Cp`` candidates in contiguous blocks (``n`` must divide ``Cp``)."""
    if Cp % n:
        raise ValueError(f"{Cp} candidates do not split over {n} ranks; pad them first "
                         "(padded_candidate_count)")
    per = Cp // n
    return index * per, (index + 1) * per


class CandidateSplit(NamedTuple):
    """A rank's block of the candidate dim on the model axis: its model
    ``group``, its model ``index``, the axis width ``n`` and the group ranks
    in model-index ``order``."""

    group: object
    index: int
    n: int
    order: list

    def divides(self, Cp: int) -> bool:
        return Cp % self.n == 0

    def bounds(self, Cp: int) -> tuple:
        """This rank's [lo, hi) of ``Cp`` candidates."""
        return candidate_range(Cp, self.n, self.index)

    def check_block(self, Cb: int, C: int):
        """Assert that blocks of ``Cb`` candidates are a split of a model's
        ``C`` padded to the axis (or of a request's C that the axis
        divides), as DRIN's forward asserts."""
        assert Cb * self.n <= padded_candidate_count(C, self.n), (
            f"candidate blocks of {Cb} over {self.n} ranks are not a split of C={C} padded to "
            "the model axis")


def slice_candidates(batch, batch_fields: Sequence[str], split: Optional[CandidateSplit]):
    """This rank's candidates of a host batch: ``batch_specs``' rule of the
    JAX package as a slice.  The entity tensors of ndim >= 3 and the [B, C]
    similarities (DRIN's edges) keep this rank's block of dim 1; the answer
    stays whole (the loss sees every candidate).  Dim 1 is, by model:

      * DRIN: C of every ``entity_*`` tensor and of the similarities;
      * offline GHMFC: C of ``entity_feature`` ([B, C, 2, D] pooled,
        [B, C, Le, D] token level, [B, C, D] WikiDiverse), of a token-level
        ``entity_mask`` [B, C, Le] and of ``entity_image`` [B, C, Dr];
      * MELHI: C of ``entity_feature`` and ``entity_image``;
      * online GHMFC in direct mode: C of ``entity_ids`` / ``entity_mask``
        [B, C, Le];
      * online GHMFC in zipped mode: S, the zipped sentences, of
        ``entity_ids`` / ``entity_mask`` [B, S, L] and ``entity_sep_idx``
        [B, S, E].

    A placeholder of ndim < 3 (the [B] ``entity_mask`` of a pooled store,
    direct mode's [B] ``entity_sep_idx``, the online batch's [B]
    ``entity_image``) passes through whole; a [B, C, 1] image placeholder is
    sliced like the tensor it stands for.  A rows batch (``entity_rows``)
    stays whole: the store's gather takes the block of its rows and of its
    similarities.  Without a split the batch as it is; the split must
    divide dim 1 (pad C first, :func:`pad_candidates_to`)."""
    if split is None or "entity_rows" in batch_fields:
        return batch
    out = []
    for name, x in zip(batch_fields, batch):
        x = np.asarray(x)
        if (name.startswith("entity_") and x.ndim >= 3) or name.endswith("_similarity"):
            lo, hi = split.bounds(x.shape[1])
            x = x[:, lo:hi]
        out.append(x)
    return tuple(out) if type(batch) is tuple else type(batch)(*out)


def padded_candidate_count(C: int, nm: int) -> int:
    """Smallest multiple of the model-axis size >= C (C itself when it
    already divides)."""
    return ((C + nm - 1) // nm) * nm


def pad_candidates_to(batch, batch_fields: Sequence[str], c_from: int, c_to: int):
    """Pad the candidate dim (axis 1) of every candidate-carrying field from
    ``c_from`` to ``c_to`` with zeros (row indices pad with 0, a valid row;
    the models mask the padded candidates and slice the scores back to C).
    Fields may be numpy arrays or tensors; a tensor pads on its device."""
    if c_to == c_from:
        return batch
    out = []
    for name, x in zip(batch_fields, batch):
        x = x if torch.is_tensor(x) else np.asarray(x)
        if (name.startswith("entity_") or name.endswith("_similarity")) and x.ndim >= 2 \
                and x.shape[1] == c_from and name != "answer":
            shape = (x.shape[0], c_to - c_from) + tuple(x.shape[2:])
            x = (torch.cat([x, x.new_zeros(shape)], 1) if torch.is_tensor(x)
                 else np.concatenate([x, np.zeros(shape, x.dtype)], axis=1))
        out.append(x)
    return tuple(out) if type(batch) is tuple else type(batch)(*out)


def pad_batch_to(batch, n: int):
    """Pad every field's leading dim to ``n`` rows by repeating row 0 and
    return (padded_batch, valid_mask[n])."""
    b = len(batch[0])
    valid = np.zeros((n,), np.float32)
    valid[:b] = 1.0
    if b == n:
        return batch, valid
    out = []
    for x in batch:
        x = np.asarray(x)
        pad = np.broadcast_to(x[:1], (n - b,) + x.shape[1:])
        out.append(np.concatenate([x, pad], axis=0))
    return type(batch)(*out), valid
