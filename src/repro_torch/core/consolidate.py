"""Offline shard consolidation (port of ``repro/core/consolidate.py``; the
paper's §VII future work: "shard aggregation/consolidation to mitigate
PFS metadata pressure without sacrificing parallelism").

A checkpoint written at scale produces one ``.dsllm`` file per owning rank
(Fig 1(c,d)) — thousands of files per step on a large mesh, which hammers
the PFS metadata servers on restore. :func:`consolidate_step_dir` repacks a
step directory into ``ceil(n_ranks / group)`` aggregate files *after* the
checkpoint is persisted (background/maintenance path — never on the
training critical path). Restore needs no changes: the manager indexes
whatever ``.dsllm`` files exist by tensor name + shard region.

Its limits are the reference's. A chained (XOR delta) tensor is refused
(``FileReader.read_tensor``): its value needs the chain's base. A
self-contained encoded tensor (int8q) is decoded — on ``device``, the
dequantize kernel on a card — and written raw in fp32. The aggregate
carries no per-chunk digests (``FileWriter.write_at`` records none).
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np
import torch

from .layout import FileLayout, FileReader, FileWriter


def consolidate_step_dir(sdir: str, group: int = 8,
                         remove_originals: bool = True,
                         device: torch.device = "cuda") -> List[str]:
    """Merge per-rank ``rank*.dsllm`` files into aggregates of ``group``.

    Returns the list of aggregate paths written. Safe against partial
    failure: aggregates are written + fsynced before any original is
    removed; a crash in between leaves duplicates (restore tolerates them
    — identical shard regions resolve to the same bytes). ``device``
    decodes quantized tensors (the card unless the caller asks for the
    CPU); raw tensors never touch it.
    """
    ranks = sorted(p for p in glob.glob(os.path.join(sdir, "rank*.dsllm")))
    if not ranks:
        return []
    written: List[str] = []
    for gi in range(0, len(ranks), group):
        batch = ranks[gi:gi + group]
        out_path = os.path.join(sdir, f"agg{gi // group:05d}.dsllm")
        readers = [FileReader(p) for p in batch]
        specs = []
        for rd in readers:
            for name, e in rd.tensors.items():
                specs.append((name, e.nbytes, e.dtype, e.shape,
                              e.global_shape, e.index))
        layout = FileLayout.plan(specs)
        writer = FileWriter(out_path, layout)
        try:
            by_name = {t.name: t for t in layout.tensors}
            for rd in readers:
                for name in rd.tensors:
                    # the reader's array (a view of the mapped file for a
                    # raw tensor) is written as it is, not copied first
                    data = rd.read_tensor(name, device).reshape(-1)
                    writer.write_at(by_name[name].offset,
                                    data.view(np.uint8))
                for oname in rd.objects:
                    writer.append_object(oname, rd.read_object_raw(oname),
                                         codec=rd.objects[oname].codec)
            writer.set_meta("consolidated_from", [os.path.basename(p)
                                                  for p in batch])
            writer.finalize()
        except BaseException:
            writer.abort()
            if os.path.exists(out_path):
                os.remove(out_path)
            raise
        written.append(out_path)
    if remove_originals:
        for p in ranks:
            os.remove(p)
    return written


def file_count(sdir: str) -> int:
    return len(glob.glob(os.path.join(sdir, "*.dsllm")))
