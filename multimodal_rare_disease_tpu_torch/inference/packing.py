"""Sequence packing for batched text inference (numpy only).

The same algorithm as `multimodal_rare_disease_tpu/inference/packing.py`,
kept as the port's own copy because that package's `inference/__init__`
imports its jax predictor; tests/test_torch_predictor.py pins the two
equal. Several short documents share one row of `capacity` tokens: a
block-diagonal mask built from `segment_ids` keeps documents apart,
`position_ids` restart at each document, and `query_positions` are the
CLS positions the final BERT layer computes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class PackedBatch:
    """N documents packed into R rows of `capacity` tokens.
    `doc_row[i]`/`doc_slot[i]` locate document i's output in the
    encoder's [R, P, H] per-document embeddings."""

    input_ids: np.ndarray       # [R, capacity] int32
    position_ids: np.ndarray    # [R, capacity] int32 (restart per doc)
    segment_ids: np.ndarray     # [R, capacity] int32 (0 pad, 1.. = doc)
    query_positions: np.ndarray  # [R, P] int32 (doc start offsets)
    doc_row: np.ndarray         # [N] int32
    doc_slot: np.ndarray        # [N] int32
    capacity: int

    @property
    def num_rows(self) -> int:
        return self.input_ids.shape[0]


def pack_texts(ids: np.ndarray, mask: np.ndarray, capacity: int = 256,
               row_multiple: int = 8) -> PackedBatch:
    """First-fit-decreasing bin packing of N tokenized documents.
    ids/mask: [N, T] right-padded; capacity a multiple of 128 and at
    least the longest document; rows padded to a multiple of
    `row_multiple` with empty rows."""
    n = ids.shape[0]
    lens = mask.astype(bool).sum(axis=1).astype(int)
    if capacity % 128 != 0:
        raise ValueError(f"capacity {capacity} must be a multiple of 128")
    if lens.max(initial=0) > capacity:
        raise ValueError(f"document of {lens.max()} tokens exceeds "
                         f"capacity {capacity}")

    order = np.argsort(-lens, kind="stable")
    rows: list[list[int]] = []
    row_used: list[int] = []
    for i in order:
        li = int(lens[i])
        for r, used in enumerate(row_used):
            if used + li <= capacity:
                rows[r].append(int(i))
                row_used[r] += li
                break
        else:
            rows.append([int(i)])
            row_used.append(li)

    n_rows = -(-len(rows) // row_multiple) * row_multiple
    p = max(len(r) for r in rows)
    out_ids = np.zeros((n_rows, capacity), np.int32)
    pos = np.zeros((n_rows, capacity), np.int32)
    seg = np.zeros((n_rows, capacity), np.int32)
    qpos = np.zeros((n_rows, p), np.int32)
    doc_row = np.zeros(n, np.int32)
    doc_slot = np.zeros(n, np.int32)
    for r, docs in enumerate(rows):
        off = 0
        for slot, i in enumerate(docs):
            li = int(lens[i])
            out_ids[r, off:off + li] = ids[i, :li]
            pos[r, off:off + li] = np.arange(li)
            seg[r, off:off + li] = slot + 1
            qpos[r, slot] = off
            doc_row[i] = r
            doc_slot[i] = slot
            off += li
    return PackedBatch(out_ids, pos, seg, qpos, doc_row, doc_slot, capacity)


def packing_wins(lens: Sequence[int], bucket: int,
                 capacity: int = 256) -> bool:
    """Pack only when the packed token rows beat the classic bucket by
    ~15% (attention's quadratic term grows with capacity)."""
    lens = np.asarray(lens)
    longest = int(lens.max())
    sim = pack_texts(np.zeros((len(lens), longest), np.int32),
                     (np.arange(longest)[None, :]
                      < lens[:, None]).astype(np.int32),
                     capacity)
    return sim.num_rows * capacity < 0.85 * len(lens) * bucket
