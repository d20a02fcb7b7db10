"""Entry-window feature fetch for DyGFormer (CUDA, ``csrc/window_fetch.cu``).

For each row m and sequence position l, with the entry-ordered packed
table ``table`` (rows, dn + de) of ``graph/csr.py`` (``feat_entry``):

    row(m, l) = table[tgt_rows[m]]              l == 0 (the target's row)
                table[starts[m] + l - 1]        1 <= l <= counts[m]
                zeros                           otherwise
    node (M, L, dn) = row[..., :dn],  edge (M, L, de) = row[..., dn:]

Replaces ``dyglib_tpu/ops/pallas/window_fetch.py::fetch_sequence_features``
(``_kernel``). The JAX kernel returns one packed (M, L, S * 128) tensor
from a 128-lane slab layout, a Mosaic DMA workaround, and projects it
against zero-scattered packed weights. The port writes the node and edge
columns as two contiguous outputs instead: exactly the tensors the gather
path (``tables.node[seq_ids]``, ``tables.edge[seq_eids]``) builds, bitwise,
so the rest of the network is the gather path's and no projection pays for
zero weights. No gradient: the feature tables are never trained (the JAX
kernel has no VJP either).

Bound on one H100 at the CanParl training shapes (M = 600, L = 2048,
dn = de = 172): 1.69 GB written, plus the valid rows read once, against
3.35 TB/s -> ~0.5 ms. At wikipedia (L = 32): 26 MB -> ~8 us.

What the simple design leaves on the table: the output is written to
device memory and read back by the two projections; fusing the fetch into
the patch-projection kernel's A loader would remove those 1.69 GB.
"""
from __future__ import annotations

import torch

from . import _build

_NAME = "window_fetch"
_ARGTYPES = [_build.P] * 6 + [_build.I] * 4 + [_build.P]


def window_rows(tgt_rows, starts, counts, seq_len: int) -> torch.Tensor:
    """(M, seq_len) int64 table row of every position; positions with no
    row read guard row 0, which is zero."""
    l = torch.arange(seq_len, device=starts.device)
    win = torch.where(l[None, :] - 1 < counts[:, None], starts[:, None] + l[None, :] - 1, 0)
    return torch.where(l[None, :] == 0, tgt_rows[:, None], win).long()


def fetch_sequence_features_plain(
    table: torch.Tensor,
    tgt_rows: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    seq_len: int,
    node_dim: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one row gather, pads redirected to the zero
    guard row, then the node and edge columns as contiguous tensors."""
    rows = table[window_rows(tgt_rows, starts, counts, seq_len)]
    return rows[..., :node_dim].contiguous(), rows[..., node_dim:].contiguous()


def fetch_sequence_features(
    table: torch.Tensor,
    tgt_rows: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    seq_len: int,
    node_dim: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """table (T, dn + de) f32; tgt_rows, starts, counts (M,) int32 absolute
    table rows (guard offset applied) -> node (M, seq_len, dn), edge
    (M, seq_len, de) f32.

    Callers keep every row read inside the table (``DyGFormer.sample``:
    windows of at most the guard pad's length). CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if table.device.type == "cpu":
        return fetch_sequence_features_plain(table, tgt_rows, starts, counts, seq_len, node_dim)
    if table.device.type != "cuda":
        raise ValueError(f"fetch_sequence_features: unsupported device {table.device}")
    t_rows, width = table.shape
    m = starts.shape[0]
    dn, de, dev = node_dim, width - node_dim, table.device
    if not 0 <= dn <= width:
        raise ValueError(f"node_dim {dn} outside the table width {width}")
    _build.require(table, "table", torch.float32, (t_rows, width), dev)
    for t, name in ((tgt_rows, "tgt_rows"), (starts, "starts"), (counts, "counts")):
        _build.require(t, name, torch.int32, (m,), dev)
    if table.data_ptr() % 16:
        raise ValueError("table must start on a 16-byte boundary")
    node = torch.empty((m, seq_len, dn), dtype=torch.float32, device=dev)
    edge = torch.empty((m, seq_len, de), dtype=torch.float32, device=dev)
    lib = _build.load(_NAME, "window_fetch_forward", _ARGTYPES)
    rc = lib.window_fetch_forward(
        table.data_ptr(), tgt_rows.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        node.data_ptr(), edge.data_ptr(), m, seq_len, dn, de,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    fetch_sequence_features.launches += 1
    return node, edge


fetch_sequence_features.launches = 0
