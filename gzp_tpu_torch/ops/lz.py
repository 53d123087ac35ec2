"""LZ77 helpers shared by the match stage, and the parallel greedy parse.

Counterpart of ``gzp_tpu/ops/lz.py``: the hash constant and key width used
by the match kernels (``ops/lz_cuda.py``), and :func:`parse_marks_scan`,
the windowless greedy parse by δ-state function composition, in plain
PyTorch on any device.
"""

from __future__ import annotations

import torch

HASH_MUL = 0x9E3779B1  # Fibonacci hashing constant


def _pos_bits(n: int) -> int:
    """Bits needed to index ``n`` positions (the sort key packs
    ``hash << pos_bits | pos`` into 32 bits; bigger blocks get fewer hash
    bits)."""
    return max((n - 1).bit_length(), 1)


def parse_marks_scan(
    match_len: torch.Tensor,
    lengths: torch.Tensor,
    *,
    min_emit: int,
    base: int = 0,
    max_step: int = 255,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowless greedy parse via δ-state function composition.

    The greedy walk ``next(i) = i + max(1, l_i)`` carries one scalar of
    state past position ``i``: δ = (next visited position) − i, with
    δ ∈ [0, max_step]. Each position is the map ``f_i(δ) = (δ == 0 ?
    step_i : δ) − 1``; a contiguous range is the composition of its maps,
    which for a range of length L is a table over entry-δ < L (≥ L passes
    through as δ − L). Tables cap at 256 entries because steps are capped
    at ``max_step`` = 255 (matches ≥ 256 emit 255 and re-match).

    Upward pass: log2(N) levels of pairwise table composition, each an
    integer gather of the right child's table at the left child's exits.
    Downward pass: evaluate each node's entry-δ from the root (δ = 0); a
    leaf with entry-δ 0 is a token start. (The TPU original applies the
    tables as one-hot matmuls for its matrix unit; a gather is exact.)

    ``match_len`` [B, M] int32, ``lengths`` [B] -> ``(marked [B, M] bool,
    l [B, M] int32)``: token starts and the match length each uses.
    """
    b, m_in = match_len.shape
    dev = match_len.device
    w = max_step + 1  # δ-domain size (256)
    # pad to a power of two >= w so every level's tables are regular
    m = max(w, 1 << (m_in - 1).bit_length())
    ml = torch.zeros((b, m), dtype=torch.int64, device=dev)
    ml[:, :m_in] = match_len

    i_idx = torch.arange(m, device=dev)[None, :]
    end = base + lengths.to(torch.int64)[:, None]
    l = torch.clamp(ml, max=max_step)
    l = torch.minimum(l, torch.clamp(end - i_idx, min=0))
    l = torch.where(l >= min_emit, l, 0)
    step = torch.where(l > 0, l, 1)

    # leaf tables: width 1 (only entry δ = 0 is not a pass-through)
    t = (step - 1)[:, :, None]  # [B, M, 1]
    seg = 1
    ups = []
    while t.shape[1] > 1:
        f, g = t[:, 0::2], t[:, 1::2]
        ups.append((t, seg))
        wf, wg = f.shape[-1], g.shape[-1]
        wp = min(2 * seg, w)
        # f's exit v < wg enters g's table, else passes g as v - seg
        out = torch.where(
            f < wg, torch.gather(g, 2, torch.clamp(f, max=wg - 1)), f - seg
        )
        if wp > wf:
            # entries δ ∈ [seg, wp) skip f: they enter g at δ - seg < wg
            out = torch.cat([out, g[:, :, : wp - wf]], dim=2)
        else:
            out = out[..., :wp]
        t = out
        seg *= 2

    # downward: entry-δ per node; the root enters with δ = 0
    entry = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    for t_lvl, seg_l in reversed(ups):
        f = t_lvl[:, 0::2]  # [B, P, wf]
        wf = f.shape[-1]
        # left child entry = parent entry; right child entry = f_left(entry)
        fe = torch.gather(f, 2, torch.clamp(entry, max=wf - 1)[:, :, None])[:, :, 0]
        right = torch.where(entry < wf, fe, entry - seg_l)
        entry = torch.stack([entry, right], dim=2).reshape(b, -1)

    valid = (i_idx >= base) & (i_idx < end)
    marked = (entry == 0) & valid
    return marked[:, :m_in], l[:, :m_in].to(torch.int32)
