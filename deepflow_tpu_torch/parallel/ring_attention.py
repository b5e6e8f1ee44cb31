"""Ring attention: sequence (context) parallelism over a mesh axis.

Port of ``deepflow_tpu/parallel/ring_attention.py``. The sequence is cut
over the axis's ranks; the UNREPEATED K/V blocks rotate around the ring
(``collectives.ppermute``, one ``batch_isend_irecv`` a rotation, whose
backward rotates the gradients back) while each rank accumulates its
queries' attention with an online (flash-style) softmax. Memory per rank
is O(S/n * S/n) per block instead of O(S^2).

The numerics are ``_ring_attn_local``'s: scores in float32 from float32
queries and K/V blocks, times ``scale = 1/sqrt(head_dim)`` as a Python
float; the causal mask at global positions puts ``-inf``, guarded by
``isinf`` in the shift and the correction; the normaliser is clamped at
1e-30. They differ from the dense attention of ``models/llama.py``, whose
scores are bf16 and divided in float32, and neither is
``scaled_dot_product_attention``. The reference's loop rotates the
blocks after each of its n steps, the last rotation's blocks unused; the
port rotates n - 1 times, the same numbers.
"""

from __future__ import annotations

import torch

from deepflow_tpu_torch.parallel.collectives import Axis, ppermute


def ring_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               axis: Axis, causal: bool = True) -> torch.Tensor:
    """This rank's body: q (B, Sq, H, hd) is its block of queries, k/v
    (B, Sk, KV, hd) its block of keys and values with H == KV * n_rep
    (GQA); heads expand locally at each step."""
    n, my = axis.size, axis.index
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    n_rep = H // KV
    scale = 1.0 / (hd ** 0.5)
    q32 = q.float()
    m = torch.full((B, H, Sq), -torch.inf, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, Sq, H, hd), device=q.device)
    zero = torch.zeros((), device=q.device)
    q_pos = my * Sq + torch.arange(Sq, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        src = (my - s) % n  # ring position the current k/v block came from
        k_rep = k_cur.repeat_interleave(n_rep, 2) if n_rep > 1 else k_cur
        v_rep = v_cur.repeat_interleave(n_rep, 2) if n_rep > 1 else v_cur
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_rep.float()) * scale
        if causal:
            k_pos = src * Sk + torch.arange(Sk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask[None, None], scores, -torch.inf)
        blk_max = scores.amax(-1)
        m_new = torch.maximum(m, blk_max)
        # fully-masked rows keep m == -inf; guard the exp shift
        shift = torch.where(torch.isinf(m_new), zero, m_new)
        p = torch.where(torch.isinf(scores), zero,
                        torch.exp(scores - shift[..., None]))
        corr = torch.where(torch.isinf(m), zero, torch.exp(m - shift))
        l = l * corr + p.sum(-1)
        acc = (acc * corr.transpose(1, 2)[..., None]
               + torch.einsum("bhqk,bkhd->bqhd", p, v_rep.float()))
        m = m_new
        if s < n - 1:
            k_cur, v_cur = ppermute(axis, k_cur, v_cur)
    l = l.clamp_min(1e-30)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "data", causal: bool = True
                   ) -> torch.Tensor:
    """Sequence-parallel attention over the mesh axis ``axis``.

    q: (B, S/n, H, hd), k/v: (B, S/n, KV, hd): this rank's block of the
    sequence (rank i holds positions [i * S/n, (i + 1) * S/n)), H a
    multiple of KV (GQA). Returns this rank's block of the output."""
    return ring_local(q, k, v, Axis.of(mesh, axis), causal=causal)
