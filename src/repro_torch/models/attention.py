"""Attention: GQA with RoPE / M-RoPE, full or sliding-window, chunked over
queries for long sequences, and single-token decode against a KV cache
(ring buffers for windowed layers): the reference's ``models/attention.py``.

Plain PyTorch, as the reference's is plain ``jnp``: no TPU kernel sits
here, so no library attention replaces these functions.  Training and
prefill loop over query chunks, so the (q_chunk, T) score slab is the peak,
never (T, T); a local layer reads a (window + q_chunk) KV span per chunk.
``seq_sharded_decode_attention`` is the long-context decode with the KV
cache's sequence split over a mesh axis (one process a rank).  On a mesh
whose "model" axis splits the heads, ``models/lm.py`` calls these on a
rank's query heads and the kv heads they read (``parallel.tp.local_kv``):
the heads are independent, so each rank's slice is the whole function's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["NEG_INF", "rope_freqs", "apply_rope", "attention", "decode_attention", "seq_sharded_decode_attention"]

NEG_INF = -1e30


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(
    x: torch.Tensor,  # (B, T, H, hd)
    positions: torch.Tensor,  # (B, T) or (B, T, 3) for M-RoPE
    theta: float,
    mrope_sections: Optional[tuple[int, int, int]] = None,
) -> torch.Tensor:
    """Rotate the two halves of each head (not interleaved pairs) by the
    position's angles; M-RoPE splits the frequency slots into (t, h, w)
    sections, each rotated by its own position stream."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)  # (hd/2,)
    if mrope_sections is None:
        ang = positions.float()[..., None] * inv  # (B, T, hd/2)
    else:
        if positions.dim() != 3 or positions.shape[-1] != 3:
            raise ValueError(f"M-RoPE takes (B, T, 3) positions, got {tuple(positions.shape)}")
        if sum(mrope_sections) != hd // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} must sum to head_dim / 2 = {hd // 2}")
        parts, lo = [], 0
        for i, s in enumerate(mrope_sections):
            parts.append(positions[..., i : i + 1].float() * inv[lo : lo + s])
            lo += s
        ang = torch.cat(parts, dim=-1)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------- core math
def _sdpa(q, k, v, mask, scale, bf16_qk: bool = False):
    """q (B, Tq, H, hd), k / v (B, Tk, Hkv, hd), mask (B|1, 1, Tq, Tk)
    additive.  Query heads grouped over their shared kv head; the softmax in
    fp32.  ``bf16_qk``: QK^T on the operands in their own dtype (bf16 ones
    stay bf16) with the scale applied in that dtype, accumulated in fp32."""
    B, Tq, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qf = q.float() * scale
    kf = k.float()
    if bf16_qk:
        qf = (q * scale).to(q.dtype).float()
    qg = qf.reshape(B, Tq, Hkv, rep, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf)
    scores = scores + mask[:, :, None, :, :]  # (B|1, 1, 1, Tq, Tk) over g, r
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype), v)
    return out.reshape(B, Tq, H, hd)


def _mask(q_pos, kv_pos, causal: bool, window: int) -> torch.Tensor:
    """(1, 1, Tq, Tk) additive mask: 0 where a query sees a key."""
    mask = torch.zeros((1, 1, q_pos.shape[0], kv_pos.shape[0]), dtype=torch.float32, device=q_pos.device)
    qp, kp = q_pos[None, None, :, None], kv_pos[None, None, None, :]
    if causal:
        mask = torch.where(qp >= kp, 0.0, NEG_INF)
    if window:
        mask = torch.where(qp - kp < window, mask, NEG_INF)
    return mask


def attention(
    q: torch.Tensor,  # (B, T, H, hd), roped
    k: torch.Tensor,  # (B, T, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,  # 0 = full; else sliding window (causal)
    q_chunk: int = 1024,
    bf16_qk: bool = False,
) -> torch.Tensor:
    """Chunked exact attention: a loop over query chunks (the reference's
    ``lax.scan``); local layers read only a (window + q_chunk) KV span a
    chunk."""
    B, T, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    if T <= q_chunk:
        return _attend_block(q, k, v, 0, T, causal, window, scale, bf16_qk)
    Tp = -(-T // q_chunk) * q_chunk
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Tp - T)) if Tp != T else q
    outs = [_attend_chunk(qp[:, qi : qi + q_chunk], k, v, qi, causal, window, scale, q_chunk, bf16_qk)
            for qi in range(0, Tp, q_chunk)]
    return torch.cat(outs, dim=1)[:, :T]


def _attend_chunk(q_blk, k, v, q_start: int, causal, window, scale, q_chunk, bf16_qk=False):
    """One query chunk against the KV span it can see."""
    T = k.shape[1]
    dev = q_blk.device
    if window and window + q_chunk < T:
        span = window + q_chunk
        start = min(max(q_start - window, 0), T - span)  # the span [q_start - window, q_start + q_chunk)
        k_s, v_s = k[:, start : start + span], v[:, start : start + span]
        kv_pos = start + torch.arange(span, device=dev)
    else:
        k_s, v_s = k, v
        kv_pos = torch.arange(T, device=dev)
    q_pos = q_start + torch.arange(q_chunk, device=dev)
    return _sdpa(q_blk, k_s, v_s, _mask(q_pos, kv_pos, causal, window), scale, bf16_qk)


def _attend_block(q, k, v, q_start: int, Tq: int, causal, window, scale, bf16_qk=False):
    dev = q.device
    q_pos = q_start + torch.arange(Tq, device=dev)
    kv_pos = torch.arange(k.shape[1], device=dev)
    return _sdpa(q, k, v, _mask(q_pos, kv_pos, causal, window), scale, bf16_qk)


# ------------------------------------------------------------------ decode
def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd) roped at position cache_len
    k_cache: torch.Tensor,  # (B, S, Hkv, hd)
    v_cache: torch.Tensor,
    cache_len,  # tokens in the cache, the new one included: an int, a 0-d tensor, or (B,) one a row
    *,
    kv_positions: Optional[torch.Tensor] = None,  # (B, S) stored positions, for ring buffers
) -> torch.Tensor:
    """Single-token decode against a (possibly ring) KV cache.  A (B,)
    ``cache_len`` decodes each row at its own length (the reference's
    ``vmap`` over serving slots, as one batched call)."""
    B, S, Hkv, hd = k_cache.shape
    scale = 1.0 / math.sqrt(hd)
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = cl[:, None] if cl.dim() == 1 else cl
    if kv_positions is None:
        valid = torch.arange(S, device=q.device)[None, :] < cl
        valid = valid.expand(B, S)
    else:
        valid = (kv_positions >= 0) & (kv_positions < cl)
    mask = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]  # (B, 1, 1, S)
    return _sdpa(q, k_cache, v_cache, mask, scale)


def seq_sharded_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len, *, mesh,
                                 seq_axis: str = "data", kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token decode with the KV cache sequence-split over ``seq_axis``
    (the distributed flash-decode): ``k_cache`` / ``v_cache`` (B, S/n, Hkv,
    hd) are this rank's slice of the sequence, ``q`` (B, 1, H, hd) the same
    on every rank.  Each rank scores its slice; an ``all_reduce(MAX)`` of
    the row maxima and an ``all_reduce(SUM)`` of the rescaled denominators
    and weighted V give the exact softmax on every rank; no KV moves.
    Valid keys: ``kv_positions`` (this rank's (B, S/n) slice of the stored
    positions) in [0, cache_len), or without it the slice's own positions
    (offset by the rank's index over ``seq_axis``) below ``cache_len``.
    ``cache_len``: an int, a 0-d tensor or (B,) one a row."""
    B, S_l, Hkv, hd = k_cache.shape
    H = q.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = cl[:, None] if cl.dim() == 1 else cl
    if kv_positions is None:
        idx = mesh.index(seq_axis) * S_l + torch.arange(S_l, device=q.device)
        valid = (idx[None, :] < cl).expand(B, S_l)
    else:
        valid = (kv_positions >= 0) & (kv_positions < cl)
    qg = (q.float() * scale).reshape(B, 1, Hkv, rep, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache.float())
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m_loc = s.amax(-1)  # (B, g, r, 1)
    p = torch.exp(s - m_loc[..., None])
    l_loc = p.sum(-1)
    o_loc = torch.einsum("bgrqk,bkgd->bgrqd", p, v_cache.float())
    group = mesh.group(seq_axis)
    m_glob = m_loc.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m_loc - m_glob)
    # one collective for the denominators and the weighted V
    both = torch.cat([(l_loc * corr)[..., None], o_loc * corr[..., None]], dim=-1)
    dist.all_reduce(both, group=group)
    out = both[..., 1:] / both[..., :1]
    return out.reshape(B, 1, H, hd).to(q.dtype)
