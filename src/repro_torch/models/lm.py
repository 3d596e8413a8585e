"""Block-program transformer: one code path for the ten LM archs (the
reference's ``models/lm.py``, without the mesh).

``n_layers`` splits into ``n_super`` repetitions of a super-block (the
period of the layer / attention / MoE cycles: 1 for homogeneous stacks, 6
for gemma3's 5 local : 1 global, 8 for jamba's 1 attn : 7 mamba).  Params
keep the reference's stacked leaves (leading dim n_super), so a reference
tree converts leaf for leaf; the forward loops over super-blocks where the
reference scans.

Entry points:
  * ``train_loss``   full causal forward + chunked-head CE (logits never
                     materialized at (B, T, V)).
  * ``prefill``      forward returning (last-token logits, cache).
  * ``decode_step``  one token against the cache; a (B,) ``cache_len``
                     decodes each row at its own position (the serving
                     slots).

``mesh=`` and ``seq_shard_axis=`` (the sharded step and the
sequence-sharded decode) are ROADMAP item 6d: they raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ..tree import tree_map
from . import layers as L
from . import mlp as M
from . import moe as MoE
from . import ssm as S
from .attention import apply_rope, attention, decode_attention

__all__ = ["SlotSpec", "superblock_period", "slot_specs", "attn_init", "slot_init", "lm_init", "lm_param_shapes",
           "backbone", "embed_or_pass", "train_loss", "AttnCache", "init_cache", "prefill", "decode_step"]

Params = dict[str, Any]


def _no_mesh(mesh, seq_shard_axis=None) -> None:
    if mesh is not None or seq_shard_axis is not None:
        raise NotImplementedError("mesh= / seq_shard_axis= (the LM on a mesh) are not in the port yet: they are "
                                  "ROADMAP queue 1 item 6d")


# ----------------------------------------------------------- slot structure
@dataclasses.dataclass(frozen=True)
class SlotSpec:
    kind: str  # attn | mamba
    attn_kind: str = ""  # global | local (attn only)
    ffn: str = "none"  # mlp | moe | none


def superblock_period(cfg: LMConfig) -> int:
    p = len(cfg.layer_cycle)
    # the attention cycle advances only on attn layers: the global period
    n_attn_in_cycle = sum(1 for k in cfg.layer_cycle if k == "attn")
    if n_attn_in_cycle:
        p = p * _lcm(len(cfg.attn_cycle), n_attn_in_cycle) // n_attn_in_cycle
    if cfg.moe is not None:
        p = _lcm(p, cfg.moe.every)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.arch_id}: {cfg.n_layers} layers are not whole super-blocks of {p}")
    return p


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def slot_specs(cfg: LMConfig) -> list[SlotSpec]:
    period = superblock_period(cfg)
    kinds = cfg.layer_kinds()[:period]
    attn_kinds = cfg.attn_kinds()[:period]
    slots = []
    for i in range(period):
        if cfg.d_ff == 0:
            ffn = "none"
        elif cfg.moe is not None and (i % cfg.moe.every) == cfg.moe.every - 1:
            ffn = "moe"
        else:
            ffn = "mlp"
        slots.append(SlotSpec(kinds[i], attn_kinds[i], ffn))
    return slots


# ------------------------------------------------------------------- init
def _norm_init(cfg, d, device):
    return L.rmsnorm_init(d, device=device) if cfg.norm == "rmsnorm" else L.layernorm_init(d, device=device)


def _norm(cfg, p, x):
    return L.rmsnorm(p, x) if cfg.norm == "rmsnorm" else L.layernorm(p, x)


def attn_init(gen, cfg: LMConfig, dtype):
    hd = cfg.hd
    return {
        "wq": L.linear_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, bias=False),
        "wk": L.linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, bias=False),
        "wv": L.linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, bias=False),
        "wo": L.linear_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, bias=False),
    }


def slot_init(gen, cfg: LMConfig, spec: SlotSpec, dtype):
    dev = L._device(gen)
    p: Params = {"norm1": _norm_init(cfg, cfg.d_model, dev)}
    if spec.kind == "attn":
        p["attn"] = attn_init(gen, cfg, dtype)
    else:
        p["mamba"] = S.ssm_init(gen, cfg.d_model, cfg.ssm, dtype)
    if spec.ffn != "none":
        p["norm2"] = _norm_init(cfg, cfg.d_model, dev)
        if spec.ffn == "moe":
            p["moe"] = MoE.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe, cfg.mlp, dtype)
        else:
            p["mlp"] = M.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype)
    return p


def lm_init(cfg: LMConfig, *, seed: int = 0, device="cuda", dtype=torch.float32) -> Params:
    """Random LM params from ``seed``, drawn on ``device``, in the
    reference's layout: ``embed``, ``final_norm``, ``head`` (unless the
    embeddings are tied) and ``blocks/slot{i}/...`` with a leading n_super
    axis.  ``device="meta"`` gives the shapes only (nothing drawn)."""
    period = superblock_period(cfg)
    n_super = cfg.n_layers // period
    specs = slot_specs(cfg)
    gen = None if torch.device(device).type == "meta" else torch.Generator(device=device).manual_seed(seed)
    dev = L._device(gen)
    p: Params = {
        "embed": L.embedding_init(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": _norm_init(cfg, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = {"w": L.normal_init(gen, (cfg.d_model, cfg.vocab), 0.02, dtype)}
    blocks = [{f"slot{i}": slot_init(gen, cfg, specs[i], dtype) for i in range(period)} for _ in range(n_super)]
    p["blocks"] = tree_map(lambda *leaves: torch.stack(leaves), *blocks)
    return p


def lm_param_shapes(cfg: LMConfig) -> dict:
    """The param tree's leaf shapes (nested dicts of tuples), drawn on
    nothing."""
    return tree_map(lambda t: tuple(t.shape), lm_init(cfg, device="meta"))


# ---------------------------------------------------------------- forward
def _block_params(params: Params, s: int) -> Params:
    """Super-block ``s``'s params (views of the stacked leaves)."""
    return tree_map(lambda leaf: leaf[s], params["blocks"])


def _attn_forward(cfg: LMConfig, p, x, positions, attn_kind, q_chunk):
    B, T, D = x.shape
    hd = cfg.hd
    q = L.linear(p["wq"], x).reshape(B, T, cfg.n_heads, hd)
    k = L.linear(p["wk"], x).reshape(B, T, cfg.n_kv_heads, hd)
    v = L.linear(p["wv"], x).reshape(B, T, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    window = cfg.window if attn_kind == "local" else 0
    o = attention(q, k, v, causal=True, window=window, q_chunk=q_chunk, bf16_qk=cfg.attn_bf16_qk)
    return L.linear(p["wo"], o.reshape(B, T, cfg.n_heads * hd)), (k, v)


def _apply_ffn(cfg, spec: SlotSpec, p, x, per_row: bool = False):
    """The post-mixer FFN (dense or MoE); returns (x, aux).  ``per_row``:
    the MoE routes each batch row on its own (its capacity a row's), as the
    reference's decode does under its ``vmap`` over serving slots."""
    aux = x.new_zeros((), dtype=torch.float32)
    if spec.ffn == "none":
        return x, aux
    h2 = _norm(cfg, p["norm2"], x)
    if spec.ffn == "moe":
        if per_row:
            y = torch.cat([MoE.moe_apply(p["moe"], h2[b : b + 1], cfg.moe, cfg.mlp)[0] for b in range(x.shape[0])])
        else:
            y, aux = MoE.moe_apply(p["moe"], h2, cfg.moe, cfg.mlp)
        x = x + y
    else:
        x = x + M.mlp_apply(p["mlp"], h2, cfg.mlp)
    return x, aux


def _slot_forward(cfg, spec: SlotSpec, p, x, positions, q_chunk):
    """Returns (x, kv-or-None, aux_loss)."""
    h = _norm(cfg, p["norm1"], x)
    kv = None
    if spec.kind == "attn":
        a, kv = _attn_forward(cfg, p["attn"], h, positions, spec.attn_kind, q_chunk)
        x = x + a
    else:
        x = x + S.ssm_apply(p["mamba"], h, cfg.ssm, bf16_matmul=cfg.ssm_bf16)
    x, aux = _apply_ffn(cfg, spec, p, x)
    return x, kv, aux


def _run_blocks(params: Params, cfg: LMConfig, x, block):
    """``block(x, bp) -> (x, out)`` over the super-blocks in order, under
    activation checkpointing where ``cfg.remat`` and autograd ask for it
    (the reference's ``jax.checkpoint`` of the scan body).  Returns (x, the
    outs)."""
    n_super = cfg.n_layers // superblock_period(cfg)
    outs = []
    for s in range(n_super):
        bp = _block_params(params, s)
        if cfg.remat and torch.is_grad_enabled():
            x, out = checkpoint(block, x, bp, use_reentrant=False)
        else:
            x, out = block(x, bp)
        outs.append(out)
    return x, outs


def backbone(params: Params, cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor, *, q_chunk: int = 1024,
             collect_cache: bool = False, mesh=None):
    """The super-blocks over an embedded input x (B, T, D).  Returns
    (hidden, the kv of every attention slot stacked over super-blocks or
    None, aux)."""
    _no_mesh(mesh)
    specs = slot_specs(cfg)

    def block(x, bp):
        kvs, auxs = {}, x.new_zeros((), dtype=torch.float32)
        for i, spec in enumerate(specs):
            x, kv, aux = _slot_forward(cfg, spec, bp[f"slot{i}"], x, positions, q_chunk)
            auxs = auxs + aux
            if collect_cache and kv is not None:
                kvs[f"slot{i}"] = kv
        return x, (kvs, auxs)

    x, outs = _run_blocks(params, cfg, x, block)
    aux = torch.stack([a for _, a in outs]).sum()
    if not collect_cache:
        return x, None, aux
    kvs = {k: tuple(torch.stack([o[0][k][j] for o in outs]) for j in range(2)) for k in outs[0][0]}
    return x, kvs, aux


def embed_or_pass(params, cfg: LMConfig, inp) -> torch.Tensor:
    if cfg.frontend == "stub_embeds":
        return inp  # (B, T, D) precomputed frame / patch embeddings
    return L.embedding(params["embed"], inp)


def _head_w(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T  # (D, V)
    return params["head"]["w"]


def _positions(batch, B: int, T: int, device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(T, device=device)[None, :].expand(B, T)


def train_loss(params: Params, cfg: LMConfig, batch: dict, *, q_chunk: int = 1024, loss_chunk: int = 512,
               aux_weight: float = 0.01, mesh=None) -> torch.Tensor:
    """Causal LM loss; the head and CE run per T-chunk so (B, T, V) logits
    never exist."""
    _no_mesh(mesh)
    inp = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B, T = inp.shape[0], inp.shape[1]
    x = embed_or_pass(params, cfg, inp)
    x, _, aux = backbone(params, cfg, x, _positions(batch, B, T, x.device), q_chunk=q_chunk)
    x = _norm(cfg, params["final_norm"], x)
    hw = _head_w(params, cfg)
    labels = batch["labels"]
    nchunk = max(1, T // loss_chunk)
    if T % nchunk:
        raise ValueError(f"T={T} does not split into {nchunk} loss chunks")
    c = T // nchunk
    total = x.new_zeros((), dtype=torch.float32)
    for j in range(nchunk):
        logits = (x[:, j * c : (j + 1) * c] @ hw).float()  # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, j * c : (j + 1) * c, None].long())[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (B * T) + aux_weight * aux


# ------------------------------------------------------------------ caches
class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, S, Hkv, hd): S = max_len (global) or window (local ring)
    v: torch.Tensor
    pos: torch.Tensor  # (B, S) stored absolute positions (-1 = empty)


def _stack_caches(per_block: list) -> dict:
    """Per-super-block cache dicts -> one dict of n_super-leading leaves."""
    out = {}
    for key, first in per_block[0].items():
        out[key] = type(first)(*(torch.stack([c[key][j] for c in per_block]) for j in range(len(first))))
    return out


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """The stacked (n_super-leading) cache: an ``AttnCache`` per attention
    slot (a window-sized ring for local layers), an ``SSMCache`` per mamba
    slot."""
    n_super = cfg.n_layers // superblock_period(cfg)
    hd = cfg.hd

    def one(spec: SlotSpec):
        if spec.kind == "attn":
            S_ = min(cfg.window, max_len) if (spec.attn_kind == "local" and cfg.window) else max_len
            kv = (batch, S_, cfg.n_kv_heads, hd)
            return AttnCache(k=torch.zeros(kv, dtype=dtype, device=device),
                             v=torch.zeros(kv, dtype=dtype, device=device),
                             pos=torch.full((batch, S_), -1, dtype=torch.int32, device=device))
        return S.ssm_cache_init(batch, cfg.d_model, cfg.ssm, dtype, device)

    return {f"slot{i}": type(c)(*(leaf.expand(n_super, *leaf.shape).clone() for leaf in c))
            for i, c in ((i, one(s)) for i, s in enumerate(slot_specs(cfg)))}


def prefill(params: Params, cfg: LMConfig, batch: dict, *, q_chunk: int = 1024, max_len: Optional[int] = None,
            mesh=None):
    """Full-sequence prefill.  Returns (last-token logits (B, V), cache);
    ``max_len`` is the cache's capacity for the decode (default T + 1)."""
    _no_mesh(mesh)
    inp = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B, T = inp.shape[0], inp.shape[1]
    max_len = max_len or T + 1
    if max_len <= T:
        raise ValueError(f"max_len {max_len} leaves the cache no headroom over the prompt's {T} tokens")
    specs = slot_specs(cfg)
    x = embed_or_pass(params, cfg, inp)
    dev = x.device
    positions = _positions(batch, B, T, dev)

    def block(x, bp):
        caches = {}
        for i, spec in enumerate(specs):
            p = bp[f"slot{i}"]
            if spec.kind == "attn":
                x, (k, v), _ = _slot_forward(cfg, spec, p, x, positions, q_chunk)
                if spec.attn_kind == "local" and cfg.window:
                    S_ = min(cfg.window, max_len)
                    keep = min(S_, T)
                    # the last `keep` tokens, at ring slots pos % S_
                    pos_np = torch.arange(T - keep, T, device=dev)
                    slots = pos_np % S_
                    kc = k.new_zeros((B, S_, *k.shape[2:]))
                    vc = torch.zeros_like(kc)
                    pc = torch.full((B, S_), -1, dtype=torch.int32, device=dev)
                    kc[:, slots] = k[:, -keep:]
                    vc[:, slots] = v[:, -keep:]
                    pc[:, slots] = pos_np.to(torch.int32)[None].expand(B, keep)
                else:
                    pad = max_len - T
                    kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                    vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
                    pc = torch.nn.functional.pad(torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T),
                                                 (0, pad), value=-1)
                caches[f"slot{i}"] = AttnCache(kc, vc, pc)
            else:
                h = _norm(cfg, p["norm1"], x)
                y, sc = S.ssm_prefill(p["mamba"], h, cfg.ssm, bf16_matmul=cfg.ssm_bf16)
                x = x + y
                caches[f"slot{i}"] = sc
                x, _ = _apply_ffn(cfg, spec, p, x)
        return x, caches

    x, per_block = _run_blocks(params, cfg, x, block)
    x = _norm(cfg, params["final_norm"], x[:, -1:, :])
    logits = (x[:, 0, :] @ _head_w(params, cfg)).float()
    return logits, _stack_caches(per_block)


def decode_step(params: Params, cfg: LMConfig, cache, tokens: torch.Tensor, cache_len, *, mesh=None,
                seq_shard_axis: Optional[str] = None):
    """One new token for every sequence.  ``tokens`` (B, 1) ids, or (B, 1, D)
    embeds for stub frontends; ``cache_len`` the tokens already in the
    cache: an int or 0-d tensor for every row, or a (B,) tensor, each row at
    its own position (the serving slots; the MoE then routes each row on
    its own, as the reference's ``vmap`` does).  Returns (logits (B, V),
    the cache): the new rows and states are written into ``cache`` in
    place, so no leaf is copied a token (the reference returns a new tree;
    a caller that keeps the old cache passes a copy).  A conv-state leaf
    whose dtype differs from the new state's (a bf16 ``init_cache``) is
    replaced in ``cache`` once by its cast, as the reference's tree turns."""
    _no_mesh(mesh, seq_shard_axis)
    specs = slot_specs(cfg)
    B = tokens.shape[0]
    x = embed_or_pass(params, cfg, tokens)
    dev = x.device
    cl = torch.as_tensor(cache_len, device=dev).long()
    per_row = cl.dim() == 1
    cl_b = cl if per_row else cl.expand(B)  # (B,)
    pos = cl_b[:, None]
    if cfg.mrope_sections is not None:
        pos = pos[:, :, None].expand(B, 1, 3)
    rows = torch.arange(B, device=dev)
    hd = cfg.hd
    n_super = cfg.n_layers // superblock_period(cfg)
    for s in range(n_super):
        bp = _block_params(params, s)
        for i, spec in enumerate(specs):
            p = bp[f"slot{i}"]
            c = type(cache[f"slot{i}"])(*(leaf[s] for leaf in cache[f"slot{i}"]))
            h = _norm(cfg, p["norm1"], x)
            if spec.kind == "attn":
                q = L.linear(p["attn"]["wq"], h).reshape(B, 1, cfg.n_heads, hd)
                k1 = L.linear(p["attn"]["wk"], h).reshape(B, 1, cfg.n_kv_heads, hd)
                v1 = L.linear(p["attn"]["wv"], h).reshape(B, 1, cfg.n_kv_heads, hd)
                q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope_sections)
                k1 = apply_rope(k1, pos, cfg.rope_theta, cfg.mrope_sections)
                S_ = c.k.shape[1]
                slot = cl_b % S_ if (spec.attn_kind == "local" and cfg.window) else torch.clamp(cl_b, max=S_ - 1)
                c.k[rows, slot] = k1[:, 0].to(c.k.dtype)
                c.v[rows, slot] = v1[:, 0].to(c.v.dtype)
                c.pos[rows, slot] = cl_b.to(torch.int32)
                o = decode_attention(q, c.k, c.v, cl_b + 1, kv_positions=c.pos)
                wo = p["attn"]["wo"]
                # in the cache's dtype (v's): promoted to the weights' as JAX's bf16 @ f32 is
                o = o.reshape(B, 1, cfg.n_heads * hd).to(torch.promote_types(o.dtype, wo["w"].dtype))
                x = x + L.linear(wo, o)
            else:
                y, sc = S.ssm_decode_step(p["mamba"], h, c, cfg.ssm)
                x = x + y
                for field, new in zip(sc._fields, sc):
                    leaf = getattr(cache[f"slot{i}"], field)
                    if leaf.dtype != new.dtype:  # a bf16 conv state turns fp32, as the reference's new tree does
                        leaf = leaf.to(new.dtype)
                        cache[f"slot{i}"] = cache[f"slot{i}"]._replace(**{field: leaf})
                    leaf[s].copy_(new)
            x, _ = _apply_ffn(cfg, spec, p, x, per_row=per_row)
    x = _norm(cfg, params["final_norm"], x)
    logits = (x[:, 0, :] @ _head_w(params, cfg)).float()
    return logits, cache
