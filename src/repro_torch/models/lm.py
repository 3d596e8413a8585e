"""Block-program transformer: one code path for the ten LM archs (the
reference's ``models/lm.py``).

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

On a mesh (``mesh=``, a ``launch.mesh.Mesh``; one process a rank) a rank
passes its block of the batch (its rows under ``parallel.sharding.
lm_batch_specs``, and of the cache under ``cache_specs``) and the gathered
parameters, and gets back what the reference's function gives on the
global arrays: ``train_loss`` this rank's differentiable share of the loss
(its sum over the batch axes is the reference's loss) with the global loss
as a reading, ``prefill`` / ``decode_step`` its rows' logits and its cache
block.  The MoE then routes with the global batch's capacity, or by
all-to-all where ``cfg.moe_ep`` (``models/moe.py``); ``decode_step``'s
``seq_shard_axis`` splits the global attention caches' sequence over that
axis (``attention.seq_sharded_decode_attention``).  A batch that does not
divide the batch axes' extent is replicated (``lm_batch_specs``): every
rank takes all of it and nothing is summed over ranks; ``global_batch``
says which, and defaults to a split batch.  The model axis is storage only:
its ranks run the same rows.  The reference's activation placement hints
(``cfg.act_hints``) place values for its partitioner and change none; here
they have no effect.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ..tree import tree_map
from . import layers as L
from . import mlp as M
from . import moe as MoE
from . import ssm as S
from .attention import apply_rope, attention, decode_attention, seq_sharded_decode_attention

__all__ = ["SlotSpec", "superblock_period", "slot_specs", "attn_init", "slot_init", "lm_init", "lm_param_shapes",
           "backbone", "embed_or_pass", "train_loss", "AttnCache", "init_cache", "prefill", "decode_step"]

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class _Rows:
    """Where this rank's rows sit in the global batch on a mesh: ``split``
    over the batch ``axes`` (extent ``n`` > 1), or the whole batch on every
    rank (replicated, or a batch extent of 1)."""

    mesh: Any
    axes: tuple
    n: int
    split: bool


def _rows_on(mesh, rows: int, global_batch: Optional[int]) -> Optional[_Rows]:
    """The ``_Rows`` of a rank holding ``rows`` rows (None without a mesh);
    ``global_batch`` defaults to a split batch."""
    if mesh is None:
        return None
    if "model" not in mesh.axis_names:
        raise ValueError(f"an LM mesh needs a 'model' axis (extent 1 will do); this one has {mesh.axis_names}")
    axes = MoE.batch_axes(mesh)
    n = mesh.extent(axes)
    gb = rows * n if global_batch is None else int(global_batch)
    split = gb % n == 0
    want = gb // n if split else gb
    if rows != want:
        raise ValueError(f"this rank holds {rows} rows; a global batch of {gb} over the batch axes {axes} ({n} ranks) "
                         f"gives each rank {want} ({'split' if split else 'replicated'})")
    return _Rows(mesh, axes, n, split and n > 1)


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


def _apply_ffn(cfg, spec: SlotSpec, p, x, per_row: bool = False, rows: Optional[_Rows] = None):
    """The post-mixer FFN (dense or MoE); returns (x, aux).  ``per_row``:
    the MoE routes each batch row on its own (its capacity a row's), as the
    reference's decode does under its ``vmap`` over serving slots.  On a
    mesh (``rows``) the MoE is ``moe_apply_ep`` where ``cfg.moe_ep`` (as the
    reference picks it), else the global batch's ``moe_apply``; aux is then
    this rank's share."""
    aux = x.new_zeros((), dtype=torch.float32)
    if spec.ffn == "none":
        return x, aux
    h2 = _norm(cfg, p["norm2"], x)
    if spec.ffn == "moe":
        if per_row:
            y = torch.cat([MoE.moe_apply(p["moe"], h2[b : b + 1], cfg.moe, cfg.mlp)[0] for b in range(x.shape[0])])
        elif cfg.moe_ep and rows is not None:
            if rows.n > 1 and not rows.split:
                raise ValueError("the expert-parallel MoE needs the batch split over the batch axes; this one is "
                                 "replicated")
            y, aux = MoE.moe_apply_ep(p["moe"], h2, cfg.moe, cfg.mlp, mesh=rows.mesh)
        else:
            y, aux = MoE.moe_apply(p["moe"], h2, cfg.moe, cfg.mlp, mesh=rows.mesh if rows and rows.split else None)
        x = x + y
    else:
        x = x + M.mlp_apply(p["mlp"], h2, cfg.mlp)
    return x, aux


def _slot_forward(cfg, spec: SlotSpec, p, x, positions, q_chunk, rows=None):
    """Returns (x, kv-or-None, aux_loss)."""
    h = _norm(cfg, p["norm1"], x)
    kv = None
    if spec.kind == "attn":
        a, kv = _attn_forward(cfg, p["attn"], h, positions, spec.attn_kind, q_chunk)
        x = x + a
    else:
        x = x + S.ssm_apply(p["mamba"], h, cfg.ssm, bf16_matmul=cfg.ssm_bf16)
    x, aux = _apply_ffn(cfg, spec, p, x, rows=rows)
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
             collect_cache: bool = False, mesh=None, global_batch: Optional[int] = None):
    """The super-blocks over an embedded input x (B, T, D).  Returns
    (hidden, the kv of every attention slot stacked over super-blocks or
    None, aux; on a mesh aux is this rank's share)."""
    return _backbone(params, cfg, x, positions, q_chunk, collect_cache, _rows_on(mesh, x.shape[0], global_batch))


def _backbone(params, cfg, x, positions, q_chunk, collect_cache, rows):
    specs = slot_specs(cfg)

    def block(x, bp):
        kvs, auxs = {}, x.new_zeros((), dtype=torch.float32)
        for i, spec in enumerate(specs):
            x, kv, aux = _slot_forward(cfg, spec, bp[f"slot{i}"], x, positions, q_chunk, rows)
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
               aux_weight: float = 0.01, mesh=None, global_batch: Optional[int] = None):
    """Causal LM loss; the head and CE run per T-chunk so (B, T, V) logits
    never exist.  On a mesh: ``(share, loss)``, this rank's differentiable
    share of the global loss (its sum over the batch axes is the loss, and
    the sum of its gradients the loss's) and the global loss, detached (one
    all-reduce of the shares)."""
    inp = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B, T = inp.shape[0], inp.shape[1]
    rows = _rows_on(mesh, B, global_batch)
    x = embed_or_pass(params, cfg, inp)
    x, _, aux = _backbone(params, cfg, x, _positions(batch, B, T, x.device), q_chunk, False, rows)
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
    n = rows.n if rows is not None and rows.split else 1
    loss = total / (n * B * T) + aux_weight * aux
    if rows is None:
        return loss
    glob = loss.detach().clone()
    if rows.split:
        dist.all_reduce(glob, group=rows.mesh.group(rows.axes))
    return loss, glob


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


def _model_specs(cfg: LMConfig, mesh):
    """The cache's ``cache_specs`` entries on the "model" axis alone (a
    rank's rows and sequence slice are its own already); None where the
    model axis has one rank."""
    if mesh is None or mesh.shape["model"] == 1:
        return None
    from ..configs.base import ShapeConfig
    from ..parallel import sharding as SH  # lazily: parallel imports the models

    specs = SH.cache_specs(cfg, ShapeConfig("cache", 1, 1, "decode"), mesh)
    keep = lambda sp: SH.P(*(e if e == "model" else None for e in sp))  # noqa: E731
    return {k: type(c)(*(keep(sp) for sp in c)) for k, c in specs.items()}


def prefill(params: Params, cfg: LMConfig, batch: dict, *, q_chunk: int = 1024, max_len: Optional[int] = None,
            mesh=None, global_batch: Optional[int] = None):
    """Full-sequence prefill.  Returns (last-token logits (B, V), cache);
    ``max_len`` is the cache's capacity for the decode (default T + 1).  On
    a mesh: this rank's rows' logits and its block of the cache under
    ``cache_specs`` (its rows; kv heads and SSM channels split over "model"
    where they divide)."""
    inp = batch["tokens"] if "tokens" in batch else batch["embeds"]
    B, T = inp.shape[0], inp.shape[1]
    rows = _rows_on(mesh, B, global_batch)
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
                x, (k, v), _ = _slot_forward(cfg, spec, p, x, positions, q_chunk, rows)
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
                x, _ = _apply_ffn(cfg, spec, p, x, rows=rows)
        return x, caches

    x, per_block = _run_blocks(params, cfg, x, block)
    x = _norm(cfg, params["final_norm"], x[:, -1:, :])
    logits = (x[:, 0, :] @ _head_w(params, cfg)).float()
    cache = _stack_caches(per_block)
    mspecs = _model_specs(cfg, mesh)
    if mspecs is not None:
        from ..parallel import sharding as SH

        cache = SH.map_specs(lambda t, sp: SH.block_of(t, sp, mesh), cache, mspecs)
    return logits, cache


def decode_step(params: Params, cfg: LMConfig, cache, tokens: torch.Tensor, cache_len, *, mesh=None,
                seq_shard_axis: Optional[str] = None, global_batch: Optional[int] = None):
    """One new token for every sequence.  ``tokens`` (B, 1) ids, or (B, 1, D)
    embeds for stub frontends; ``cache_len`` the tokens already in the
    cache: an int or 0-d tensor for every row, or a (B,) tensor, each row at
    its own position (the serving slots; the MoE then routes each row on
    its own, as the reference's ``vmap`` does).  Returns (logits (B, V),
    the cache): the new rows and states are written into ``cache`` in
    place, so no leaf is copied a token (the reference returns a new tree;
    a caller that keeps the old cache passes a copy).  A conv-state leaf
    whose dtype differs from the new state's (a bf16 ``init_cache``) is
    replaced in ``cache`` once by its cast, as the reference's tree turns.

    On a mesh ``cache`` is this rank's block under ``cache_specs`` (leaves
    split over "model" are gathered for the step and their blocks written
    back).  ``seq_shard_axis``: the global attention caches hold this
    rank's slice of the sequence (the local layers' rings are whole); the
    new token's K/V row is written by the rank whose slice holds its slot
    ``min(cache_len, S - 1)`` only, and the attention combines the slices
    (``seq_sharded_decode_attention``)."""
    specs = slot_specs(cfg)
    B = tokens.shape[0]
    rows_on = _rows_on(mesh, B, global_batch)
    if seq_shard_axis is not None:
        if mesh is None:
            raise ValueError("seq_shard_axis needs the mesh it names an axis of")
        if rows_on.split and seq_shard_axis in rows_on.axes:
            raise ValueError(f"the batch is split over {rows_on.axes}: its sequence cannot split over "
                             f"{seq_shard_axis!r} too")
    mspecs = _model_specs(cfg, mesh)
    held = cache
    if mspecs is not None:  # the model axis is storage only: gather the split leaves for the step
        from ..parallel import sharding as SH

        cache = SH.map_specs(lambda t, sp: SH.gather(t, sp, mesh), cache, mspecs)
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
                local = spec.attn_kind == "local" and cfg.window
                if seq_shard_axis is not None and not local:
                    # this rank holds positions [off, off + S_) of the sequence, S_ x its extent in all
                    off = mesh.index(seq_shard_axis) * S_
                    slot = torch.clamp(cl_b, max=S_ * mesh.shape[seq_shard_axis] - 1) - off
                    mine = (slot >= 0) & (slot < S_)  # the rows whose new entry lands in this slice
                    r, sl, k_new, v_new, p_new = rows[mine], slot[mine], k1[mine, 0], v1[mine, 0], cl_b[mine]
                else:
                    slot = cl_b % S_ if local else torch.clamp(cl_b, max=S_ - 1)
                    r, sl, k_new, v_new, p_new = rows, slot, k1[:, 0], v1[:, 0], cl_b
                c.k[r, sl] = k_new.to(c.k.dtype)
                c.v[r, sl] = v_new.to(c.v.dtype)
                c.pos[r, sl] = p_new.to(torch.int32)
                if seq_shard_axis is not None and not local:
                    o = seq_sharded_decode_attention(q, c.k, c.v, cl_b + 1, mesh=mesh, seq_axis=seq_shard_axis,
                                                     kv_positions=c.pos)
                else:
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
            x, _ = _apply_ffn(cfg, spec, p, x, per_row=per_row, rows=rows_on)
    x = _norm(cfg, params["final_norm"], x)
    logits = (x[:, 0, :] @ _head_w(params, cfg)).float()
    if mspecs is not None:  # this rank's blocks back into the cache it holds
        for key, c in cache.items():
            blocks = type(c)(*(SH.block_of(t, sp, mesh) for t, sp in zip(c, mspecs[key])))
            for field, blk in zip(c._fields, blocks):
                leaf = getattr(held[key], field)
                if leaf.dtype == blk.dtype:
                    leaf.copy_(blk)
                else:  # a bf16 conv state turned fp32
                    held[key] = held[key]._replace(**{field: blk})
        cache = held
    return logits, cache
