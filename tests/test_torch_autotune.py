"""Port parity of ``kernels/autotune.py`` and the generator's block table
(``models/gan.py``: DECONV_BLOCKS, set_deconv_blocks, clear_deconv_blocks,
install_tuned_blocks), on the CPU: the wrappers check every requested
instantiation and split against ``engine.INSTANTIATIONS`` and then take
their plain versions, so the sweeps here run the machinery, not the card.

* the reference's three tests of this module, in the port's terms
  (tests/test_kernels_conv.py::test_autotune_conv_sweeps_epilogue_axes,
  tests/test_kernels_epilogue.py::test_deconv_block_overrides_preserve_numerics
  and ::test_install_tuned_blocks_wires_bwd_blocks);
* the timed functions of the three families (deconv, conv, 1D deconv and
  causal conv1d) in modes fwd / grad / step, at ``cfg=None`` and at a Hopper
  configuration, against JAX's ``make_timed_*_fn(None, ...)`` on the same
  ``default_rng(seed)`` inputs (in grad mode also the input's gradient,
  which JAX's timed function drops, through its forward): forward atol
  5e-5 / rtol 1e-4 (the engines'),
  loss rtol 1e-4, gradients and first moments 1e-4 of their largest + 1e-5,
  parameters after one AdamW step 6 * lr;
* the table read at the reference's three call sites and nowhere else;
* infeasible requests as ok=False rows, ``best_config`` with no row that
  ran, a bad mode, what ``mesh=`` / ``grad_compression=`` refuse (the
  sweep on a mesh runs in tests/test_torch_parallel.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tdc import DeconvDims as JDeconvDims
from repro.core.tdc import conv_same_dims as jconv_same_dims
from repro.kernels import autotune as JA
from repro_torch.configs import DCGAN
from repro_torch.configs.base import DeconvSpec, GANConfig
from repro_torch.configs.gan_zoo import tiny_dcgan
from repro_torch.core.tdc import DeconvDims, conv_same_dims
from repro_torch.kernels import autotune as A
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops
from repro_torch.models import gan as G

K4S2, K3S1, K5S2 = DeconvDims(4, 2, 1, 0), DeconvDims(3, 1, 1, 0), DeconvDims(5, 2, 2, 1)
LR = 1e-3  # the timed step's AdamW rate


@pytest.fixture(autouse=True)
def _empty_table():
    G.clear_deconv_blocks()
    yield
    G.clear_deconv_blocks()


def _mini_chain_cfg(impl: str, conv_impl: str = "lax") -> GANConfig:
    """The reference test's 3-layer generator: an aligned K4S2 chain and the
    misaligned K4S2 -> K3S1 hop."""
    return GANConfig(arch_id="mini-chain", z_dim=8, seed_hw=4, stem_ch=8,
                     deconvs=(DeconvSpec(8, 8, K4S2), DeconvSpec(8, 8, K4S2),
                              DeconvSpec(8, 3, K3S1, norm="none", act="tanh")),
                     img_hw=16, deconv_impl=impl, conv_impl=conv_impl)


# ------------------------------------------------------------ the reference's three
def test_autotune_conv_sweeps_epilogue_axes():
    """The conv autotuner times fused configs across the epilogue / chain
    output axes and a full AdamW step keeps the packed leaf updated."""
    cands = A.conv_candidates(conf=("mma_64x64",))
    assert any(c.epilogue == "leaky_relu" and c.emit_cells for c in cands)
    assert not any(c.emit_cells and c.epilogue is None for c in cands)  # chained emit rides an epilogue
    cd = conv_same_dims(4, 2, 8)
    rows = A.autotune_conv(
        cd, (1, 8, 8, 4), 16, mode="step", repeats=1, device="cpu",
        candidates=[
            A.EngineConfig(True, conf="mma_64x64", prepack=True),
            A.EngineConfig(True, conf="cuda_cores", prepack=True, epilogue="leaky_relu", emit_cells=True),
            None,  # the F.conv2d baseline rides the same sweep
        ],
    )
    assert len(rows) == 3 and all(r["ok"] for r in rows)
    assert all(np.isfinite(r["ms"]) for r in rows)
    assert rows == sorted(rows, key=lambda r: r["ms"])


@pytest.mark.parametrize("impl", ["cuda_fused_pre_prepacked", "cuda_prepacked"])
def test_deconv_block_overrides_preserve_numerics(impl):
    """Installing per-layer (backward included) configurations changes which
    kernels launch, not what they compute: the images and the gradients
    are the same with the table installed."""
    cfg = _mini_chain_cfg(impl)
    p = G.generator_init(cfg, seed=0, device="cpu")
    z = torch.randn((2, cfg.z_dim), generator=torch.Generator().manual_seed(1))

    def run():
        leaves = {k: v["ww"].detach().clone().requires_grad_(True) for k, v in p.items() if k.startswith("deconv")
                  and "ww" in v}
        img, _ = G.generator_apply({**p, **{k: {"ww": v} for k, v in leaves.items()}}, cfg, z, training=True)
        grads = torch.autograd.grad(img.square().sum(), list(leaves.values()))
        return img.detach(), grads

    base, base_g = run()
    fwd = "fused_engine" if "fused_pre" in impl else "domain_engine"
    for d in cfg.deconvs:
        G.set_deconv_blocks(impl, d.dims, d.c_in, d.c_out, conf="cuda_cores", splits=1, bwd_x_conf="cuda_cores",
                            bwd_w_conf="cuda_cores", bwd_w_splits=2)
        assert G.DECONV_BLOCKS[(impl, d.dims, d.c_in, d.c_out)]["conf"] in E.INSTANTIATIONS[fwd]
    tuned, tuned_g = run()
    torch.testing.assert_close(tuned, base, atol=0, rtol=0)
    for a, b in zip(tuned_g, base_g):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_install_tuned_blocks_wires_bwd_blocks():
    """install_tuned_blocks runs the autotuner per generator layer and wires
    the winning config's *backward* choices into the impl table (not
    mirrored from the forward); a winner of another engine variant is
    skipped; applying with the table installed gives the same images."""
    cfg = _mini_chain_cfg("cuda_fused_pre_prepacked")
    cands = [A.EngineConfig(True, conf="cuda_cores", bwd_x_conf="cuda_cores", bwd_w_conf="cuda_cores",
                            bwd_w_splits=1, prepack=True)]
    p = G.generator_init(cfg, seed=0, device="cpu")
    z = torch.randn((2, cfg.z_dim), generator=torch.Generator().manual_seed(1))
    base, _ = G.generator_apply(p, cfg, z, training=False)
    rows = G.install_tuned_blocks(cfg, mode="grad", candidates=cands, repeats=1, device="cpu")
    assert len(rows) == len(cfg.deconvs) and all("config" in r for r in rows)
    for d in cfg.deconvs:
        entry = G.DECONV_BLOCKS[(cfg.deconv_impl, d.dims, d.c_in, d.c_out)]
        assert entry == dict(conf="cuda_cores", bwd_x_conf="cuda_cores", bwd_w_conf="cuda_cores", bwd_w_splits=1)
    img, _ = G.generator_apply(p, cfg, z, training=False)
    torch.testing.assert_close(img, base, atol=0, rtol=0)

    # the winner of the unfused variant is measured on a path this impl never runs: skipped
    G.clear_deconv_blocks()
    rows = G.install_tuned_blocks(cfg, mode="fwd", candidates=[A.EngineConfig(False, prepack=True)], repeats=1,
                                  device="cpu")
    assert all("config" not in r and "error" in r for r in rows)
    assert G.DECONV_BLOCKS == {}
    # the default grid follows the impl's variant
    G.clear_deconv_blocks()
    rows = G.install_tuned_blocks(_mini_chain_cfg("cuda_prepacked"), mode="fwd", repeats=1, device="cpu")
    assert all(not r["config"].fuse_pre and r["config"].prepack for r in rows)


# ------------------------------------------------------------ where the table is read
def _bad_entry(impl, dims, n, m):
    """An entry no kernel has: a site that reads the table refuses it."""
    G.DECONV_BLOCKS[(impl, dims, n, m)] = {"conf": "no_such_instantiation"}


@pytest.mark.parametrize("site", ["deconv_per_layer", "conv_per_layer", "conv_chained", "deconv_chained",
                                  "plain_impls"])
def test_the_table_is_read_at_the_reference_sites_only(site):
    """The reference reads the table in the per-layer deconv apply, the
    per-layer conv apply and the discriminator's chained trunk, on the
    kernel impls only; its chained generator trunk does not read it."""
    cfg = tiny_dcgan()
    deconv, conv = {"deconv_per_layer": ("cuda_prepacked", "lax"), "conv_per_layer": ("ref", "cuda_prepacked"),
                    "conv_chained": ("ref", "cuda_chained"), "deconv_chained": ("cuda_chained", "lax"),
                    "plain_impls": ("prepacked_ref", "prepacked_ref")}[site]
    cfg = dataclasses.replace(cfg, deconv_impl=deconv, conv_impl=conv)
    gp = G.generator_init(cfg, seed=0, device="cpu")
    dp = G.discriminator_init(cfg, seed=1, device="cpu")
    z = torch.randn((2, cfg.z_dim), generator=torch.Generator().manual_seed(2))
    img, _ = G.generator_apply(gp, cfg, z)
    logits, _ = G.discriminator_apply(dp, cfg, img)
    for d in cfg.deconvs:
        _bad_entry(deconv, d.dims, d.c_in, d.c_out)
    chans = (cfg.img_ch, *G.disc_channels(cfg))
    for i, cd in enumerate(G.disc_conv_dims(cfg)):
        _bad_entry(conv, cd, chans[i], chans[i + 1])
    if site in ("deconv_chained", "plain_impls"):  # not read: the same results
        img2, _ = G.generator_apply(gp, cfg, z)
        logits2, _ = G.discriminator_apply(dp, cfg, img2)
        torch.testing.assert_close(img2, img, atol=0, rtol=0)
        torch.testing.assert_close(logits2, logits, atol=0, rtol=0)
        return
    with pytest.raises(ValueError, match="no_such_instantiation"):
        if site == "deconv_per_layer":
            G.generator_apply(gp, cfg, z)
        else:
            G.discriminator_apply(dp, cfg, img)


def test_set_deconv_blocks_takes_the_hopper_keys_only():
    with pytest.raises(ValueError, match="block_ty"):
        G.set_deconv_blocks("cuda_prepacked", K5S2, 8, 8, block_ty=8)
    G.set_deconv_blocks("cuda_prepacked", K5S2, 8, 8, conf="cuda_cores", splits=None, bwd_w_conf=None)
    assert G.DECONV_BLOCKS == {("cuda_prepacked", K5S2, 8, 8): {"conf": "cuda_cores"}}
    assert G._BLOCK_KEYS == ("conf", "splits", "bwd_x_conf", "bwd_w_conf", "bwd_w_splits")


# ------------------------------------------------------------ the timed functions against JAX
_JAX_CACHE: dict = {}
# per family: the port's geometry, the JAX one, the input shape, c_out, the Hopper config held to JAX's baseline
FAMILIES = {
    "deconv": (K5S2, JDeconvDims(5, 2, 2, 1), (4, 4, 4, 8), 16,
               A.EngineConfig(True, conf="mma_64x64", bwd_x_conf="mma_64x32", bwd_w_conf="mma_256x128",
                              bwd_w_splits=2)),
    "deconv_unfused": (K5S2, JDeconvDims(5, 2, 2, 1), (4, 4, 4, 32), 16,
                       A.EngineConfig(False, conf="cuda_cores", splits=2, bwd_x_conf="mma_64x32",
                                      bwd_w_conf="cuda_cores", bwd_w_splits=3)),
    "conv": (conv_same_dims(4, 2, 8), jconv_same_dims(4, 2, 8), (4, 8, 8, 4), 16,
             A.EngineConfig(True, conf="mma_64x64", splits=2, bwd_x_conf="mma_128x16", bwd_w_conf="mma_64x128",
                            bwd_w_splits=2)),
    "conv1d_deconv": (K4S2, JDeconvDims(4, 2, 1, 0), (2, 16, 8), 16,
                      A.EngineConfig(True, conf="mma_64x64", bwd_x_conf="mma_rank1_128x64",
                                     bwd_w_conf="mma_rank1_128x64", bwd_w_splits=2)),
    "conv1d_causal": (4, 4, (2, 16, 8), 16,
                      A.EngineConfig(True, conf="cuda_cores", bwd_x_conf="mma_rank1_64x32",
                                     bwd_w_conf="mma_rank1_256x128")),
}


def _inputs(family, seed=0):
    """The autotuners' draws: x, then w, from default_rng(seed)."""
    geom, _, shape, c_out, _ = FAMILIES[family]
    K = geom if isinstance(geom, int) else geom.kernel
    wshape = (K, shape[-1], c_out) if family.startswith("conv1d") else (K, K, shape[-1], c_out)
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32), rng.standard_normal(wshape).astype(np.float32)


def _jax_outputs(family, mode):
    key = (family, mode)
    if key not in _JAX_CACHE:
        _, jgeom, *_ = FAMILIES[family]
        make = {"deconv": JA.make_timed_fn, "deconv_unfused": JA.make_timed_fn, "conv": JA.make_timed_conv_fn}.get(
            family, JA.make_timed_conv1d_fn)
        fn, make_args = make(None, jgeom, mode, True)
        x, w = _inputs(family)
        out = fn(*make_args(jnp.asarray(x), jnp.asarray(w)))
        if mode == "step":  # (params, OptState(step, m, v))
            out = (out[0], out[1].m, out[1].v)
        if mode == "grad":  # the port's grad mode also gives the input's gradient: JAX's through its forward
            fwd, fwd_args = make(None, jgeom, "fwd", True)
            xa, pa = fwd_args(jnp.asarray(x), jnp.asarray(w))
            out = (*out, jax.grad(lambda xx: jnp.sum(fwd(xx, pa).astype(jnp.float32) ** 2))(xa))
        _JAX_CACHE[key] = [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]
    return _JAX_CACHE[key]


def _torch_outputs(family, mode, cfg):
    geom = FAMILIES[family][0]
    make = {"deconv": A.make_timed_fn, "deconv_unfused": A.make_timed_fn, "conv": A.make_timed_conv_fn}.get(
        family, A.make_timed_conv1d_fn)
    fn, make_args = make(cfg, geom, mode)
    x, w = (torch.as_tensor(a) for a in _inputs(family))
    out = fn(*make_args(x, w))
    if mode == "step":
        out = (out[0], out[1].m, out[1].v)
    return [o.detach().numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _close(got, want, *, grad=False):
    tol = 1e-4 * np.abs(want).max() + 1e-5
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol) if grad else (err, tol)


@pytest.mark.parametrize("tuned", [False, True], ids=["baseline", "hopper_config"])
@pytest.mark.parametrize("mode", ["fwd", "grad", "step"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_timed_functions_match_jax(family, mode, tuned):
    """make_timed_fn / _conv_fn / _conv1d_fn on the autotuners' inputs give
    JAX's baseline outputs: at ``cfg=None`` (the port's plain Winograd
    DeConv, F.conv2d, lax_deconv1d, F.conv1d) and at a Hopper configuration
    on raw weights (the requests checked against the table, then the plain
    versions)."""
    cfg = FAMILIES[family][4] if tuned else None
    got = _torch_outputs(family, mode, cfg)
    want = _jax_outputs(family, mode)
    assert len(got) == len(want)
    if mode == "fwd":
        np.testing.assert_allclose(got[0], want[0], atol=5e-5, rtol=1e-4)
    elif mode == "grad":  # (loss, the leaf's gradient, the input's)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        _close(got[1], want[1], grad=True)
        _close(got[2], want[2], grad=True)
    else:  # one AdamW step: the parameters within 6 * lr, the moments as the gradient
        np.testing.assert_allclose(got[0], want[0], atol=6 * LR, rtol=0)
        _close(got[1], want[1], grad=True)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-3, atol=1e-6 * np.abs(want[2]).max())


@pytest.mark.parametrize("mode", ["fwd", "grad"])
def test_prepacked_timed_function_matches_the_plain_packed_path(mode):
    """A prepacked Hopper config trains the packed leaf: its outputs equal
    autograd of the plain packed path (``backend="ref"``) on the same
    inputs (the gradients in the leaf and in the input), and its loss JAX's
    baseline loss."""
    cfg = A.EngineConfig(False, conf="mma_128x64", bwd_x_conf="cuda_cores", bwd_w_conf="mma_256x128", prepack=True)
    got = _torch_outputs("deconv", mode, cfg)
    x, w = (torch.as_tensor(a) for a in _inputs("deconv"))
    packed = ops.prepack(w, K5S2)
    leaf = packed.ww.clone().requires_grad_(True)
    x.requires_grad_(True)
    y = ops.winograd_deconv2d_packed(x, ops.PackedDeconv(leaf, packed.inv), K5S2, backend="ref")
    if mode == "fwd":
        np.testing.assert_allclose(got[0], y.detach().numpy(), atol=5e-5, rtol=1e-4)
        return
    loss = y.square().sum()
    g, dx = torch.autograd.grad(loss, (leaf, x))
    np.testing.assert_allclose(got[0], _jax_outputs("deconv", "grad")[0], rtol=1e-4)
    _close(got[1], g.numpy(), grad=True)
    _close(got[2], dx.numpy(), grad=True)


# ------------------------------------------------------------ refusals and the grids
@pytest.mark.parametrize("cfg,match", [
    (A.EngineConfig(False, conf="mma_128x64", prepack=True), "does not take"),  # M = 3: no tensor cores
    (A.EngineConfig(True, conf="cuda_cores", splits=99, prepack=True), "runs 1 to"),  # past the N chunks
    (A.EngineConfig(True, splits=2, prepack=True), "needs conf"),  # a split without the instantiation it splits
    (A.EngineConfig(False, conf="mma_64x64", prepack=True), "no instantiation"),  # the fused engine's name
    (A.EngineConfig(True, bwd_x_conf="mma_rank1_128x64", prepack=True), "no instantiation"),
], ids=["tensor_cores_at_rgb", "split_past_chunks", "split_without_conf", "other_kernels_name", "rank1_name"])
def test_infeasible_requests_are_ok_false_rows(cfg, match):
    rows = A.autotune_deconv(K5S2, (1, 4, 4, 8), 3, mode="grad", repeats=1, device="cpu",
                             candidates=[cfg, A.EngineConfig(True, prepack=True)])
    bad = [r for r in rows if r["config"] == cfg]
    assert len(bad) == 1 and not bad[0]["ok"] and bad[0]["ms"] == float("inf")
    assert match in bad[0]["error"] and bad[0]["error"].startswith("ValueError")
    assert rows[0]["ok"] and rows[-1] is bad[0]  # fastest first, the refused last


def test_best_config_mode_mesh_and_compression():
    cfg = A.EngineConfig(False, conf="mma_128x64", prepack=True)
    with pytest.raises(RuntimeError, match="no engine config ran"):
        A.best_config(K5S2, (1, 4, 4, 8), 3, candidates=[cfg], repeats=1, device="cpu")
    won = A.best_config(K5S2, (1, 4, 4, 8), 3, candidates=[cfg, A.EngineConfig(True)], repeats=1, device="cpu")
    assert won == A.EngineConfig(True)
    for fn, geom in ((A.autotune_deconv, K5S2), (A.autotune_conv, conv_same_dims(4, 2, 8)),
                     (A.autotune_conv1d, K4S2)):
        shape = (1, 8, 4) if fn is A.autotune_conv1d else (1, 4, 4, 4)
        with pytest.raises(ValueError):
            fn(geom, shape, 4, mode="train", device="cpu")
    # mesh= and grad_compression= run (tests/test_torch_parallel.py times them on gloo ranks); what they
    # refuse, as the reference: compression without a mesh or outside mode "step", a mesh without the shapes
    with pytest.raises(ValueError, match="requires mode='step' and a mesh"):
        A.autotune_deconv(K5S2, (1, 4, 4, 8), 3, mode="step", grad_compression="int8", device="cpu")
    with pytest.raises(ValueError, match="requires mode='step' and a mesh"):
        A.autotune_deconv(K5S2, (1, 4, 4, 8), 3, mode="grad", grad_compression="int8", mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="needs input_shape and c_out"):
        A.make_timed_fn(None, K5S2, "step", mesh=object())
    with pytest.raises(ValueError, match="unknown grad_compression"):
        A.make_timed_fn(None, K5S2, "step", mesh=object(), grad_compression="fp8")


def test_candidate_grids_name_the_hopper_instantiations():
    """The grids keep the reference's filters and enumerate each variant's
    instantiation names; splits pair with the instantiation that splits."""
    grid = A.candidate_configs()
    unfused = [c for c in grid if not c.fuse_pre]
    fused = [c for c in grid if c.fuse_pre]
    assert {c.conf for c in unfused} == {None, *E.INSTANTIATIONS["domain_engine"]}
    assert {c.conf for c in fused} == {None, *E.INSTANTIATIONS["fused_engine"]}
    assert all(c.splits is None or c.conf == "cuda_cores" for c in grid)
    assert {c.splits for c in grid if c.conf == "cuda_cores"} == {None, 1, 2, 4}
    assert all(c.bwd_x_conf is None and c.bwd_w_conf is None for c in grid)  # forward-only by default
    assert len(A.candidate_configs(include_fused=False)) == len(unfused)
    assert all(c.prepack for c in A.candidate_configs(prepack=True))
    bwd = A.candidate_configs(conf=(None,), splits=(None,), bwd_w_conf=(None, "mma_256x128"),
                              bwd_w_splits=(None, 2), include_unfused=False)
    assert {(c.bwd_w_conf, c.bwd_w_splits) for c in bwd} == {(None, None), ("mma_256x128", None),
                                                             ("mma_256x128", 2)}
    epi = A.candidate_configs(conf=(None,), splits=(None,), include_unfused=False, epilogue=(None, "relu"),
                              emit_cells=(False, True))
    assert len(epi) == 4
    assert [c.conf for c in A.conv1d_candidates()] == [None, *E.INSTANTIATIONS["winograd_conv1d_fused_engine"]]
    assert {c.conf for c in A.conv_candidates()} == {None, *E.INSTANTIATIONS["conv_fused_engine"]}
    assert [c.fuse_pre for c in A.small_candidates()] == [False, False, True, True]
    assert len(A.epilogue_candidates()) == 6


def test_engine_config_keeps_the_reference_axes_and_drops_the_tpu_blocks():
    ref = {f.name for f in dataclasses.fields(JA.EngineConfig)}
    port = {f.name for f in dataclasses.fields(A.EngineConfig)}
    assert {"fuse_pre", "prepack", "epilogue", "emit_cells"} <= ref & port
    assert not any(name.startswith(("block_", "bwd_block_")) for name in port)
    assert port - ref == set(G._BLOCK_KEYS)
    kw = A.EngineConfig(True, conf="cuda_cores", bwd_w_splits=2).kwargs()
    assert set(kw) == {"fuse_pre", *G._BLOCK_KEYS, "epilogue", "emit_cells"}
    assert kw["conf"] == "cuda_cores" and kw["bwd_w_splits"] == 2


def test_wrappers_check_requests_on_cpu_as_on_the_card():
    """A CPU tensor takes the plain version after the request is checked:
    a name the table refuses raises ValueError, one it takes gives the
    plain result."""
    x = torch.randn((1, 4, 4, 32), generator=torch.Generator().manual_seed(0))
    w = torch.randn((5, 5, 32, 16), generator=torch.Generator().manual_seed(1))
    packed = ops.prepack(w, K5S2)
    want = ops.winograd_deconv2d_packed(x, packed, K5S2, backend="ref")
    for kw in (dict(conf="mma_128x64"), dict(conf="cuda_cores", splits=2), dict(conf="few_channels")):
        torch.testing.assert_close(ops.winograd_deconv2d_packed(x, packed, K5S2, **kw), want)
    for kw, match in ((dict(conf="mma_64x64"), "no instantiation"), (dict(splits=2), "needs conf"),
                      (dict(conf="mma_128x64", splits=2), "runs 1 to 1")):
        with pytest.raises(ValueError, match=match):
            ops.winograd_deconv2d_packed(x, packed, K5S2, **kw)
    assert DCGAN.deconvs[3].c_out == 3  # the RGB layer: no tensor cores there
    with pytest.raises(ValueError, match="does not take"):
        E.request("domain_engine", "mma_128x64", N=128, M=3, C=36)


# ------------------------------------------------------------ the smoke's autotune checks, on the CPU
def test_smoke_holds_the_weights_and_the_inputs_gradient():
    """chip_smoke's autotune phase holds a grad-mode candidate's three
    outputs (loss, the weights' gradient, the input's: the bwd_x kernel's)
    against the plain version: a wrong input gradient, or none, fails."""
    import chip_smoke

    cfg = A.EngineConfig(False, conf="cuda_cores", bwd_x_conf="mma_64x32", prepack=True)
    fn, make_args = A.make_timed_fn(cfg, K5S2, "grad")
    x, w = (torch.as_tensor(a) for a in _inputs("deconv_unfused"))
    got = fn(*make_args(x, w))
    packed = ops.prepack(w, K5S2)
    plain = chip_smoke._plain_outputs(
        torch, lambda xx, pp: ops.winograd_deconv2d_packed(xx, pp, K5S2, backend="ref"), packed.ww,
        lambda leaf: ops.PackedDeconv(leaf, packed.inv), x, "grad")
    assert len(got) == len(plain) == 3 and got[2].shape == x.shape
    assert chip_smoke._held_outputs("cpu", got, plain, "grad") <= 1.0
    wrong_dx = got[2].clone()
    wrong_dx.view(-1)[7] += 1e-2 * wrong_dx.abs().max()
    with pytest.raises(SystemExit, match="output 2"):
        chip_smoke._held_outputs("cpu", (*got[:2], wrong_dx), plain, "grad")
    with pytest.raises(SystemExit, match="2 outputs"):
        chip_smoke._held_outputs("cpu", got[:2], plain, "grad")


def test_plan_refusals_and_the_launch_log():
    """A C plan's cudaErrorInvalidValue for a request is a ValueError (as
    the table's refusal on the CPU), any other error a RuntimeError; the
    unsplit kernels' plans refuse a split past 1; the smoke's table check
    passes a plan that refuses what the table refuses and fails one that
    does not; ``logged_launches`` leaves no log behind."""
    import chip_smoke

    assert isinstance(E._plan_error("fused_engine", 1, 1, -1), ValueError)
    assert isinstance(E._plan_error("fused_engine", 1, 0, 3), ValueError)
    assert isinstance(E._plan_error("fused_engine", 1, -1, -1), RuntimeError)  # the plan's own choice failed
    assert isinstance(E._plan_error("fused_engine", 2, 1, -1), RuntimeError)
    E._unsplit("fused_engine_bwd_x", 1)
    with pytest.raises(ValueError, match="runs 1 to 1"):
        E._unsplit("fused_engine_bwd_x", 2)

    shape = dict(N=64, M=3, T=100)  # an RGB bwd_w: no tensor cores, 25 T chunks of 4 on the CUDA cores

    def c_plan(want, want_splits):
        return E.request("domain_engine_bwd_w", E.INSTANTIATIONS["domain_engine_bwd_w"][want],
                         None if want_splits < 0 else want_splits, M2=4, **shape)

    rec = E.Launch("domain_engine_bwd_w", dict(shape, M2=4), "cuda_cores", 1, c_plan)
    n = chip_smoke.table_agrees_with_plans(E, [rec, rec])
    assert n == len(E.INSTANTIATIONS["domain_engine_bwd_w"]) * 7  # the repeated record checked once
    lax = rec._replace(plan=lambda want, want_splits: None)  # a plan that takes every request
    with pytest.raises(SystemExit, match="the table refuses it, the C plan takes it"):
        chip_smoke.table_agrees_with_plans(E, [lax])
    with chip_smoke.logged_launches(E) as log:
        assert E.launch_log is log == []
    assert E.launch_log is None
