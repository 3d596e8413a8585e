"""The plain reference against the port's own plain (``ref``) backend, at
tiny widths on the CPU: the packed layouts and packing, the Winograd-domain
layers against plain convolutions, a generate, and one train step."""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from bench import inputs, program
from bench.reference import gan as R
from bench.reference import winograd as W
from bench.tests._tiny import SEED, tiny_cfg

DECONVS = [(5, 2, 2, 1), (4, 2, 1, 0), (3, 1, 1, 0)]


@pytest.mark.parametrize("geo", DECONVS)
def test_deconv_pack_and_layer_match_the_port_and_conv_transpose(geo):
    from repro_torch.core.tdc import DeconvDims
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)
    w = torch.randn(geo[0], geo[0], 6, 5, generator=g)
    mine = W.Deconv(*geo)
    flat, groups, inv = W.layout(mine)
    pos, sub, inv_p, _ = ops.packed_layout(DeconvDims(*geo))
    assert groups == sub and (inv == inv_p).all()
    torch.testing.assert_close(W.pack(w, mine), ops.pack_weights(w, DeconvDims(*geo)), rtol=0, atol=1e-6)
    x = torch.randn(2, 7, 7, 6, generator=g)
    want = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), stride=geo[1], padding=geo[2],
                              output_padding=geo[3]).permute(0, 2, 3, 1)
    torch.testing.assert_close(W.deconv(x, W.pack(w, mine), mine), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("h", [64, 32, 16, 8, 7])
def test_conv_pack_and_layer_match_the_port_and_conv2d(h):
    from repro_torch.core.tdc import conv_same_dims
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(1)
    w = torch.randn(4, 4, 6, 5, generator=g)
    mine = W.Conv.same(4, 2, h)
    assert W.layout(mine)[0] == ops.conv_packed_layout(conv_same_dims(4, 2, h))[0]
    torch.testing.assert_close(W.pack(w, mine), ops.pack_conv_weights(w, conv_same_dims(4, 2, h)), rtol=0, atol=1e-6)
    x = torch.randn(2, h, h, 6, generator=g)
    want = L.conv2d({"w": w, "b": torch.zeros(5)}, x, stride=2)
    torch.testing.assert_close(W.conv(x, W.pack(w, mine), mine), want, rtol=0, atol=3e-5)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    r = W.round_tf32(t)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - t).abs() <= t.abs() * 2.0**-11).all() and not torch.equal(r, t)


@pytest.mark.parametrize("name", ["dcgan", "artgan"])
def test_generate_matches_the_ports_plain_generator(name):
    from repro_torch.models import gan as G

    cfg = tiny_cfg(name)
    gp, _ = inputs.draw_params(cfg, SEED, "cpu")
    z = torch.randn(3, cfg["z_dim"], generator=torch.Generator().manual_seed(3))
    port, _ = G.generator_apply(inputs.nest(gp), program.gan_config(cfg, deconv_impl="ref"), z)
    direct, _ = R.generator(gp, cfg, z, training=False, packed=False)
    packed, _ = R.generator(R.pack_params(gp, {}, {**cfg, "disc_channels": []})[0], cfg, z, training=False,
                            packed=True)
    torch.testing.assert_close(direct, port, rtol=0, atol=2e-6)
    torch.testing.assert_close(packed, port, rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", ["dcgan", "artgan"])
def test_one_train_step_matches_the_ports_plain_step(name):
    from repro_torch.models import gan as G
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepSettings, make_gan_step

    cfg = tiny_cfg(name)
    pcfg = program.gan_config(cfg, deconv_impl="chained_ref", conv_impl="chained_ref")
    gp, dp = inputs.draw_params(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(4)
    z, real = torch.randn(4, cfg["z_dim"], generator=g), torch.rand(4, 64, 64, 3, generator=g) * 2 - 1
    pg, pd = G.prepack_generator(inputs.nest(gp), pcfg), G.prepack_discriminator(inputs.nest(dp), pcfg)
    step = make_gan_step(pcfg, settings=StepSettings(lr=2e-4, b1=0.5))
    pg2, pd2, g_opt, d_opt, m = step(pg, pd, adamw_init(pg), adamw_init(pd), z, real)
    rg, rd = R.pack_params(gp, dp, cfg)
    rg2, rd2, _, _, gl, dl, gg, dg = R.train_step(rg, rd, R.adam_init(rg), R.adam_init(rd), z, real, cfg,
                                                   lr=2e-4, b1=0.5)
    torch.testing.assert_close(torch.stack([m["g_loss"], m["d_loss"]]), torch.stack([gl, dl]), rtol=1e-5, atol=0)
    mine = {**gg, **dg}
    port = {**inputs.flatten(g_opt.m), **inputs.flatten(d_opt.m)}
    # AdamW's first moment after one step is (1 - b1) g; a bias ahead of a
    # batchnorm has a gradient of rounding only, so a leaf is held to at
    # least a thousandth of the largest leaf's norm
    floor = 1e-3 * max(float(g.norm()) for g in mine.values())
    for k, v in port.items():
        assert float((v / 0.5 - mine[k]).norm()) <= 2e-5 * max(float(mine[k].norm()), floor), k
    assert set(inputs.flatten(pg2)) | set(inputs.flatten(pd2)) == set(rg2) | set(rd2)


def test_draw_params_is_a_function_of_the_seed():
    cfg = tiny_cfg("dcgan")
    a, b = inputs.draw_params(cfg, SEED, "cpu"), inputs.draw_params(cfg, SEED, "cpu")
    c = inputs.draw_params(cfg, SEED + 1, "cpu")
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert not torch.equal(a[0]["deconv0.w"], c[0]["deconv0.w"])
    assert not torch.equal(a[0]["stem_bn.var"], torch.ones_like(a[0]["stem_bn.var"]))  # the fold is exercised


def test_the_port_config_check_refuses_a_changed_width():
    import json

    from bench import harness

    cfg = json.loads((harness.BENCH / "configs" / "dcgan.json").read_text())
    program.gan_config(cfg, deconv_impl="cuda_chained")
    cfg["deconvs"][1] = {**cfg["deconvs"][1], "c_out": 255}
    with pytest.raises(SystemExit):
        program.gan_config(cfg, deconv_impl="cuda_chained")
