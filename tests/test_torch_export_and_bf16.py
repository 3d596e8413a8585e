"""Port parity of the checkpoint export, the bf16 impls and the analytic
complexity model, against the reference, on the CPU.

* ``ops.unpack_weights`` / ``gan.unpack_generator``: the port's least
  squares (pinv in float64) against the reference's (atol 1e-5), and the
  pack -> unpack round trip (atol 1e-5), for both families (deconv, conv)
  and at DCGAN's and ArtGAN's layers at narrowed widths.
* ``winograd_deconv2d(bf16=True)`` and the ``ref_bf16`` / ``ref_dense``
  generators: each package within the reference's bf16 tolerance of the
  fp32 oracle (atol 0.15, rtol 0.1, tests/test_core_winograd_deconv.py;
  for the generator, whose images are ~1e-3, atol 0.15 of the oracle's
  largest value), and the port within ``BF16_SHARE`` of JAX's largest
  value: both round the same fp32 operands to bf16, so they differ where a
  rounding flips on an fp32 difference in the transforms (one bf16 step,
  2^-8 of an operand) and in the order of the fp32 sums.  Over seeds 0-3
  the tiny generator read 2e-4 to 2.7e-3 of the largest value between the
  packages, and 7e-3 between bf16 and fp32, which the tests also require.
* ``core.complexity``: every function equal to the reference's, exactly,
  over the four ``gan_zoo`` archs' deconv layers and a sweep of dims.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gan_zoo as jzoo
from repro.core import complexity as JC
from repro.core import tdc as jtdc
from repro.core import winograd_deconv as JW
from repro.core.baselines import standard_deconv2d as j_standard
from repro.kernels import ops as jops
from repro.models import gan as JG
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import generator_params_from_numpy
from repro_torch.core import complexity as TC
from repro_torch.core import tdc as ttdc
from repro_torch.core import winograd_deconv as TW
from repro_torch.kernels import ops as tops
from repro_torch.models import gan as TG

BF16_ORACLE_TOL = dict(atol=0.15, rtol=0.1)  # the reference's bf16 tolerance against fp32
BF16_SHARE = 5e-3  # port against JAX, both in bf16, as a share of the largest value (module docstring)

GEOMETRIES = [("deconv", (5, 2, 2, 1)), ("deconv", (4, 2, 1, 0)), ("deconv", (3, 1, 1, 0)), ("deconv", (4, 2, 1, 1)),
              ("conv", (4, 2, 8)), ("conv", (3, 1, 8)), ("conv", (3, 2, 8))]


def _dims(pkg_tdc, family, args):
    return pkg_tdc.DeconvDims(*args) if family == "deconv" else pkg_tdc.conv_same_dims(*args)


def _narrow(zoo, arch):
    if arch == "dcgan":
        return zoo.tiny_dcgan("prepacked_ref")
    widths = [(8, 8), (8, 8), (8, 8), (8, 8), (8, 3)]
    return dataclasses.replace(zoo.ARTGAN, stem_ch=8, deconv_impl="prepacked_ref",
                               deconvs=tuple(dataclasses.replace(d, c_in=a, c_out=b)
                                             for d, (a, b) in zip(zoo.ARTGAN.deconvs, widths)))


# ------------------------------------------------------------------ export
@pytest.mark.parametrize("family,args", GEOMETRIES, ids=lambda v: str(v))
def test_unpack_weights_matches_reference_and_round_trips(family, args):
    jd, td = _dims(jtdc, family, args), _dims(ttdc, family, args)
    rng = np.random.default_rng(3)
    K = jd.kernel
    w = rng.standard_normal((K, K, 4, 6)).astype(np.float32)
    jpack = jops.pack_conv_weights if family == "conv" else jops.pack_weights
    tpack = tops.pack_conv_weights if family == "conv" else tops.pack_weights
    ww = np.array(jpack(jnp.asarray(w), jd))
    np.testing.assert_allclose(tpack(torch.from_numpy(w), td).numpy(), ww, atol=1e-5, rtol=0)
    got = tops.unpack_weights(torch.from_numpy(ww), td)
    assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.unpack_weights(jnp.asarray(ww), jd)), atol=1e-5, rtol=0)
    # pack -> unpack recovers the raw weights (the pack is injective)
    np.testing.assert_allclose(tops.unpack_weights(tpack(torch.from_numpy(w), td), td).numpy(), w, atol=1e-5, rtol=0)
    # a trained (inconsistent) packed leaf: both packages project it alike
    noisy = ww + 0.01 * rng.standard_normal(ww.shape).astype(np.float32)
    np.testing.assert_allclose(tops.unpack_weights(torch.from_numpy(noisy), td).numpy(),
                               np.asarray(jops.unpack_weights(jnp.asarray(noisy), jd)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["dcgan", "artgan"])
def test_unpack_generator_matches_reference(arch):
    """Packed generator params (the reference's prepack of one raw tree)
    export to the reference's raw weights; the raw forward reproduces the
    packed one, and re-packing returns the packed leaves."""
    jcfg, tcfg = _narrow(jzoo, arch), _narrow(tzoo, arch)
    raw_cfg = dataclasses.replace(tcfg, deconv_impl="ref")
    packed = jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(1), jcfg))
    want = jax.tree.map(np.asarray, JG.unpack_generator(jax.tree.map(jnp.asarray, packed), jcfg))
    tp = generator_params_from_numpy(packed, tcfg, device="cpu")
    got = TG.unpack_generator(tp, tcfg)
    for i in range(len(tcfg.deconvs)):
        assert set(got[f"deconv{i}"]) == {"w"}
        np.testing.assert_allclose(got[f"deconv{i}"]["w"].numpy(), want[f"deconv{i}"]["w"], atol=1e-5, rtol=0)
    assert TG.unpack_generator(got, raw_cfg)["deconv0"] is got["deconv0"]  # raw leaves pass through
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 100)).astype(np.float32))
    a, _ = TG.generator_apply(tp, tcfg, z)
    b, _ = TG.generator_apply(got, raw_cfg, z)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-4)
    back = TG.prepack_generator(got, tcfg)
    for i in range(len(tcfg.deconvs)):
        np.testing.assert_allclose(back[f"deconv{i}"]["ww"].numpy(), packed[f"deconv{i}"]["ww"], atol=1e-5, rtol=0)


# -------------------------------------------------------------------- bf16
def _err_share(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bf16_deconv_matches_reference():
    """The reference's bf16 case (K5S2, 8 -> 8 channels), dense and sparse:
    both packages within the bf16 tolerance of the fp32 oracle, the port
    within BF16_SHARE of JAX, and the bf16 path differs from the fp32 one."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 6, 6, 8)).astype(np.float32)
    w = rng.standard_normal((5, 5, 8, 8)).astype(np.float32)
    jd, td = jtdc.DeconvDims(5, 2, 2, 1), ttdc.DeconvDims(5, 2, 2, 1)
    oracle = np.asarray(j_standard(jnp.asarray(x), jnp.asarray(w), jd))
    fp32 = TW.winograd_deconv2d(torch.from_numpy(x), torch.from_numpy(w), td).numpy()
    for dense in (False, True):
        want = np.asarray(JW.winograd_deconv2d(jnp.asarray(x), jnp.asarray(w), jd, dense=dense, bf16=True))
        got = TW.winograd_deconv2d(torch.from_numpy(x), torch.from_numpy(w), td, dense=dense, bf16=True)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(want, oracle, **BF16_ORACLE_TOL)
        np.testing.assert_allclose(got.numpy(), oracle, **BF16_ORACLE_TOL)
        assert _err_share(got.numpy(), want) <= BF16_SHARE
        assert _err_share(fp32, got.numpy()) > 1e-4  # the operands were rounded


@pytest.mark.parametrize("impl", ["ref_bf16", "ref_dense"])
def test_bf16_generators_match_reference(impl):
    """tiny DCGAN through the ``ref_bf16`` / ``ref_dense`` impls: each
    package within the bf16 tolerance of JAX's fp32 ``ref`` generator, the
    port within BF16_SHARE of JAX's same impl; both serve on the fp32
    kernels under the port's serve_impl."""
    jcfg = jzoo.tiny_dcgan(impl)
    p = jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(4), jcfg))
    z = np.random.default_rng(5).standard_normal((3, 100)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    oracle, _ = JG.generator_apply(jp, jzoo.tiny_dcgan("ref"), jnp.asarray(z), training=False)
    want, _ = JG.generator_apply(jp, jcfg, jnp.asarray(z), training=False)
    tcfg = tzoo.tiny_dcgan(impl)
    got, _ = TG.generator_apply(generator_params_from_numpy(p, tcfg, device="cpu"), tcfg, torch.from_numpy(z))
    oracle, want = np.asarray(oracle), np.asarray(want)
    scaled = dict(atol=BF16_ORACLE_TOL["atol"] * np.abs(oracle).max(), rtol=BF16_ORACLE_TOL["rtol"])
    np.testing.assert_allclose(want, oracle, **scaled)
    np.testing.assert_allclose(got.numpy(), oracle, **scaled)
    assert _err_share(got.numpy(), want) <= BF16_SHARE
    assert _err_share(got.numpy(), oracle) > 2e-3  # the operands were rounded
    assert impl in TG.IMPLS and not TG.uses_prepacked(impl)
    assert TG.serve_impl(impl) == "cuda_chained" and TG.serve_impl(impl, chained=False) == "cuda_prepacked"


# -------------------------------------------------------------- complexity
def _layers(pkg_tdc, C, zoo, arch, batch):
    """LayerShape of every deconv layer of ``arch`` (its input extent from
    the seed, or the encoder's strides)."""
    cfg = zoo.GANS[arch]
    h = cfg.seed_hw if cfg.z_dim else cfg.img_hw // int(np.prod([e.stride for e in cfg.encoder]))
    out = []
    for d in cfg.deconvs:
        out.append(C.LayerShape(h, h, d.c_in, d.c_out, pkg_tdc.DeconvDims(*dataclasses.astuple(d.dims)), batch))
        h = d.dims.out_size(h)
    return out


def _model(C, layer) -> list:
    rows = [C.mults_zero_padded(layer), C.mults_tdc(layer), C.mults_winograd(layer),
            C.mults_winograd(layer, dense=True), C.transform_ops(layer), C.dse_model(layer),
            C.dse_model(layer, t_m=8, t_n=64, freq_hz=200e6, bandwidth=12.8e9),
            layer.h_out, layer.w_out]
    rows += [C.bytes_moved(layer, meth) for meth in ("zero_padded", "tdc", "winograd")]
    rows += [C.bytes_moved(layer, "winograd", dtype_bytes=2)]
    return rows


@pytest.mark.parametrize("arch", ["dcgan", "artgan", "discogan", "gpgan"])
def test_complexity_matches_reference_on_the_gan_zoo(arch):
    for batch in (1, 8, 128):
        jl, tl = _layers(jtdc, JC, jzoo, arch, batch), _layers(ttdc, TC, tzoo, arch, batch)
        assert len(tl) == len(jl) == len(jzoo.GANS[arch].deconvs)
        for a, b in zip(jl, tl):
            assert _model(TC, b) == _model(JC, a)
    with pytest.raises(ValueError):
        TC.bytes_moved(tl[0], "lax")


def test_complexity_matches_reference_over_a_sweep_of_dims():
    n = 0
    for K, S in itertools.product(range(1, 7), range(1, 4)):
        for P, OP in itertools.product(range(K), range(S)):
            args = (K, S, P, OP)
            jd, td = jtdc.DeconvDims(*args), ttdc.DeconvDims(*args)
            for h, c in ((3, (5, 7)), (8, (16, 3))):
                if jd.out_size(h) < 1:
                    continue
                ja, ta = JC.LayerShape(h, h + 1, *c, jd, 2), TC.LayerShape(h, h + 1, *c, td, 2)
                try:
                    want = _model(JC, ja)
                except ValueError:  # K_C > r: not expressible in F(2, 3)
                    with pytest.raises(ValueError):
                        _model(TC, ta)
                    continue
                assert _model(TC, ta) == want, args
                n += 1
    assert n > 100
