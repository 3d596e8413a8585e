"""Port parity of the epilogue-fused engine: the port's entry points on CPU
tensors (which take the kernel's plain version) against the JAX reference,
across geometry x activation x bias x out mode.

The JAX side runs as its own tests run it: ``backend="ref"`` for the full
cross, and the Pallas kernel body in interpret mode once per geometry and
out mode.  Tolerance atol 5e-5, rtol 1e-4, as the reference's epilogue
tests.  The reference's Pallas cells output is block-padded; the port's is
the exact (B, ty*S, tx*S, m*m, M) array, compared on the leading window with
the rest of the JAX array required to be zero."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tdc as jtdc
from repro.kernels import ops as jops
from repro_torch.core import DeconvDims, standard_deconv2d
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import epilogue_apply_ref

GEOMS = {"k5s2": (5, 2, 2, 1), "k4s2": (4, 2, 1, 0), "k3s1": (3, 1, 1, 0), "k2s3": (2, 3, 0, 0)}
ACTS = ("none", "relu", "leaky_relu", "tanh")
MODES = ("nhwc", "cells")
TOL = dict(atol=5e-5, rtol=1e-4)
INTERP = dict(interpret=True, block_ty=2, block_n=8, block_m=8)


def _data(geom, with_bias, shape=(1, 4, 5, 3, 4), seed=0):
    B, H, W, N, M = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, N)).astype(np.float32)
    w = rng.standard_normal((GEOMS[geom][0],) * 2 + (N, M)).astype(np.float32)
    scale = (rng.standard_normal(M) * 0.3 + 1.5).astype(np.float32)
    bias = rng.standard_normal(M).astype(np.float32)
    return x, w, (scale if with_bias else None), (bias if with_bias else None)


def _both(geom, act, with_bias, mode, jax_kw, seed=0):
    """(port output, JAX output) as numpy, from one set of numpy inputs and
    the JAX-packed weights (so the engines see identical operands)."""
    x, w, scale, bias = _data(geom, with_bias, seed=seed)
    jd, td = jtdc.DeconvDims(*GEOMS[geom]), DeconvDims(*GEOMS[geom])
    jp = jops.prepack(jnp.asarray(w), jd)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = jops.winograd_deconv2d_packed(
        jnp.asarray(x), jp, jd, fuse_pre=True, epilogue=act, scale=j(scale), bias=j(bias),
        emit_cells=mode == "cells", **jax_kw,
    )
    packed = tops.PackedDeconv(torch.from_numpy(np.array(jp.ww)), torch.from_numpy(np.array(jp.inv)))
    got = tops.winograd_deconv2d_packed(
        torch.from_numpy(x), packed, td, fuse_pre=True, epilogue=act, scale=t(scale), bias=t(bias),
        emit_cells=mode == "cells",
    )
    return got.numpy(), np.asarray(want)


def _compare(got, want, mode):
    if mode == "cells":  # JAX Pallas output is block-padded past the exact window
        B, gy, gx, m2, M = got.shape
        np.testing.assert_allclose(got, want[:, :gy, :gx, :, :M], **TOL)
        rest = want.copy()
        rest[:, :gy, :gx, :, :M] = 0
        assert not rest.any()
    else:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("geom", list(GEOMS))
def test_fused_engine_matches_jax_ref(geom, act, with_bias, mode):
    got, want = _both(geom, act, with_bias, mode, dict(backend="ref"))
    _compare(got, want, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("geom", list(GEOMS))
def test_fused_engine_matches_pallas_interpret(geom, mode):
    """The Pallas kernel body itself (interpret mode), activation rotating."""
    act = ACTS[(list(GEOMS).index(geom) + MODES.index(mode)) % len(ACTS)]
    got, want = _both(geom, act, True, mode, dict(backend="pallas", **INTERP), seed=1)
    _compare(got, want, mode)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_fused_engine_matches_scatter_sum_oracle(geom):
    """Independent second check: act(scale * deconv + bias) by scatter-sum."""
    x, w, scale, bias = (None if a is None else torch.from_numpy(a) for a in _data(geom, True, seed=2))
    td = DeconvDims(*GEOMS[geom])
    want = epilogue_apply_ref(standard_deconv2d(x, w, td), scale, bias, "leaky_relu")
    got = tops.winograd_deconv2d_packed(x, tops.prepack(w, td), td, fuse_pre=True, epilogue="leaky_relu",
                                        scale=scale, bias=bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_cuda_backend_on_cpu_equals_ref_backend(mode):
    """backend="cuda" on CPU tensors is the plain version, bit for bit."""
    x, w, scale, bias = (torch.from_numpy(a) for a in _data("k5s2", True, seed=3))
    td = DeconvDims(*GEOMS["k5s2"])
    p = tops.prepack(w, td)
    kw = dict(fuse_pre=True, epilogue="relu", scale=scale, bias=bias, emit_cells=mode == "cells")
    a = tops.winograd_deconv2d_packed(x, p, td, backend="cuda", **kw)
    b = tops.winograd_deconv2d_packed(x, p, td, backend="ref", **kw)
    assert torch.equal(a, b)


def test_emitted_cells_chain_into_next_layer():
    """cells out + cells_to_next == cells_from_image of the NHWC output."""
    x, w, scale, bias = (torch.from_numpy(a) for a in _data("k5s2", True, seed=4))
    td = DeconvDims(*GEOMS["k5s2"])
    p = tops.prepack(w, td)
    img = tops.winograd_deconv2d_packed(x, p, td, fuse_pre=True, epilogue="relu", scale=scale, bias=bias)
    cells = tops.winograd_deconv2d_packed(x, p, td, fuse_pre=True, epilogue="relu", scale=scale, bias=bias,
                                          emit_cells=True)
    got = tops.cells_to_next(cells, td, td, (img.shape[1], img.shape[2]))
    want = tops.cells_from_image(img, td)
    gy, gx = want.shape[1], want.shape[2]
    np.testing.assert_allclose(got[:, :gy, :gx].numpy(), want.numpy(), atol=1e-6)
    assert not got[:, gy:].any() and not got[:, :, gx:].any()


def test_fused_engine_rejects_bad_arguments():
    td = DeconvDims(*GEOMS["k5s2"])
    pos, subs, inv, _ = tops.packed_layout(td)
    cells = torch.zeros(1, 4, 4, 4, 2)
    kw = dict(pos_idx=pos, sub_slices=subs, m=2, n=4, ty=3, tx=3, stride=2, padding=2,
              out_h=8, out_w=8)
    ww, invt = torch.zeros(len(pos), 2, 3), torch.from_numpy(inv)
    with pytest.raises(ValueError):
        E.fused_engine(cells, ww, invt, out_mode="image", **kw)
    with pytest.raises(ValueError):  # scratch mode has no epilogue
        E.fused_engine(cells, ww, invt, out_mode="scratch", activation="relu", **kw)
    with pytest.raises(ValueError):
        E.fused_engine(cells, ww, invt, out_mode="nhwc", activation="gelu", **kw)
