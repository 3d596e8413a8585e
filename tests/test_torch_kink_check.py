"""The train and audio phases' checks of ``chip_smoke.py`` on the CPU: the
plain run compares on the kernel run's side of each activation kink.

A forward that does not sum in the plain version's order may put an
activation input that sits within fp32 noise of a kink (relu, leaky_relu)
on its other side; that element's gradient then takes the other slope, and
one such element can move a step-1 gradient past the check's 1e-3 of its
leaf.  ``chip_smoke.kink_sides`` records each activation call's side in the
kernels' run and gives the plain run those sides; ``compare_kinks`` holds
the flips themselves within the forward tolerance of zero (1e-4 of the
call's largest |x| + 1e-5, at most 1e-5 of a call's inputs).  Here, at a
small size (two narrow conv layers with batchnorm and leaky_relu, one
131072-element call), the "kernel" run is the plain forward with one input
put across the kink by 1e-7:

* today's comparison (the plain run on its own sides) fails the step-1
  check; part A's passes and reads one flip;
* a real error still fails: a flip far from zero fails the flip bound, a
  weight perturbed by 1e-3 of its largest fails part A's comparison;
* a call count that differs fails;
* the kernels' epilogue outputs map onto the plain epilogue's input (the
  uncropped image and the pixels the output holds) at both 2D corners.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core import DeconvDims, conv_same_dims
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def _params(seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    p = {}
    for i, (n, m) in enumerate(((3, 8), (8, 8))):
        p[f"conv{i}"] = {"w": t(3, 3, n, m, scale=0.3), "b": t(m, scale=0.1)}
        p[f"conv{i}_bn"] = {"scale": 1 + t(m, scale=0.1), "bias": t(m, scale=0.1)}
    return p


def _net(p, x, at=None, extra_call=False):
    """conv K3S1 3 -> 8, BN, leaky_relu, conv K3S2 8 -> 8, BN, leaky_relu;
    ``at`` = (index, value) sets one input of the first leaky_relu to value
    (its gradient flows as any other's)."""
    h = x
    for i, stride in ((0, 1), (1, 2)):
        h = L.conv2d(p[f"conv{i}"], h, stride=stride)
        h, _ = L.batchnorm({**p[f"conv{i}_bn"], "mean": 0, "var": 1}, h, training=True)
        if i == 0 and at is not None:
            flat = h.reshape(-1)
            onehot = torch.zeros_like(flat)
            onehot[at[0]] = 1.0
            h = (flat + onehot * (at[1] - flat.detach()[at[0]])).reshape(h.shape)
        h = L.leaky_relu(h)
        if extra_call:
            h = L.ACTIVATIONS["relu"](h + 1.0)
    return (h * h).mean() + h.mean()


def _grads(p0, x, **kw):
    p = {k: {kk: v.clone().requires_grad_(True) for kk, v in leaf.items()} for k, leaf in p0.items()}
    keys = [(k, kk) for k, leaf in p.items() for kk in leaf]
    g = torch.autograd.grad(_net(p, x, **kw), [p[k][kk] for k, kk in keys])
    out = {}
    for (k, kk), v in zip(keys, g):
        out.setdefault(k, {})[kk] = v
    return out


@pytest.fixture(scope="module")
def case():
    p = _params()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        h, _ = L.batchnorm({**p["conv0_bn"], "mean": 0, "var": 1}, L.conv2d(p["conv0"], x), training=True)
    assert h.numel() == 131072  # 1e-5 of it: one flip
    return p, x, int(h.abs().reshape(-1).argmin())  # the input nearest the kink


def _runs(p, x, kernel_kw, plain_kw):
    """The "kernel" run recording its sides, the plain run on them."""
    k_calls, p_calls = [], []
    with chip_smoke.kink_sides(k_calls):
        gk = _grads(p, x, **kernel_kw)
    with chip_smoke.kink_sides(p_calls, follow=k_calls):
        gp = _grads(p, x, **plain_kw)
    return gk, gp, k_calls, p_calls


def test_a_flip_by_1e7_fails_todays_check_and_passes_the_kink_check(case):
    p, x, idx = case
    gk, gp, k_calls, p_calls = _runs(p, x, dict(at=(idx, -1e-7)), dict(at=(idx, 1e-7)))
    own = _grads(p, x, at=(idx, 1e-7))  # the plain run on its own side: today's comparison
    with pytest.raises(SystemExit, match="step-1 AdamW first moment"):
        chip_smoke.check_first_moments((gk,), (own,))
    share = chip_smoke.check_first_moments((gk,), (gp,))
    assert share < 0.01
    got = chip_smoke.compare_kinks(k_calls, p_calls)
    assert got["kink_calls"] == 2 and got["kink_flips"] == 1
    assert got["kink_flips_by_call"] == [dict(call=0, act="leaky_relu", flips=1, of=131072)]
    assert 0 < got["max_flip_abs_over_std"] < 1e-6 and got["max_flip_share_of_bound"] < 0.1


def test_the_plain_run_takes_the_kernel_runs_side_in_value_and_slope(case):
    p, x, idx = case
    gk, gp, _, _ = _runs(p, x, dict(at=(idx, -1e-7)), dict(at=(idx, -1e-7)))
    for k, leaf in gk.items():  # the same forward: the same gradients, bit for bit
        for kk, v in leaf.items():
            assert torch.equal(v, gp[k][kk]), (k, kk)


def test_a_flip_far_from_zero_fails_the_flip_bound(case):
    p, x, _ = case
    with torch.no_grad():
        h, _ = L.batchnorm({**p["conv0_bn"], "mean": 0, "var": 1}, L.conv2d(p["conv0"], x), training=True)
    far = int(h.abs().reshape(-1).argmax())
    value = float(h.reshape(-1)[far])
    _, _, k_calls, p_calls = _runs(p, x, dict(at=(far, -value)), dict(at=(far, value)))
    with pytest.raises(SystemExit, match="other side at"):
        chip_smoke.compare_kinks(k_calls, p_calls)


def test_a_weight_perturbed_by_1e3_of_its_largest_fails(case):
    p, x, _ = case
    w = p["conv0"]["w"]
    bad = {**p, "conv0": {**p["conv0"], "w": w + 1e-3 * w.abs().max() * torch.sign(w)}}
    k_calls, p_calls = [], []
    with chip_smoke.kink_sides(k_calls):
        gk = _grads(bad, x)
    with chip_smoke.kink_sides(p_calls, follow=k_calls):
        gp = _grads(p, x)
    # both halves of part A see it: the flips (far more than 1e-5 of the call) and the gradients
    with pytest.raises(SystemExit, match="inputs on the other side"):
        chip_smoke.compare_kinks(k_calls, p_calls)
    with pytest.raises(SystemExit, match="step-1 AdamW first moment of G.conv0.w"):
        chip_smoke.check_first_moments((gk,), (gp,))


def test_a_call_count_that_differs_fails(case):
    p, x, _ = case
    k_calls, p_calls = [], []
    with chip_smoke.kink_sides(k_calls):
        _grads(p, x)
    with chip_smoke.kink_sides(p_calls, follow=k_calls), pytest.raises(SystemExit, match="does not match"):
        _grads(p, x, extra_call=True)  # more calls than the kernel run made
    p_calls = []
    with chip_smoke.kink_sides(p_calls, follow=k_calls):
        _grads(p, x)
    assert chip_smoke.compare_kinks(k_calls, p_calls)["kink_flips"] == 0
    with pytest.raises(SystemExit, match="the plain run 1"):  # fewer calls than the kernel run made
        chip_smoke.compare_kinks(k_calls, p_calls[:1])


@pytest.mark.parametrize("corner,out_mode", [("conv", "cells"), ("conv", "nhwc"), ("deconv", "cells"),
                                             ("deconv", "nhwc")])
def test_kernel_epilogue_outputs_map_onto_the_plain_epilogue_input(corner, out_mode):
    """``_epilogue_image`` of a wrapper's leaky_relu output equals the plain
    epilogue's output at every pixel the output holds, and the side read off
    its sign is the plain input's."""
    rng = np.random.default_rng(3)
    B, H, N, M = 2, 9, 4, 8
    x = torch.from_numpy(rng.standard_normal((B, H, H, N)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(M)).astype(np.float32))
    seen = []
    real = E.epilogue_apply_ref

    def spy(y, scale, b, act):
        seen.append(y.float() + b)
        return real(y, scale, b, act)

    if corner == "conv":
        cd = conv_same_dims(4, 2, H)
        w = torch.from_numpy((0.3 * rng.standard_normal((4, 4, N, M))).astype(np.float32))
        packed, cells = ops.prepack_conv(w, cd), ops.conv_cells_from_image(x, cd)
        ty = tx = -(-cd.out_size(H) // 2)
        kw = dict(pos_idx=ops.conv_packed_layout(cd)[0], m=2, n=4, ty=ty, tx=tx, s2=4, out_mode=out_mode,
                  activation="leaky_relu", out_h=cd.out_size(H), out_w=cd.out_size(H))
        name, fn, module = "conv_fused_engine", E.conv_fused_engine, E._ref
    else:
        dims = DeconvDims(5, 2, 2, 1)
        w = torch.from_numpy((0.3 * rng.standard_normal((5, 5, N, M))).astype(np.float32))
        packed, cells = ops.prepack(w, dims), ops.cells_from_image(x, dims)
        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        ty = tx = -(-dims.j_extent(H) // 2)
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=2, n=4, ty=ty, tx=tx, out_mode=out_mode,
                  activation="leaky_relu", stride=2, padding=2, out_h=dims.out_size(H), out_w=dims.out_size(H))
        name, fn, module = "fused_engine", E.fused_engine, E._ref
    try:
        module.epilogue_apply_ref = spy
        out = fn(cells, packed.ww, packed.inv, bias=bias, **kw)
    finally:
        module.epilogue_apply_ref = real
    (pre,) = seen
    img, valid = chip_smoke._epilogue_image(name, out, kw)
    assert img.shape == pre.shape and valid.shape == (1, *pre.shape[1:3], 1)
    held = valid.expand_as(pre)
    assert held.any() and not held.all()  # the output holds the window, not the tiles' margin
    want = real(pre, None, None, "leaky_relu")
    np.testing.assert_array_equal(img[held].numpy(), want[held].numpy())
    assert torch.equal(chip_smoke._side(img, "leaky_relu")[held], chip_smoke._side(pre, "leaky_relu")[held])
