"""Quickstart on the PyTorch port: the paper's algorithm in a minute.

Builds a DCGAN deconv layer, runs every deconv implementation of the port
against the standard (scatter) deconvolution, and prints the
multiplication counts behind the paper's speedup.  The engine paths (the
unfused engine, the fused pre-PE engine, the cell-chained epilogue engine)
run their plain PyTorch versions on CPU tensors and, where a CUDA card is
present, also the hand-written kernels on it.  Exits 1 if any
implementation disagrees beyond its tolerance.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""
import sys

import numpy as np
import torch

from repro_torch.core import DeconvDims, lax_deconv2d, plan, standard_deconv2d, tdc_deconv2d, winograd_deconv2d
from repro_torch.core import zero_padded_deconv2d
from repro_torch.core.complexity import LayerShape, mults_tdc, mults_winograd, mults_zero_padded
from repro_torch.kernels import engine
from repro_torch.kernels import ops

# DCGAN layer 2: 8x8x512 -> 16x16x256, K_D=5, S=2 (Table I row 1), channels scaled down
dims = DeconvDims(kernel=5, stride=2, padding=2, output_padding=1)
rng = np.random.default_rng(0)
x_np = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
w_np = rng.standard_normal((5, 5, 64, 32)).astype(np.float32)
x, w = torch.from_numpy(x_np), torch.from_numpy(w_np)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ref = standard_deconv2d(x, w, dims)
print(f"output: {tuple(x.shape)} -> {tuple(ref.shape)}")
failed = []


def check(name, got, bf16=False):
    got = got.detach().float().cpu()
    err = float((got - ref).abs().max())
    tol = (2e-2 if bf16 else 1e-4) * float(ref.abs().max()) + 1e-5
    print(f"  {name:56s} max|err| = {err:.2e}{'' if err <= tol else f'  > {tol:.2e} FAILED'}")
    if not err <= tol:
        failed.append(name)


for name, fn, bf16 in [
    ("zero-padded [10-12]", zero_padded_deconv2d, False),
    ("TDC [14]", tdc_deconv2d, False),
    ("conv_transpose2d (lax)", lax_deconv2d, False),
    ("Winograd-TDC (this paper, plain PyTorch)", winograd_deconv2d, False),
    ("  bf16 operands (ref_bf16)", lambda *a: winograd_deconv2d(*a, bf16=True), True),
    ("  bf16, no zero skip (ref_dense)", lambda *a: winograd_deconv2d(*a, dense=True, bf16=True), True),
]:
    check(name, fn(x, w, dims), bf16)


def engines(device: str) -> None:
    """The engine paths on ``device``: the CUDA kernels on a card, their
    plain versions on the CPU (the wrappers pick by the tensors' device)."""
    xd, wd = x.to(device), w.to(device)
    where = "kernel on the card" if device == "cuda" else "plain version, CPU"
    check(f"unfused engine, TPU kernel 1 ({where})", ops.winograd_deconv2d_fused(xd, wd, dims))
    check(f"fused pre-PE engine, TPU kernel 2 ({where})", ops.winograd_deconv2d_fused(xd, wd, dims, fuse_pre=True))
    packed = ops.prepack(wd, dims)
    cells = ops.cells_from_image(xd, dims)
    check(f"cell-chained engine, TPU kernel 3 ({where})",
          ops.winograd_deconv2d_cells(cells, packed, dims, tuple(x.shape[1:3])))


engines("cpu")
if torch.cuda.is_available():
    for fn, attr in ((engine.domain_engine, "launches"), (engine.fused_engine, "scratch_launches"),
                     (engine.fused_engine, "launches")):
        setattr(fn, attr, 0)
    engines("cuda")
    torch.cuda.synchronize()
    launches = (engine.domain_engine.launches, engine.fused_engine.scratch_launches, engine.fused_engine.launches)
    print(f"  kernel launches (1, 2, 3): {launches}")
    if launches != (1, 1, 1):
        failed.append("the card's engine paths did not each launch their kernel once")
else:
    print("  (no CUDA card: the hand-written kernels were not run)")

sp = plan(dims)
print(f"\nstructural sparsity for K_D=5,S=2: C(K_C) = {sp.c_total} (paper: 49), "
      f"cases = {sorted(sp.case.ravel().tolist())} (paper: one Case-1, two Case-2, one Case-3)")

layer = LayerShape(8, 8, 512, 256, dims)
print("\nmultiplies for the full 512->256 layer:")
print(f"  zero-padded : {mults_zero_padded(layer):.3e}")
print(f"  TDC         : {mults_tdc(layer):.3e}")
print(f"  Winograd-TDC: {mults_winograd(layer):.3e}  "
      f"({mults_zero_padded(layer) / mults_winograd(layer):.2f}x fewer than zero-padded)")
if failed:
    print(f"\nFAILED: {failed}")
    sys.exit(1)
