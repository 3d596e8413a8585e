"""Hand-written Hopper kernels, their plain PyTorch versions, and the layout
and entry-point functions around them."""
