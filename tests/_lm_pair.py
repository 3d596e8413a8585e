"""Helpers of the LM parity tests: numpy / JAX trees to torch and back,
the gradient tolerance (1e-4 of the tree's largest gradient plus 1e-5),
JAX's forward and vector-Jacobian product in one jitted call, and for the
mesh tests a stand-in mesh and a numpy array's block under a spec."""
import jax
import numpy as np
import torch

FWD = dict(atol=1e-5, rtol=1e-4)


def to_t(tree):
    """A numpy / JAX tree (dicts, NamedTuples) as fp32 torch tensors."""
    if isinstance(tree, dict):
        return {k: to_t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(to_t(v) for v in tree))
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(to_np(v) for v in tree))
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def pick(tree, key_path):
    """The leaf of a torch tree at a JAX key path (dict keys, sequence
    indices, NamedTuple fields)."""
    for k in key_path:
        tree = tree[k.key] if hasattr(k, "key") else tree[k.idx] if hasattr(k, "idx") else getattr(tree, k.name)
    return tree


def close_tree(got, want, what="", **tol):
    """Every leaf of the torch tree ``got`` against JAX's ``want``."""
    for kp, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(to_np(pick(got, kp)), np.asarray(w), **(tol or FWD),
                                   err_msg=f"{what}{jax.tree_util.keystr(kp)}")


def close_grads(got, want, path=""):
    """Every leaf within 1e-4 of the tree's largest gradient plus 1e-5."""
    gl = jax.tree_util.tree_leaves_with_path(want)
    top = max(float(np.abs(np.asarray(v)).max()) for _, v in gl)
    for kp, v in gl:
        g = pick(got, kp)
        np.testing.assert_allclose(to_np(g), np.asarray(v), atol=1e-4 * top + 1e-5, rtol=0,
                                   err_msg=f"{path}{jax.tree_util.keystr(kp)}")


def shapes(tree):
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def leaf_params(tree):
    """The torch tree's leaves as fresh leaf tensors that want gradients."""
    if isinstance(tree, dict):
        return {k: leaf_params(v) for k, v in tree.items()}
    return tree.clone().requires_grad_(True)


def grads(tree):
    """The leaves' gradients; zeros for a leaf the loss does not reach (as
    JAX gives them)."""
    if isinstance(tree, dict):
        return {k: grads(v) for k, v in tree.items()}
    return torch.zeros_like(tree) if tree.grad is None else tree.grad


# XLA's CPU backend at optimisation level 0 and without its expensive LLVM
# passes: the same program, compiled in about 60% of the time (a jamba
# train step's gradients move by ~4e-6 of their largest, 1/25 of the
# gradient tolerance).
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jit(f):
    """``jax.jit(f)`` compiled with ``FAST_COMPILE``, once per argument
    structure and shapes."""
    jf, compiled = jax.jit(f), {}

    def run(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jf.lower(*args).compile(compiler_options=FAST_COMPILE)
        return compiled[key](*args)

    return run


def jax_vjp(f, args, seed=0):
    """(f's outputs, a numpy cotangent per output from ``seed``, the vjp of
    those cotangents) of JAX's ``f`` at ``args``: one jitted call."""
    shapes = jax.eval_shape(f, *args)
    rng = np.random.default_rng(seed)
    cts = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)

    @jit
    def run(args, cts):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(cts)

    out, grads = run(tuple(args), cts)
    return out, cts, grads


def dot(out, cts):
    """sum(out * ct) over matching trees of torch outputs and numpy
    cotangents: the scalar whose backward is the vjp."""
    if isinstance(out, (tuple, list)):
        return sum(dot(o, c) for o, c in zip(out, cts))
    return (out * torch.from_numpy(np.asarray(cts))).sum()


def lm_params(cfg, seed=0):
    """A numpy LM tree in JAX's layout (``lm_init``'s tree structure and
    shapes, from ``jax.eval_shape``) drawn from numpy: weights at a
    1/sqrt(fan-in) scale, norm scales and SSM skips near 1, non-zero
    biases, the SSM's A_log and dt_bias at their init plus noise."""
    from repro.models import lm as JLM

    rng = np.random.default_rng(seed)
    structs = jax.eval_shape(lambda k: JLM.lm_init(k, cfg, jax.numpy.float32), jax.random.PRNGKey(0))

    def draw(kp, s):
        name = jax.tree_util.keystr(kp)
        shape = s.shape
        noise = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['A_log']"):
            return (np.log(np.arange(1, shape[-1] + 1, dtype=np.float32)) + 0.05 * noise).astype(np.float32)
        if name.endswith("['dt_bias']"):
            return (np.log(np.expm1(0.01)) + 0.1 * noise).astype(np.float32)
        if name.endswith("['scale']") or name.endswith("['D']"):
            return (1 + 0.1 * noise).astype(np.float32)
        if name.endswith("['b']") or name.endswith("['bias']"):
            return (0.05 * noise).astype(np.float32)
        if name.endswith("['table']") or "['head']" in name:
            return (0.02 * noise).astype(np.float32)
        return (noise / np.sqrt(shape[-2] if len(shape) >= 2 else 1)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, structs)


class StandIn:
    """What the spec rules read of a mesh: ``shape`` and ``axis_names``."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def np_block(x, spec, coords, mesh_shape):
    """The block of numpy ``x`` at mesh ``coords`` under ``spec`` (row-major
    over each dimension's axes, the reference's layout)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in names:
            n, idx = n * mesh_shape[a], idx * mesh_shape[a] + coords[a]
        blk = x.shape[dim] // n
        x = np.take(x, np.arange(idx * blk, (idx + 1) * blk), axis=dim)
    return x
