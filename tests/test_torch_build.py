"""The kernels' build cache: the library's name hashes every source and
header it compiles, so that an edit to a shared header builds anew.  (The
build itself needs nvcc and runs on the card, through chip_smoke.py.)"""
import shutil

import pytest

from repro_torch.kernels import _build


def test_library_path_hashes_every_source_and_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    assert before == _build.library_path()
    with open(headers[0], "a") as f:
        f.write("\n// edited\n")
    edited = _build.library_path()
    assert edited != before
    with open(csrc / _build.SOURCES[0], "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() not in (before, edited)


def test_every_entry_point_binds_as_many_arguments_as_its_c_definition():
    """ctypes passes what _SIGNATURES lists; a count that differs from the C
    definition corrupts the call (a pointer read as an int)."""
    import re

    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    for name, argtypes in _build._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len([a for a in m.group(1).split(",") if a.strip()]) == len(argtypes), name


def test_every_c_entry_point_is_bound():
    """Each ``extern "C"`` function of the sources has its argtypes in
    _SIGNATURES (a new entry point, such as a plan's, bound with ctypes'
    default int arguments would cut its pointers)."""
    import re

    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    defined = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert {"conv_engine_fwd_conf", "conv_engine_fwd_plan", "fused_engine_plan"} <= defined
    assert defined == set(_build._SIGNATURES)


def test_unfused_forward_entry_points_carry_the_plan_the_wrapper_reads():
    """Kernel 1's plan takes the packed positions, a requested
    instantiation and a requested N split and returns the tile (BT, BM, instantiation); its launch
    takes the instantiation and the split, then the scratch (the split's
    partials or the tensor cores' packed weights): the order
    ``engine._domain_plan`` and ``engine._domain_fwd`` pass them in.  The
    tensor cores' chain is the source's constant, not an argument."""
    import re

    src = (_build.CSRC / "domain_engine.cu").read_text()

    def params(name):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        return [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]

    assert params("domain_engine_fwd_plan") == ["T", "N", "M", "S2", "C", "want", "want_splits", "device", "splits",
                                                "scratch_floats", "counters", "tile"]
    assert params("domain_engine_fwd_f32") == ["xw", "ww", "inv", "pos", "sub_off", "y", "T", "N", "M", "S2", "C",
                                               "conf", "splits", "scratch", "counters", "stream"]
    # the tensor maps' encoder comes through the runtime, so the link needs no libcuda
    assert "cudaGetDriverEntryPoint" in src and "cuTensorMapEncodeTiled" in src


def _activate_cases(src: str) -> dict:
    """``activate``'s switch in one source: {case label: returned C expression}."""
    import re

    body = re.search(r"float activate\(float v, int act\) \{(.*?)\n\}", src, re.S)
    assert body, "no activate() in the source"
    return {m.group(1): m.group(2).strip()
            for m in re.finditer(r"(case \d+|default):\s*return ([^;]+);", body.group(1))}


def _numpy_model(expr: str):
    """A numpy function of ``v`` computing the C expression as the card does:
    ``fmaxf`` returns its other operand for a NaN (IEEE maxNum, as np.fmax),
    a comparison with NaN is false, ``tanhf`` keeps NaN."""
    import re

    import numpy as np

    py = re.sub(r"(\d+\.\d*)f\b", r"\1", expr).replace("fmaxf", "np.fmax").replace("tanhf", "np.tanh")
    m = re.fullmatch(r"(.+?)\?(.+?):(.+)", py)
    if m:
        py = f"np.where({m.group(1)}, {m.group(2)}, {m.group(3)})"
    return lambda v: eval(py, {"np": np, "v": v})  # noqa: S307 - the repo's own source


def test_every_epilogue_activation_keeps_nan_as_the_plain_version():
    """Each kernel epilogue's ``activate`` (the deconv corner, the conv corner,
    the 1D engine) matches ``epilogue_apply_ref`` value for value, NaN
    positions included: relu as ``fmaxf(v, 0.0f)`` mapped a NaN to 0, where
    ``torch.clamp_min`` and the reference's ``jnp.maximum`` keep it."""
    import re

    import numpy as np
    import torch

    from repro_torch.kernels.engine import _ACT_CODES
    from repro_torch.kernels.ref import epilogue_apply_ref

    v = np.array([np.nan, -np.inf, -2.5, -1e-30, -0.0, 0.0, 1e-30, 0.75, 3.0, np.inf], np.float32)
    sources = [p for p in sorted(_build.CSRC.glob("*.cu")) if "float activate(" in p.read_text()]
    assert {p.name for p in sources} == {"fused_engine.cu", "conv_engine.cu", "engine1d.cu"}
    for path in sources:
        cases = _activate_cases(path.read_text())
        assert not any(re.search(r"fmaxf\(\s*v\s*,\s*0", e) for e in cases.values()), path.name
        for act, code in _ACT_CODES.items():
            expr = cases.get(f"case {code}", cases["default"])
            with np.errstate(invalid="ignore"):
                got = np.asarray(_numpy_model(expr)(v), np.float32)
            want = epilogue_apply_ref(torch.from_numpy(v), None, None, act).numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{path.name} {act}")
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=f"{path.name} {act}")


# ------------------------------------------------------------ the instantiation table against the sources
# each CUDA wrapper -> its source and the ``*_takes`` switch beside the dispatch (one case an instantiation,
# its name in a comment)
TAKES = {
    "fused_engine": ("fused_engine.cu", "fwd_takes"),
    "fused_engine_bwd_x": ("fused_engine_bwd.cu", "bx_takes"),
    "fused_engine_bwd_w": ("fused_engine_bwd.cu", "bw_takes"),
    "conv_fused_engine": ("conv_engine.cu", "fwd_takes"),
    "conv_fused_engine_bwd_x": ("conv_engine.cu", "bx_takes"),
    "conv_fused_engine_bwd_w": ("conv_engine.cu", "bw_takes"),
    "domain_engine": ("domain_engine.cu", "fwd_takes"),
    "domain_engine_bwd_x": ("domain_engine.cu", "bx_takes"),
    "domain_engine_bwd_w": ("domain_engine.cu", "bw_takes"),
    "winograd_conv1d_fused_engine": ("engine1d.cu", "takes"),
}


def _few_max_c(src: str) -> int:
    """The most packed positions the unfused forward's few-channel kernel
    takes: fcf::smem_bytes(C) <= kMaxSmem, from the source's constants."""
    import re

    ns = re.search(r"namespace fcf \{(.*?)\}  // namespace fcf", src, re.S).group(1)
    k = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (\w+) = (\d+);", ns)}
    k["kMaxPos"] = k["kMaxSub"] = 16  # bwd_x_core.cuh
    smem_max = int(re.search(r"constexpr size_t kMaxSmem = (\d+);", src).group(1))
    x = k["BT"] * (k["kMaxPos"] * k["BN"] + 4)

    def smem(c):
        return 4 * (k["ST"] * x + k["ST"] * c * k["BN"] * k["MC"] + c * 4) + 4 * (c + k["kMaxSub"] + 1)

    return max(c for c in range(1, 4096) if smem(c) <= smem_max)


def _takes_cases(kernel):
    """The source's switch for ``kernel``: [(case number, C expression, name)]."""
    import re

    from repro_torch.kernels import _build

    src_name, fn = TAKES[kernel]
    src = (_build.CSRC / src_name).read_text()
    body = re.search(r"\nbool " + fn + r"\(int conf[^)]*\) \{\s*switch \(conf\) \{(.*?)\n  \}", src, re.S)
    assert body, f"no {fn} switch in {src_name}"
    cases = [(int(m.group(1)), m.group(2).strip(), m.group(3))
             for m in re.finditer(r"case (\d+): return ([^;]+);\s*// (\w+)", body.group(1))]
    return cases, src


@pytest.mark.parametrize("kernel", list(TAKES))
def test_instantiations_are_each_sources_dispatch(kernel):
    """engine.INSTANTIATIONS / SHAPE_CONDITIONS read against the source: one
    case per instantiation, numbered in the table's order (the ``want`` the
    C plan takes), named alike, and each C condition the table's Python
    predicate on a grid of shapes; the smoke's profile names cover every
    instantiation, and each template signature it holds is the one the
    source dispatches for that number."""
    import re

    import chip_smoke
    from repro_torch.kernels import engine as E

    cases, src = _takes_cases(kernel)
    names = E.INSTANTIATIONS[kernel]
    assert [c[0] for c in cases] == list(range(len(names)))
    assert tuple(c[2] for c in cases) == names
    assert len(E.SHAPE_CONDITIONS[kernel]) == len(E.SPLIT_LIMITS[kernel]) == len(names)
    consts = {"kFewMaxC": _few_max_c(src)} if "kFewMaxC" in src else {}
    grid = [dict(N=N, M=M, S=S, S2=S * S, C=C, M2=M2, N2=N2)
            for N in (3, 4, 6, 16, 32, 256) for M in (1, 3, 4, 6, 8, 12, 16, 32, 128)
            for S in (1, 2, 3, 4, 5) for C in (1, 186, 187) for M2 in (2, 4) for N2 in (2, 4, 5, 16)]
    for k, expr, name in cases:
        py = expr.replace("&&", " and ").replace("||", " or ").replace("true", "True")
        for env in grid:
            want = eval(py, {"__builtins__": {}}, {**consts, **env})  # noqa: S307 (the source's own expression)
            assert E.SHAPE_CONDITIONS[kernel][k](**env) == want, (kernel, name, env, expr)
    assert set(chip_smoke.INSTANTIATION_KERNELS[kernel]) == set(names)
    flat = src.replace(" ", "")
    for k, name in enumerate(names):
        sig = chip_smoke.INSTANTIATION_KERNELS[kernel][name][1]
        if sig is None:
            continue
        hits = [m.group(1) for m in re.finditer(r"(?:if\(conf==(\d)\))?returnf\([A-Za-z]*<?(?:\w+::)?"
                                                + re.escape(sig), flat)]
        assert hits, (kernel, name, sig)
        assert str(k) in hits or (hits == [None] and k == len(names) - 1), (kernel, name, hits)


def test_few_channel_limit_is_the_sources():
    from repro_torch.kernels import _build
    from repro_torch.kernels import engine as E

    most = _few_max_c((_build.CSRC / "domain_engine.cu").read_text())
    assert E._FEW_MAX_C == most
    few = E.SHAPE_CONDITIONS["domain_engine"][2]
    assert few(N=4, M=3, C=most) and not few(N=4, M=3, C=most + 1)


def _split_limit_of_source(kernel: str, k: int, src: str):
    """``kernel``'s instantiation k's most splits as a function of the shape,
    read off its source: the C plan's refusal of a forced split, and the
    chunks it counts (the CUDA-core forwards' BN channels of with_conf, a
    bwd_w's BT tiles of its with_bw_conf: a bwdw::Core's fifth argument, a
    CUDA-core BwConf's fourth or BwCfg's BT)."""
    import math
    import re

    plan_of = {"fused_engine": "fused_engine_plan", "fused_engine_bwd_x": "fused_engine_bwd_x_plan",
               "fused_engine_bwd_w": "fused_engine_bwd_w_plan", "conv_fused_engine": "conv_engine_fwd_plan",
               "conv_fused_engine_bwd_x": "conv_engine_bwd_x_plan", "conv_fused_engine_bwd_w": "conv_engine_bwd_w_plan",
               "domain_engine": "domain_engine_fwd_plan", "domain_engine_bwd_x": "domain_engine_bwd_x_plan",
               "domain_engine_bwd_w": "domain_engine_bwd_w_plan", "winograd_conv1d_fused_engine": "engine1d_plan"}
    plan = re.search(r'extern "C" int ' + plan_of[kernel] + r"\(.*?\n\}", src, re.S).group(0)
    if "want_splits" not in plan.split(")")[0]:  # the plan takes no want_splits: its kernel never splits
        return lambda **s: 1
    if kernel in ("fused_engine", "domain_engine"):
        chunks = re.search(r"want_splits > 1 && \((?:conf|want) != 0 \|\| want_splits > (\w+)\(N, M\)\)", plan)
        assert chunks, plan_of[kernel]
        body = re.search(r"int with_(?:fwd_)?conf\(int M, F&& f\) \{(.*?)\n\}", src, re.S).group(1)
        cond, wide = re.search(r"if \(([^)]*)\) return f\(\w+<\d+, \d+, \d+, (\d+), \d+>\{\}\);", body).groups()
        narrow = re.findall(r"return f\(\w+<\d+, \d+, \d+, (\d+), \d+>\{\}\);", body)[-1]
        py = cond.replace("&&", " and ")
        if k:
            return lambda **s: 1
        return lambda N, M, **s: math.ceil(N / int(wide if eval(py, {}, {"M": M}) else narrow))  # noqa: S307
    if kernel == "conv_fused_engine":
        assert "want_splits > 1 && (conf == 0 || want_splits > npass)" in plan
        from repro_torch.kernels import engine as E

        return (lambda **s: 1) if k == 0 else (lambda pos_idx, S2, **s: E._conv_passes(tuple(pos_idx), S2))
    assert "if (want_splits > chunks || want_splits > 65535) return (int)cudaErrorInvalidValue;" in plan
    body = re.search(r"int with_bw_conf\([^)]*\) \{(.*?)\n\}", src, re.S).group(1)
    mma = {int(c): int(bt) for c, bt in
           re.findall(r"if \(conf == (\d)\) return f\(BwMma<bwdw::Core<\d+, \d+, \d+, \d+, (\d+)", body)}
    if k:
        bt_of = lambda N: mma[k]  # noqa: E731
    elif kernel == "conv_fused_engine_bwd_w":  # BwConf<G, NT_N, NT_M, BT, ...>: N % 4 == 0 first, then the ragged
        bts = [int(b) for b in re.findall(r"BwConf<\d+, \d+, \d+, (\d+)", body)]
        assert "if (N % 4 == 0) return f(BwConf<" in body and len(set(bts[1:])) == 1
        bt_of = lambda N: bts[0] if N % 4 == 0 else bts[1]  # noqa: E731
    else:
        bt = int(re.search(r"struct BwCfg \{[^}]*?BT = (\d+);", src, re.S).group(1))
        bt_of = lambda N: bt  # noqa: E731
    return lambda N, T, **s: min(math.ceil(T / bt_of(N)), 65535)


@pytest.mark.parametrize("kernel", list(TAKES))
def test_split_limits_are_the_sources(kernel):
    """engine.SPLIT_LIMITS read against the source: at every instantiation
    and on a grid of shapes, the most splits the table allows is the most
    the C plan takes (the count past which it returns
    cudaErrorInvalidValue)."""
    from repro_torch.kernels import engine as E

    cases, src = _takes_cases(kernel)
    grid = [dict(N=N, M=M, T=T, S=2, S2=4, C=36, M2=4, N2=16, pos_idx=pos)
            for N in (3, 4, 64, 100, 512) for M in (3, 16, 32, 36, 64)
            for T in (1, 3, 4, 5, 17, 1000, 65535 * 16 + 1, 2**22)
            for pos in (tuple(range(36)), tuple(range(0, 64, 2)), (0, 17, 34, 51))]
    for k, _, name in cases:
        want = _split_limit_of_source(kernel, k, src)
        for env in grid:
            assert E.SPLIT_LIMITS[kernel][k](**env) == want(**env), (kernel, name, env)


_PLAN_PARAMS = {
    "fused_engine_plan": ["B", "ty", "tx", "N", "M", "S", "want", "want_splits", "device", "splits", "scratch_floats",
                          "counters", "tile"],
    "fused_engine_bwd_x_plan": ["B", "gy", "gx", "ty", "tx", "M", "want", "R", "W", "TC", "BT", "conf"],
    "fused_engine_bwd_w_plan": ["B", "ty", "tx", "N", "M", "S", "C", "want", "want_splits", "device", "splits",
                                "scratch_floats", "counters", "tile"],
    "conv_engine_fwd_conf": ["N", "M", "S2", "want", "tile"],
    "conv_engine_fwd_plan": ["B", "ty", "tx", "N", "M", "S2", "C", "npass", "nslot", "npos", "want", "want_splits",
                             "device", "splits", "scratch_floats", "counters"],
    "conv_engine_bwd_x_plan": ["B", "gy", "gx", "ty", "tx", "N", "M", "want", "R", "W", "TC", "tile"],
    "conv_engine_bwd_w_plan": ["B", "ty", "tx", "N", "M", "S2", "C", "want", "want_splits", "device", "splits",
                               "scratch_floats", "counters", "tile"],
    "domain_engine_bwd_x_plan": ["M", "M2", "N2", "want", "conf"],
    "domain_engine_bwd_w_plan": ["T", "N", "M", "S2", "M2", "C", "want", "want_splits", "device", "splits",
                                 "scratch_floats", "counters", "tile"],
    "engine1d_plan": ["B", "ty", "M", "want", "tile"],
    # the launches: each takes the instantiation its plan handed out (the tail of its parameters)
    "fused_engine_epi_f32": ["act", "conf", "C", "npass", "nslot", "npos", "splits", "partial", "counters", "stream"],
    "fused_engine_bwd_x_f32": ["R", "W", "TC", "C", "conf", "stream"],
    "fused_engine_bwd_w_f32": ["C", "conf", "splits", "partial", "counters", "stream"],
    "conv_engine_fwd_f32": ["act", "C", "conf", "npass", "nslot", "npos", "splits", "partial", "counters", "stream"],
    "conv_engine_bwd_x_f32": ["R", "W", "TC", "conf", "stream"],
    "conv_engine_bwd_w_f32": ["C", "conf", "splits", "partial", "counters", "stream"],
    "domain_engine_fwd_f32": ["C", "conf", "splits", "scratch", "counters", "stream"],
    "domain_engine_bwd_x_f32": ["N2", "C", "conf", "stream"],
    "domain_engine_bwd_w_f32": ["N2", "C", "conf", "splits", "partial", "counters", "stream"],
    "engine1d_f32": ["act", "conf", "npass", "nslot", "npos", "stream"],
}


@pytest.mark.parametrize("name", list(_PLAN_PARAMS))
def test_entry_points_take_the_requested_instantiation_in_order(name):
    """Every plan takes ``want`` (and, where its kernel splits,
    ``want_splits``) before its outputs, and hands out the instantiation;
    every launch takes it back as ``conf``: the order ``engine``'s plan
    functions and wrappers pass them in.  (A plan's full list; a launch's
    tail.)"""
    import re

    from repro_torch.kernels import _build

    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    params = [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]
    want = _PLAN_PARAMS[name]
    assert (params if name.endswith(("_plan", "_conf")) else params[-len(want):]) == want
