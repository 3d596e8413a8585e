"""The kernels' build cache: the library's name hashes every source and
header it compiles, so that an edit to a shared header builds anew.  (The
build itself needs nvcc and runs on the card, through chip_smoke.py.)"""
import shutil

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
    """Kernel 1's plan takes the packed positions and a requested
    instantiation and returns the tile (BT, BM, instantiation); its launch
    takes the instantiation and the split, then the scratch (the split's
    partials or the tensor cores' packed weights): the order
    ``engine._domain_plan`` and ``engine._domain_fwd`` pass them in.  The
    tensor cores' chain is the source's constant, not an argument."""
    import re

    src = (_build.CSRC / "domain_engine.cu").read_text()

    def params(name):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        return [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]

    assert params("domain_engine_fwd_plan") == ["T", "N", "M", "S2", "C", "want", "device", "splits",
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
