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
