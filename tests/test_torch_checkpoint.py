"""The port's checkpoints against the reference's ``train/checkpoint.py``:
one on-disk format, so a checkpoint written by either package restores in
the other (params, ``OptState``s with their step, a bf16 leaf), with equal
manifests (key paths, shapes, logical dtypes, per-leaf sha256); and the
reference's integrity cases (``tests/test_checkpoint_integrity.py``,
``tests/test_train_resilience.py``) on the port: a bit flip, a truncated
leaf, a damaged manifest, a manifest without sha256, the fallback to an
older step, none valid, fsync of every file, the loop-state sidecar;
keep-k pruning, and ``shardings=`` refused."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as JA
from repro.train import checkpoint as JC
from repro_torch.optim import OptState
from repro_torch.train import checkpoint as C

STEP = 7


def _values(v=0.0):
    """The tree's values as numpy: params, two moments, a step, a bf16 leaf."""
    rng = np.random.default_rng(int(v * 10) + 1)
    p = {"deconv0": {"ww": rng.standard_normal((3, 4, 2)).astype(np.float32)},
         "deconv0_bn": {"mean": rng.standard_normal(2).astype(np.float32), "var": (1 + rng.random(2)).astype(np.float32)},
         "stem": {"w": rng.standard_normal((5, 6)).astype(np.float32) + v, "b": np.zeros(6, np.float32)}}
    m = {k: {kk: 0.1 * a for kk, a in d.items()} for k, d in p.items()}
    vv = {k: {kk: 0.01 * a * a for kk, a in d.items()} for k, d in p.items()}
    half = (np.arange(6, dtype=np.float32).reshape(2, 3) / 8 + v)
    return p, m, vv, half


def _jax_tree(v=0.0, step=STEP):
    p, m, vv, half = _values(v)
    j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return {"gp": j(p), "g_opt": JA.OptState(jnp.asarray(step, jnp.int32), j(m), j(vv)),
            "extra": {"half": jnp.asarray(half, jnp.bfloat16)}}


def _port_tree(v=0.0, step=STEP):
    p, m, vv, half = _values(v)
    t = lambda tree: {k: {kk: torch.from_numpy(a.copy()) for kk, a in d.items()} for k, d in tree.items()}  # noqa: E731
    return {"gp": t(p), "g_opt": OptState(step, t(m), t(vv)),
            "extra": {"half": torch.from_numpy(half.copy()).to(torch.bfloat16)}}


def _flat_port(tree):
    return dict(C._flatten(tree))


def _flat_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): leaf for path, leaf in flat}


def _assert_same(port_tree, jax_tree):
    """Every leaf of the port's tree equals the JAX tree's, bit for bit
    (bf16 compared as its fp32 value), the step as a Python int."""
    fp, fj = _flat_port(port_tree), _flat_jax(jax_tree)
    assert set(fp) == set(fj)
    assert "['g_opt'].step" in fp and "['g_opt'].m['deconv0']['ww']" in fp
    for key, leaf in fp.items():
        want = np.asarray(fj[key].astype(jnp.float32) if fj[key].dtype == jnp.bfloat16 else fj[key])
        if key.endswith(".step"):
            assert type(leaf) is int and leaf == int(want), key
            continue
        assert isinstance(leaf, torch.Tensor), key
        got = leaf.float().numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:012d}", C.MANIFEST)) as f:
        return json.load(f)


def _step_dir(d, step):
    return os.path.join(str(d), f"step_{step:012d}")


def _leaf_files(d, step):
    sd = _step_dir(d, step)
    return sorted(os.path.join(sd, f) for f in os.listdir(sd) if f.startswith("leaf_"))


# ------------------------------------------------------------ across the packages
def test_jax_checkpoint_restores_in_the_port(tmp_path):
    JC.save_checkpoint(str(tmp_path), 3, _jax_tree(), loop_state={"step": 3, "lr_scale": 0.5})
    back = C.restore_checkpoint(str(tmp_path), 3, _port_tree(v=9.0, step=0), device="cpu")
    assert back["extra"]["half"].dtype == torch.bfloat16
    _assert_same(back, _jax_tree())
    assert C.load_loop_state(str(tmp_path), 3) == {"step": 3, "lr_scale": 0.5}
    C.verify_checkpoint(str(tmp_path), 3)


def test_port_checkpoint_restores_in_jax(tmp_path):
    C.save_checkpoint(str(tmp_path), 3, _port_tree(), loop_state={"step": 3, "metrics_hist": [{"step": 1}]})
    back = JC.restore_checkpoint(str(tmp_path), 3, _jax_tree(v=9.0, step=0))
    assert back["g_opt"].step.dtype == jnp.int32 and back["extra"]["half"].dtype == jnp.bfloat16
    _assert_same(_port_tree(), back)
    assert JC.load_loop_state(str(tmp_path), 3) == {"step": 3, "metrics_hist": [{"step": 1}]}
    JC.verify_checkpoint(str(tmp_path), 3)


def test_the_two_packages_write_the_same_manifest(tmp_path):
    """Key paths (JAX's ``keystr``: ``['k']``, ``.field``), file numbering,
    logical shapes and dtypes (the bf16 leaf stored as raw uint8 bytes under
    "bfloat16", the step a 0-d int32) and per-leaf sha256, and the
    sidecar's sha."""
    ls = {"step": 3, "lr_scale": 1.0, "metrics_hist": [{"step": 1, "g_loss": 0.25}]}
    JC.save_checkpoint(str(tmp_path / "jax"), 3, _jax_tree(), loop_state=ls)
    C.save_checkpoint(str(tmp_path / "port"), 3, _port_tree(), loop_state=ls)
    mj, mp = _manifest(tmp_path / "jax", 3), _manifest(tmp_path / "port", 3)
    assert mp == mj
    recs = {r["key"]: r for r in mp["leaves"]}
    assert recs["['g_opt'].step"]["dtype"] == "int32" and recs["['g_opt'].step"]["shape"] == []
    assert recs["['extra']['half']"]["dtype"] == "bfloat16" and recs["['extra']['half']"]["shape"] == [2, 3]
    for r in mp["leaves"]:  # the leaf files themselves, byte for byte
        with open(tmp_path / "jax" / "step_000000000003" / r["file"], "rb") as a, \
                open(tmp_path / "port" / "step_000000000003" / r["file"], "rb") as b:
            assert a.read() == b.read(), r["key"]


# ------------------------------------------------------------ verification (test_checkpoint_integrity.py)
def test_manifest_records_sha_and_verify_passes(tmp_path):
    C.save_checkpoint(str(tmp_path), 3, _port_tree())
    assert all(len(rec["sha256"]) == 64 for rec in _manifest(tmp_path, 3)["leaves"])
    C.verify_checkpoint(str(tmp_path), 3)


def test_bitflip_detected_on_verify_and_restore(tmp_path):
    C.save_checkpoint(str(tmp_path), 0, _port_tree())
    victim = _leaf_files(tmp_path, 0)[-1]
    arr = np.load(victim)
    flipped = arr.copy()
    flipped.flat[0] += 1
    np.save(victim, flipped)
    with pytest.raises(C.CheckpointCorruptError, match="sha256 mismatch"):
        C.verify_checkpoint(str(tmp_path), 0)
    with pytest.raises(C.CheckpointCorruptError):
        C.restore_checkpoint(str(tmp_path), 0, _port_tree(), device="cpu")


def test_truncated_leaf_detected(tmp_path):
    C.save_checkpoint(str(tmp_path), 0, _port_tree())
    victim = _leaf_files(tmp_path, 0)[0]
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(C.CheckpointCorruptError, match="unreadable leaf"):
        C.verify_checkpoint(str(tmp_path), 0)


def test_damaged_manifest_detected(tmp_path):
    C.save_checkpoint(str(tmp_path), 0, _port_tree())
    with open(os.path.join(_step_dir(tmp_path, 0), C.MANIFEST), "w") as f:
        f.write("{not json")
    with pytest.raises(C.CheckpointCorruptError, match="unreadable manifest"):
        C.restore_checkpoint(str(tmp_path), 0, _port_tree(), device="cpu")


def test_pre_sha_manifest_still_loads(tmp_path):
    """A manifest without sha256 fields (written before the integrity
    layer) loads unverified."""
    C.save_checkpoint(str(tmp_path), 0, _port_tree())
    mpath = os.path.join(_step_dir(tmp_path, 0), C.MANIFEST)
    manifest = _manifest(tmp_path, 0)
    for rec in manifest["leaves"]:
        del rec["sha256"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    back = C.restore_checkpoint(str(tmp_path), 0, _port_tree(v=9.0), device="cpu")
    assert torch.equal(back["gp"]["stem"]["w"], _port_tree()["gp"]["stem"]["w"])


def test_restore_latest_valid_falls_back_to_older(tmp_path):
    C.save_checkpoint(str(tmp_path), 1, _port_tree(1.0))
    C.save_checkpoint(str(tmp_path), 2, _port_tree(2.0))
    with open(_leaf_files(tmp_path, 2)[0], "wb") as f:
        f.write(b"garbage")
    skipped = []
    step, tree = C.restore_latest_valid(str(tmp_path), _port_tree(), device="cpu",
                                        on_skip=lambda s, e: skipped.append(s))
    assert step == 1 and skipped == [2]
    assert torch.equal(tree["gp"]["stem"]["w"], _port_tree(1.0)["gp"]["stem"]["w"])
    assert C.available_steps(str(tmp_path)) == [1, 2]


def test_restore_latest_valid_none_when_all_corrupt(tmp_path):
    C.save_checkpoint(str(tmp_path), 1, _port_tree())
    for f in _leaf_files(tmp_path, 1):
        with open(f, "wb") as fh:
            fh.write(b"x")
    assert C.restore_latest_valid(str(tmp_path), _port_tree(), device="cpu") == (None, None)
    assert C.restore_latest_valid(str(tmp_path / "missing"), _port_tree(), device="cpu") == (None, None)


# ------------------------------------------------------------ durability and the sidecar (test_train_resilience.py)
def test_save_checkpoint_fsyncs_every_file(tmp_path, monkeypatch):
    """Every leaf, the loop-state sidecar, the manifest and both dirs are
    fsync'd before the atomic rename lands."""
    calls = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd), real(fd))[1])
    C.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2), "b": torch.ones(3)}, loop_state={"step": 1})
    assert len(calls) >= 6  # 2 leaves + loop_state + manifest + tmp dir + parent dir


def test_loop_state_roundtrip_and_integrity(tmp_path):
    tree = {"a": torch.zeros(3)}
    ls = {"step": 1, "lr_scale": 0.5, "metrics_hist": [{"step": 1, "g_loss": 0.1}]}
    C.save_checkpoint(str(tmp_path), 1, tree, loop_state=ls)
    assert C.load_loop_state(str(tmp_path), 1) == ls
    C.save_checkpoint(str(tmp_path), 2, tree)  # no sidecar: None, no raise
    assert C.load_loop_state(str(tmp_path), 2) is None
    C.save_checkpoint(str(tmp_path), 3, tree, loop_state=ls)
    with open(tmp_path / "step_000000000003" / C.LOOP_STATE, "wb") as f:
        f.write(b"garbage")
    with pytest.raises(C.CheckpointCorruptError):
        C.load_loop_state(str(tmp_path), 3)
    step, _ = C.restore_latest_valid(str(tmp_path), tree, device="cpu")
    assert step == 2


def test_undecodable_loop_state_is_corruption(tmp_path):
    """A sidecar whose sha matches but which is not JSON (a manifest edited
    to match) is corruption too, as in the reference."""
    C.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)}, loop_state={"step": 1})
    sd = _step_dir(tmp_path, 1)
    blob = b"\xff not json"
    with open(os.path.join(sd, C.LOOP_STATE), "wb") as f:
        f.write(blob)
    manifest = _manifest(tmp_path, 1)
    import hashlib

    manifest["loop_state"]["sha256"] = hashlib.sha256(blob).hexdigest()
    with open(os.path.join(sd, C.MANIFEST), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(C.CheckpointCorruptError, match="undecodable"):
        C.load_loop_state(str(tmp_path), 1)
    with pytest.raises(JC.CheckpointCorruptError, match="undecodable"):
        JC.load_loop_state(str(tmp_path), 1)


# ------------------------------------------------------------ pruning, placement, caller errors
def test_keeps_the_newest_k_steps(tmp_path):
    for step in (2, 4, 6, 8):
        C.save_checkpoint(str(tmp_path), step, {"a": torch.full((2,), float(step))}, keep=2)
    assert C.available_steps(str(tmp_path)) == [6, 8] and C.latest_step(str(tmp_path)) == 8
    assert C.latest_step(str(tmp_path / "missing")) is None
    back = C.restore_checkpoint(str(tmp_path), 6, {"a": torch.zeros(2)}, device="cpu")
    assert back["a"].tolist() == [6.0, 6.0]
    # a stale tmp dir of a crashed save is neither listed nor pruned into
    os.makedirs(os.path.join(str(tmp_path), "step_000000000010.tmp"))
    assert C.available_steps(str(tmp_path)) == [6, 8]


def test_restore_places_leaves_with_like_dtype_and_refuses_shardings(tmp_path):
    C.save_checkpoint(str(tmp_path), 1, _port_tree())
    like = _port_tree(v=9.0, step=0)
    like["gp"]["stem"]["w"] = like["gp"]["stem"]["w"].double()
    back = C.restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    assert back["gp"]["stem"]["w"].dtype == torch.float64 and back["gp"]["stem"]["w"].device.type == "cpu"
    # shardings=: each rank keeps its block (here rank 1's view of a (2,) data
    # mesh, which needs no collective); a tensor leaf without a placement is refused
    from repro_torch.parallel.sharding import P, named

    class Rank1:
        shape, axis_names, device = {"data": 2}, ("data",), torch.device("cpu")

        def index(self, axes):
            return 1

    def replicated(t):
        if isinstance(t, OptState):
            return OptState(P(), replicated(t.m), replicated(t.v))
        if isinstance(t, dict):
            return {k: replicated(v) for k, v in t.items()}
        return P(*([None] * t.dim()))

    full = C.restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    specs = replicated(like)
    specs["gp"]["stem"]["w"] = specs["g_opt"].m["stem"]["w"] = P(None, "data")
    mesh = Rank1()
    half = C.restore_checkpoint(str(tmp_path), 1, like, device="cpu", shardings=named(mesh, specs))
    for got, want in ((half["gp"]["stem"]["w"], full["gp"]["stem"]["w"]),
                      (half["g_opt"].m["stem"]["w"], full["g_opt"].m["stem"]["w"])):
        assert torch.equal(got, want[:, want.shape[1] // 2:])
    assert torch.equal(half["extra"]["half"], full["extra"]["half"]) and half["g_opt"].step == STEP
    step, latest = C.restore_latest_valid(str(tmp_path), like, device="cpu", shardings=named(mesh, specs))
    assert step == 1 and torch.equal(latest["gp"]["stem"]["w"], half["gp"]["stem"]["w"])
    del specs["extra"]["half"]
    with pytest.raises(KeyError, match="placement"):
        C.restore_checkpoint(str(tmp_path), 1, like, device="cpu", shardings=named(mesh, specs))


def test_shape_mismatch_is_a_caller_error_and_a_missing_leaf_a_key_error(tmp_path):
    """A valid sha with the wrong shape is ValueError (the fallback walk
    must not skip it as corruption); a leaf the checkpoint lacks KeyError."""
    C.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        C.restore_latest_valid(str(tmp_path), {"a": torch.zeros(4)}, device="cpu")
    with pytest.raises(KeyError):
        C.restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3), "b": torch.zeros(1)}, device="cpu")


def test_a_retaken_step_replaces_the_old_one(tmp_path):
    """Saving a step that is on disk (a replay rewriting a checkpoint it
    corrupted) replaces it whole."""
    C.save_checkpoint(str(tmp_path), 4, {"a": torch.zeros(3)})
    with open(_leaf_files(tmp_path, 4)[0], "wb") as f:
        f.write(b"x")
    C.save_checkpoint(str(tmp_path), 4, {"a": torch.ones(3)})
    C.verify_checkpoint(str(tmp_path), 4)
    assert C.restore_checkpoint(str(tmp_path), 4, {"a": torch.zeros(3)}, device="cpu")["a"].tolist() == [1.0] * 3
    shutil.rmtree(_step_dir(tmp_path, 4))
    assert C.available_steps(str(tmp_path)) == []
