"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) against the JAX
package's on-disk format, on the CPU.

A train state saved by either package restores in the other, bit for bit:
the port writes the reference's files byte for byte (``leaf_NNNNN.npy``,
``manifest.json`` with path, shape, dtype and CRC32; ``blocks`` stacked;
bfloat16 leaves as the reference's ``'<V2'`` words, read and written
through an int16 view). The reference's own ``restore(template=...)``
cannot cast its ``'<V2'`` leaves to bfloat16 (numpy has no cast function
for them), so a bfloat16 state crosses into the reference as raw leaves
(``template=None``), checked byte for byte.
"""
import filecmp
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_smoke_config as j_smoke
from repro.train import steps as jsteps
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import bridge
from repro_torch.train import optim as toptim

ARCH = "tinyllama_1_1b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(dtype: str):
    """The reference's smoke train state in ``dtype`` (params; m / v stay
    fp32) and the same state in the port's layout."""
    jc = j_smoke(ARCH).replace(dtype=dtype)
    tc = t_smoke(ARCH).replace(dtype=dtype)
    jstate = jsteps.train_state_init(jax.random.PRNGKey(0), jc)
    # non-zero moments and step, so a swapped leaf cannot pass
    rng = np.random.default_rng(1)
    jstate["opt"] = {
        "m": jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape, np.float32)),
            jstate["opt"]["m"]),
        "v": jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.random(x.shape, np.float32)),
            jstate["opt"]["v"]),
        "step": jnp.int32(7)}
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = bridge.state_from_numpy(tree, tc, "cpu")
    if dtype == "bfloat16":
        # bridge widens through fp32; the bf16 values are exact in it
        assert tstate["params"]["embed"]["table"].dtype == torch.bfloat16
    return jstate, tstate


def _assert_states_equal(a, b):
    la, lb = toptim.tree_leaves(a), toptim.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_writes_the_reference_files_byte_for_byte(tmp_path, dtype):
    jstate, tstate = _states(dtype)
    jp = jckpt.save(jstate, str(tmp_path / "j"), 3)
    tp = tckpt.save(tstate, str(tmp_path / "t"), 3)
    names = sorted(os.listdir(jp))
    assert names == sorted(os.listdir(tp))
    assert len(names) > 10
    for n in names:
        assert filecmp.cmp(os.path.join(jp, n), os.path.join(tp, n),
                           shallow=False), n
    with open(os.path.join(tp, "manifest.json")) as f:
        dtypes = {e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes == ({"float32", "int32"} if dtype == "float32"
                      else {"bfloat16", "float32", "int32"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    jstate, tstate = _states(dtype)
    jckpt.save(jstate, str(tmp_path), 5)
    template = tckpt.spec_of(tstate)
    got, step = tckpt.restore(str(tmp_path), template=template)
    assert step == 5
    _assert_states_equal(got, tstate)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = _states("float32")
    tckpt.save(tstate, str(tmp_path), 9)
    template = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    got, step = jckpt.restore(str(tmp_path), template=template)
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_bf16_checkpoint_reads_back_raw_in_the_reference(tmp_path):
    jstate, tstate = _states("bfloat16")
    tckpt.save(tstate, str(tmp_path), 2)
    raw, _ = jckpt.restore(str(tmp_path))              # CRCs verified
    want = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert raw.keys() == want.keys()
    for p, a in raw.items():
        assert a.tobytes() == want[p].tobytes(), p
    assert raw["params/embed/table"].dtype == np.dtype("V2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_and_verification(tmp_path, dtype):
    _j, tstate = _states(dtype)
    d = str(tmp_path)
    path = tckpt.save(tstate, d, 4)
    got, _ = tckpt.restore(d, template=tstate)
    _assert_states_equal(got, tstate)
    # a flipped byte in one leaf: restore names it
    with open(os.path.join(path, "manifest.json")) as f:
        entry = json.load(f)["leaves"][3]
    fp = os.path.join(path, entry["file"])
    raw = bytearray(open(fp, "rb").read())
    raw[-1] ^= 0x10
    open(fp, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match=f"leaf '{entry['path']}'"):
        tckpt.restore(d, template=tstate)
    tckpt.restore(d, template=tstate, verify=False)    # opting out reads it


def test_restore_refuses_float_int_casts_and_shape_changes(tmp_path):
    tree = {"w": torch.ones(3), "idx": torch.arange(2, dtype=torch.int32)}
    tckpt.save(tree, str(tmp_path), 1)
    with pytest.raises(TypeError, match="float<->int"):
        tckpt.restore(str(tmp_path), template={
            "w": torch.ones(3, dtype=torch.int8), "idx": tree["idx"]})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(str(tmp_path), template={
            "w": torch.ones(4), "idx": tree["idx"]})
    # float -> float casts are free (fp32 checkpoint into a bf16 template)
    got, _ = tckpt.restore(str(tmp_path), template={
        "w": torch.ones(3, dtype=torch.bfloat16), "idx": tree["idx"]})
    assert got["w"].dtype == torch.bfloat16


def test_layers_stack_and_split(tmp_path):
    tree = {"blocks": [{"a": torch.full((2,), float(i)),
                        "s": torch.tensor(i, dtype=torch.int32)}
                       for i in range(3)], "top": torch.zeros(())}
    p = tckpt.save(tree, str(tmp_path), 1)
    with open(os.path.join(p, "manifest.json")) as f:
        leaves = {e["path"]: e["shape"] for e in json.load(f)["leaves"]}
    assert leaves == {"blocks/a": [3, 2], "blocks/s": [3], "top": []}
    got, _ = tckpt.restore(str(tmp_path), template=tckpt.spec_of(tree))
    _assert_states_equal(got, tree)
    assert got["top"].shape == ()


def test_latest_step_gc_and_atomicity(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d + "/none") is None
    for s in (1, 2, 3, 4):
        tckpt.save({"w": torch.full((2,), float(s))}, d, s)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a torn save
    assert tckpt.latest_step(d) == 4
    tckpt.gc_old(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                     "step_00000009.tmp"]
    assert jckpt.latest_step(d) == 4


def test_async_saver_snapshots_before_the_thread(tmp_path):
    w = torch.ones(4)
    saver = tckpt.AsyncSaver()
    saver.save_async({"w": w}, str(tmp_path), 1)
    w.add_(1.0)                    # the train loop moves on at once
    saver.wait()
    got, _ = tckpt.restore(str(tmp_path), template={"w": w})
    assert torch.equal(got["w"], torch.ones(4))
    assert len(saver.snapshot_s) == len(saver.write_s) == 1
    assert saver.last_path.endswith("step_00000001")


def test_crc_is_over_the_reference_bytes(tmp_path):
    t = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    p = tckpt.save({"x": t}, str(tmp_path), 1)
    with open(os.path.join(p, "manifest.json")) as f:
        e = json.load(f)["leaves"][0]
    assert e["dtype"] == "bfloat16" and e["shape"] == [2]
    assert e["crc32"] == zlib.crc32(t.view(torch.int16).numpy().tobytes())
