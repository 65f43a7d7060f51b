"""Training with int8 / int4 alphas (``kernels.ops`` ``OvsfGemmFn`` and
``OvsfDecompressFn`` over quantised storage, ``train.steps``,
``checkpoint.ckpt``, ``runtime.supervisor``) against the JAX package, on
the CPU at smoke size.

The reference differentiates through its jnp dequantisation
(``core.ovsf.dequantize_alphas``): the fp32 per-segment scales
(``alpha_scale``) train, the integer alphas and the code ids get float0
gradients and stay. Tolerances: the layer gradients (dx and d scale)
within 1e-4 relative L2 of ``jax.grad``; one train step's loss within
1e-5, every gradient leaf and the updated state within 1e-4 relative L2 a
leaf; integer leaves bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import ovsf as jovsf
from repro.kernels import ops as jops
from repro.models import registry as jR
from repro.train import optim as joptim
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import ops as tops
from repro_torch.models import bridge
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import mapper as tmapper
from repro_torch.runtime import supervisor as tsup
from repro_torch.train import optim as toptim
from repro_torch.train import steps as tsteps
from test_torch_train import _cfgs, _path, _port_leaves, _ref_leaves, _rel
from test_torch_train_families import family_batch, port_batch, states

LM_FAMILIES = ("tinyllama_1_1b", "starcoder2_15b", "olmoe_1b_7b",
               "kimi_k2_1t_a32b", "falcon_mamba_7b", "zamba2_1_2b",
               "whisper_tiny", "llava_next_34b")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
ADTS = ("int8", "int4")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- one layer ----------------------------------------------------------------

def layer_case(layout: str, adt: str, seed: int):
    """(x (M, d_in), q, scale, idx) as numpy: d_in 64, d_out 24, rho 0.5;
    segmented codes of length 16 (n_seg 4, a scale each) or monolithic
    codes (one scale), some segment rows all zero in the stored integers
    but not in the scale's gradient."""
    rng = np.random.default_rng(seed)
    d_in, d_out, M = 64, 24, 5
    if layout == "segmented":
        idx = np.stack([np.sort(rng.choice(16, 8, replace=False))
                        for _ in range(4)]).astype(np.int32)
        n_seg = 4
    else:
        idx = np.sort(rng.choice(64, 32, replace=False)).astype(np.int32)
        n_seg = 1
    al = rng.standard_normal((idx.size, d_out)).astype(np.float32)
    q, s = jovsf.quantize_alphas(jnp.asarray(al), n_seg, adt)
    x = rng.standard_normal((M, d_in)).astype(np.float32)
    return x, np.asarray(q), np.asarray(s), idx


@pytest.mark.parametrize("path", tops.EXEC_PATHS)
@pytest.mark.parametrize("layout", ["segmented", "monolithic"])
@pytest.mark.parametrize("adt", ADTS)
def test_quantised_layer_gradients_match_jax(adt, layout, path):
    """dx and d scale of sum(y * g), y = ``ovsf_matmul`` over quantised
    alphas, against ``jax.grad`` of the reference's
    ``ovsf_matmul(use_pallas=False)``: ``fused`` through ``OvsfGemmFn``,
    ``materialize`` of monolithic codes through ``OvsfDecompressFn``, the
    rest by autograd through plain code. q and idx get no gradient and
    are left as they were."""
    x, q, s, idx = layer_case(layout, adt, seed=3)
    g = np.random.default_rng(4).standard_normal((x.shape[0], 24)).astype(
        np.float32)

    def jloss(xx, ss):
        y = jops.ovsf_matmul(xx, jnp.asarray(q), jnp.asarray(idx), path=path,
                             alpha_scale=ss, alpha_dtype=adt,
                             use_pallas=False)
        return jnp.sum(y * g)
    jdx, jds = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s.copy()).requires_grad_()
    tq, tidx = torch.from_numpy(q.copy()), torch.from_numpy(idx)
    y = tops.ovsf_matmul(tx, tq, tidx, path=path, alpha_scale=ts,
                         alpha_dtype=adt)
    assert y.shape == (x.shape[0], 24)
    dx, ds = torch.autograd.grad((y * torch.from_numpy(g)).sum(), (tx, ts))
    assert ds.shape == ts.shape and ds.dtype == torch.float32
    assert _rel(dx.numpy(), jdx) <= 1e-4
    assert _rel(ds.numpy(), jds) <= 1e-4
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_array_equal(tidx.numpy(), idx)


@pytest.mark.parametrize("adt", ADTS)
def test_quantised_decompress_gradient_matches_jax(adt):
    """``OvsfDecompressFn`` over int8 / int4 alphas, monolithic codes and
    a ragged d_in (48 in L 64): W in fp32, equal to the reference's
    ``decompress``, and the scales' gradient of sum(W * G) against
    ``jax.grad`` of it."""
    rng = np.random.default_rng(6)
    idx = np.sort(rng.choice(64, 32, replace=False)).astype(np.int32)
    al = rng.standard_normal((32, 20)).astype(np.float32)
    q, s = (np.asarray(a) for a in jovsf.quantize_alphas(jnp.asarray(al), 2,
                                                         adt))
    G = rng.standard_normal((48, 20)).astype(np.float32)

    def jloss(ss):
        return jnp.sum(jops.decompress(jnp.asarray(q), jnp.asarray(idx), 48,
                                       alpha_scale=ss, alpha_dtype=adt,
                                       use_pallas=False) * G)
    jW = jops.decompress(jnp.asarray(q), jnp.asarray(idx), 48,
                         alpha_scale=jnp.asarray(s), alpha_dtype=adt,
                         use_pallas=False)
    jds = jax.grad(jloss)(jnp.asarray(s))
    ts = torch.from_numpy(s.copy()).requires_grad_()
    W = tops.ovsf_decompress_fn(torch.from_numpy(q), torch.from_numpy(idx),
                                48, alpha_scale=ts, alpha_dtype=adt)
    assert W.dtype == torch.float32 and W.grad_fn is not None
    assert _rel(W.detach().numpy(), jW) <= 1e-6
    (ds,) = torch.autograd.grad((W * torch.from_numpy(G)).sum(), ts)
    assert ds.shape == (2, 1)
    assert _rel(ds.numpy(), jds) <= 1e-4


def test_scale_gradient_reads_int4_nibbles_in_column_order():
    """``_scale_grad`` of packed int4: the low nibble is the even column,
    as ``core.ovsf.unpack_int4`` reads it; against the sum written out."""
    q = torch.tensor([[0x1F, 0x72], [0x80, 0x08]],
                     dtype=torch.uint8).view(torch.int8)
    dA = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    # row 0's nibbles (-1, 1, 2, 7), row 1's (0, -8, -8, 0)
    want = torch.tensor([[1 + 2 * 2 + 7 * 3 - 8 * 5 - 8 * 6]],
                        dtype=torch.float32)
    got = tops._scale_grad(q, torch.ones((1, 1)), dA, "int4")
    assert torch.equal(got, want)
    two = tops._scale_grad(q, torch.ones((2, 1)), dA, "int4")
    assert two.flatten().tolist() == [26.0, -88.0]


def test_cache_is_bypassed_while_the_scale_trains():
    """A ``materialize`` layer planned with ``cache_weights`` over int8
    alphas (integers: they never record) leaves no cache entry while
    autograd records its scale, so no W carries a finished step's graph
    or a stale scale; the same call under ``no_grad`` caches."""
    x, q, s, idx = layer_case("monolithic", "int8", seed=8)
    plan = tmapper.LayerPlan(path="materialize", cache_weights=True,
                             cache_key="quant-scale")
    tq, tidx = torch.from_numpy(q.copy()), torch.from_numpy(idx)
    ts = torch.from_numpy(s.copy()).requires_grad_()
    tops.clear_weight_cache()
    try:
        for _ in range(2):
            y = tops.ovsf_matmul(torch.from_numpy(x), tq, tidx, plan=plan,
                                 alpha_scale=ts, alpha_dtype="int8")
            assert y.grad_fn is not None
        assert tops.weight_cache_stats()["entries"] == 0
        assert tops.weight_cache_stats()["misses"] == 0
        with torch.no_grad():
            for _ in range(2):
                tops.ovsf_matmul(torch.from_numpy(x), tq, tidx, plan=plan,
                                 alpha_scale=ts, alpha_dtype="int8")
        st = tops.weight_cache_stats()
        assert (st["entries"], st["misses"], st["hits"]) == (1, 1, 1)
    finally:
        tops.clear_weight_cache()


# -- one train step -----------------------------------------------------------

def _int_leaves(tree) -> dict:
    """{reference path: numpy leaf} of a port tree's integer leaves (the
    quantised alphas and the code ids), lists stacked, dtypes kept."""
    out: dict = {}

    def add(path, t):
        if t is not None and not t.is_floating_point():
            out.setdefault(path, []).append(t.numpy().copy())
    toptim.tree_map(add, tree)
    return {p: (v[0] if len(v) == 1 else np.stack(v)) for p, v in
            out.items()}


def ref_grads(grads, jparams):
    """The port's gradients as a reference gradient tree, each float leaf
    in its param's dtype; zeros for the integer leaves (``adamw_update``
    skips them by the param's dtype, and zeros add nothing to the norm)."""
    got = _port_leaves(grads)
    flat, tdef = jax.tree_util.tree_flatten_with_path(jparams)
    return jax.tree_util.tree_unflatten(tdef, [
        jnp.asarray(got[_path(p)]).astype(x.dtype)
        if jnp.issubdtype(x.dtype, jnp.floating)
        else jnp.zeros(x.shape, jnp.float32) for p, x in flat])


@pytest.mark.parametrize("arch,adt,path",
                         [(a, "int8", "fused") for a in LM_FAMILIES]
                         + [("tinyllama_1_1b", "int4", "fused"),
                            ("tinyllama_1_1b", "int8", "materialize"),
                            ("tinyllama_1_1b", "int4", "spectral")])
def test_quantised_train_step_matches_reference(arch, adt, path):
    """One step with int8 (int4) alphas against the reference's train step
    under ``jax.jit`` (its ``make_train_step`` body written out): the loss
    and the MoE aux within 1e-5, the gradient of every float leaf (the
    scales included) within 1e-4 relative L2 a leaf, the step's metrics
    within 1e-5; the updated params and optimizer state within 1e-4
    relative L2 a leaf of the reference's ``adamw_update`` fed the same
    gradients (AdamW's first step divides each gradient element by its own
    magnitude plus eps: an element near zero moves its param by a share
    of lr that a 1e-6 relative change of the gradient leaf can move by a
    percent). The integer leaves (alphas, code ids) get no gradient and
    come out bit for bit as they went in; the scales move. The MoE
    families' expert banks stay float (the reference quantises no bank)."""
    jc, tc, jstate, tstate = states(arch, path, adt)
    batch = family_batch(tc, 2, 16, seed=3)
    ocfg = joptim.OptConfig(**OPT)

    @jax.jit
    def ref(state, b):
        (loss, m), g = jax.value_and_grad(
            lambda p: jR.loss_fn(p, jc, b), has_aux=True,
            allow_int=True)(state["params"])
        _p, _o, om = joptim.adamw_update(ocfg, g, state["opt"],
                                         state["params"])
        return loss, m, g, {"total_loss": loss, **m, **om}
    jloss, jaux, jg, jm = ref(jstate, batch)

    scales = [p for p in _port_leaves(tstate["params"])
              if p.endswith("alpha_scale")]
    assert scales
    loss, aux, grads = tsteps.loss_and_grads(tc, tstate["params"],
                                             port_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["aux"]), float(jaux["aux"]),
                               rtol=1e-5, atol=1e-7)
    want = {p: g for p, g in _ref_leaves(jg).items()
            if g.dtype != jax.dtypes.float0}
    got = _port_leaves(grads)
    assert got.keys() == want.keys()
    assert all(np.abs(got[p]).sum() > 0 for p in scales)
    for p in want:
        assert _rel(got[p], want[p]) <= 1e-4, (p, _rel(got[p], want[p]))

    before = _int_leaves(tstate["params"])
    assert any("alphas_q" in p for p in before)
    step = tsteps.make_train_step(tc, toptim.OptConfig(**OPT))
    tnew, tm = step(tstate, batch)
    for k in ("total_loss", "loss", "aux", "lr", "grad_norm", "step"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    jp, jo, _m = jax.jit(lambda g, st: joptim.adamw_update(
        ocfg, g, st["opt"], st["params"]))(ref_grads(grads, jstate["params"]),
                                           jstate)
    want = _ref_leaves({"params": jp, "opt": jo})
    got = _port_leaves(tnew)
    assert got.keys() == want.keys()
    for p in want:
        assert _rel(got[p], want[p]) <= 1e-4, (p, _rel(got[p], want[p]))
    after = _int_leaves(tnew["params"])
    assert after.keys() == before.keys()
    for p, x in after.items():
        assert x.dtype == before[p].dtype
        np.testing.assert_array_equal(x, before[p], err_msg=p)
    for p in scales:
        assert not np.array_equal(got["params/" + p],
                                  _port_leaves(tstate)["params/" + p]), p


def test_moe_expert_banks_stay_float():
    """OLMoE's int8 smoke state: every ``alpha_scale`` leaf sits in
    attention, as in the reference; the expert banks keep float alphas,
    and a quantised bank is refused, as the reference refuses it."""
    jc, tc, jstate, tstate = states("olmoe_1b_7b", "fused", "int8")
    want = sorted(p for p in _ref_leaves(jstate["params"])
                  if p.endswith("alpha_scale"))
    got = sorted(p for p in _port_leaves(tstate["params"])
                 if p.endswith("alpha_scale"))
    assert got == want and len(got) == 4
    assert all("/attn/" in p for p in got)
    q = torch.zeros((2, 8, 16), dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="expert alpha banks"):
        tops.cached_decompress(q, torch.arange(8, dtype=torch.int32), 8,
                               cache_key="e|int8",
                               alpha_scale=torch.ones((1, 1)),
                               alpha_dtype="int8")


# -- checkpoints and the supervisor -------------------------------------------

def test_quantised_checkpoint_crosses_both_ways(tmp_path):
    """An int8 train state (int8 alphas, fp32 scales, int32 ids; moments
    and step non-zero) saves in the port and restores in the reference
    leaf for leaf, and the reference's save restores in the port bit for
    bit, each CRC-verified."""
    jc, tc, jstate, _t = states("tinyllama_1_1b", "fused", "int8")
    rng = np.random.default_rng(1)
    jstate["opt"] = {
        "m": jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape, np.float32)),
            jstate["opt"]["m"]),
        "v": jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.random(x.shape, np.float32)),
            jstate["opt"]["v"]),
        "step": jnp.int32(7)}
    tstate = bridge.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), tc, "cpu")
    assert {t.dtype for t in toptim.tree_leaves(tstate["params"])} == {
        torch.float32, torch.int8, torch.int32}
    tckpt.save(tstate, str(tmp_path / "t"), 9)
    template = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    got, step = jckpt.restore(str(tmp_path / "t"), template=template)
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jckpt.save(jstate, str(tmp_path / "j"), 5)
    back, step = tckpt.restore(str(tmp_path / "j"),
                               template=tckpt.spec_of(tstate))
    assert step == 5
    la, lb = toptim.tree_leaves(back), toptim.tree_leaves(tstate)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("adt", ADTS)
def test_quantised_replay_equals_the_first_pass_bit_for_bit(tmp_path, adt):
    """A ``fail`` between two checkpoints of an int8 (int4) run under
    ``fused``: the supervisor restores the earlier one and replays; every
    replayed loss and the final state equal an uninterrupted run's bit for
    bit, and the integer alphas equal their initial values."""
    _jc, tc = _cfgs("fused", "tinyllama_1_1b", adt)
    ocfg = toptim.OptConfig(lr=5e-3, warmup_steps=2, total_steps=20)
    stream = tdata.TokenStream(tc.vocab, 16, 2, seed=5)
    runs = {}
    for name, plan in (("clean", None),
                       ("fault", tfaults.FaultPlan.parse(["fail:step=7"]))):
        state = tsteps.train_state_init(tc, 0, "cpu")
        init = _int_leaves(state["params"])
        runs[name] = tsup.run(
            tsteps.make_train_step(tc, ocfg), state, stream.batch_at, 10,
            tsup.SupervisorConfig(ckpt_dir=str(tmp_path / name),
                                  save_every=4, log_every=1000),
            faults=plan, log=lambda *_: None)
    (cs, crep), (fs, frep) = runs["clean"], runs["fault"]
    assert frep.failures == 1 and frep.restores == 1
    assert frep.losses == crep.losses[:7] + crep.losses[4:]
    assert all(np.isfinite(crep.losses))
    a, b = _port_leaves(cs), _port_leaves(fs)
    for p in a:
        np.testing.assert_array_equal(a[p], b[p])
    after = _int_leaves(fs["params"])
    assert after.keys() == init.keys() and any("alphas_q" in p for p in init)
    for p, x in init.items():
        np.testing.assert_array_equal(after[p], x)
