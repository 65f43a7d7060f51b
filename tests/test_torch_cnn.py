"""The port's CNN slice (``repro_torch.models.cnn``, ``ovsf_decompress``) vs
the JAX package, on the CPU at smoke widths.

Inputs and weights are made with numpy (or by the reference's own init) and
handed to both. The Pallas ``ovsf_decompress`` cannot run in interpret mode
with the installed jax (``pltpu.TPUCompilerParams``), so the kernel's plain
version is held against the reference oracles ``ref.ovsf_decompress_ref``
and ``ops.decompress(use_pallas=False)``; the CUDA kernel itself is held
against that plain version on the card by ``chip_smoke.py``.

Tolerances: the decompressed weights rtol = atol = 2e-3 in fp32 and 2e-2 in
bf16 (the kernel tests' own; the sums are taken in another order); single
layers rtol = atol = 1e-4 in fp32; whole-network logits within 1e-4
relative L2 error in fp32 (a ResNet-50 forward is ~50 layers of fp32 sums
in another order than XLA's).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import ovsf as jovsf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import cnn as jcnn
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.core import ovsf as tovsf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ovsf_gemm as tgemm
from repro_torch.models import bridge
from repro_torch.models import cnn as tcnn

TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
LOGITS_REL = 1e-4
ARCHS = ("resnet18", "resnet34", "resnet50", "squeezenet1_1")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its smoke-sized work
    gains nothing from more, and beside the rest of the suite on several
    workers every parallel region would wait for threads that the other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _cfgs(name="resnet18", smoke=True, **over):
    """The reference's and the port's config of one arch (``SMOKE_CONFIG``
    when ``smoke``), with the same fields overridden."""
    if smoke:
        jcfg, tcfg = jget_smoke_config(name), tget_smoke_config(name)
    else:
        jcfg, tcfg = jget_config(name), tget_config(name)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, **over})
    return jcfg, tcfg.replace(**over)


def _ref_init(jcfg, seed=0):
    params, state = jcnn.cnn_init(jax.random.PRNGKey(seed), jcfg)
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


def _perturb_bn(params, state, seed):
    """Non-trivial BN parameters and running statistics (the init's are the
    identity and would hide a BN fault)."""
    rng = np.random.default_rng(seed)
    for name in state:
        c = state[name]["mean"].shape[0]
        params[name] = {
            "scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
        state[name] = {
            "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
            "var": np.exp(0.2 * rng.standard_normal(c)).astype(np.float32)}
    return params, state


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# config, OVSF helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_reference(name):
    for smoke in (False, True):
        jcfg, tcfg = _cfgs(name, smoke=smoke)
        assert isinstance(tcfg, tcnn.CNNConfig)
        assert tcfg.__dict__ == jcfg.__dict__
    assert tget_config(name).ovsf_mode == "spatial"


def test_reconstruct_matches_reference():
    rng = np.random.default_rng(0)
    kept = rng.standard_normal((5, 24)).astype(np.float32)
    idx = np.sort(rng.choice(64, 24, replace=False)).astype(np.int32)
    for d in (64, 48):
        got = tovsf.reconstruct(torch.from_numpy(kept), torch.from_numpy(idx),
                                d)
        want = jovsf.reconstruct(jnp.asarray(kept), jnp.asarray(idx), d)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("method", ["crop", "adaptive"])
@pytest.mark.parametrize("K0,k", [(4, 3), (8, 3), (8, 5)])
def test_extract_kxk_matches_reference(method, K0, k):
    w4 = np.random.default_rng(K0 + k).standard_normal(
        (3, 2, K0, K0)).astype(np.float32)
    got = tovsf.extract_kxk(torch.from_numpy(w4), k, method)
    want = jovsf.extract_kxk(jnp.asarray(w4), k, method)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# ovsf_decompress (plain version) and ops.decompress
# ---------------------------------------------------------------------------

def _mono_case(d_in, d_out, seed=0, repeat=False):
    """Unit-scale W: alphas ~ N(0, 1/J) over J = L/2 sorted code ids."""
    rng = np.random.default_rng(seed)
    L = jovsf.next_pow2(d_in)
    J = max(1, L // 2)
    idx = np.sort(rng.choice(L, J, replace=repeat)).astype(np.int32)
    al = (rng.standard_normal((J, d_out)) / np.sqrt(J)).astype(np.float32)
    return al, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out", [(64, 32), (200, 24), (288, 64),
                                        (1000, 40), (1152, 16)])
def test_decompress_plain_matches_reference(d_in, d_out, dtype):
    al, idx = _mono_case(d_in, d_out, seed=d_in)
    ta = torch.from_numpy(al).to(getattr(torch, dtype))
    ja = jnp.asarray(al).astype(dtype)
    got = tgemm.ovsf_decompress(ta, torch.from_numpy(idx), d_in)
    assert got.shape == (d_in, d_out) and got.dtype == ta.dtype
    want = jax.jit(functools.partial(jref.ovsf_decompress_ref, d_in=d_in))(
        ja, idx)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    want_ops = jax.jit(functools.partial(jops.decompress, d_in=d_in,
                                         use_pallas=False))(ja, idx)
    np.testing.assert_allclose(_np(got), np.asarray(want_ops, np.float32),
                               **TOL[dtype])
    torch.testing.assert_close(tops.decompress(ta, torch.from_numpy(idx),
                                               d_in), got, rtol=0, atol=0)


def test_decompress_plain_sums_repeated_ids():
    """The Pallas kernel sums over j, so a repeated code id adds its alphas
    (the reference's FWHT oracle would keep one of them)."""
    al, idx = _mono_case(96, 8, seed=7, repeat=True)
    assert len(set(idx.tolist())) < len(idx)
    got = tgemm.ovsf_decompress(torch.from_numpy(al), torch.from_numpy(idx),
                                96)
    want = jax.jit(functools.partial(jref.ovsf_decompress_ref, d_in=96))(
        al, idx)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])


def test_decompress_on_card_reaches_the_kernel_wrapper():
    """Off the CPU (``meta`` standing in for the card), monolithic codes,
    fp32 or quantised, and segmented codes reach ``ovsf_decompress``'s
    wrapper, whose device check refuses meta."""
    al, idx = _mono_case(72, 16)
    m_al = torch.from_numpy(al).to("meta")
    m_idx = torch.from_numpy(idx).to("meta")
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported device"):
        tops.decompress(m_al, m_idx, 72)
    x = torch.zeros((3, 72), device="meta")
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported device"):
        tops.ovsf_matmul(x, m_al, m_idx, path="materialize")
    seg_idx = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported device"):
        tops.decompress(torch.zeros((32, 16), device="meta"), seg_idx, 64)
    q, s = tovsf.quantize_alphas(torch.from_numpy(al), 1, "int8")
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported device"):
        tops.decompress(q.to("meta"), m_idx, 72, alpha_scale=s.to("meta"),
                        alpha_dtype="int8")


# ---------------------------------------------------------------------------
# layers: OVSF conv, spatial filters, SAME max-pool, BN
# ---------------------------------------------------------------------------

def _one_conv(mode, extract="crop", c_in=16, c_out=24, k=3, seed=0):
    jcfg, tcfg = _cfgs(ovsf_mode=mode, extract=extract)
    p = jcnn.conv_init(jax.random.PRNGKey(seed), jcfg, c_in, c_out, k, 0.5)
    p = jax.tree_util.tree_map(np.asarray, p)
    tp, _ = bridge.cnn_params_from_numpy({"c": p}, {}, tcfg, "cpu")
    return jcfg, tcfg, p, tp["c"]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [9, 10])
def test_matrix_conv_matches_reference(stride, hw):
    jcfg, tcfg, p, tp = _one_conv("matrix")
    assert "alphas" in tp and "meta" not in tp
    x = np.random.default_rng(hw).standard_normal(
        (2, hw, hw, 16)).astype(np.float32)
    want = jax.jit(lambda p, x: jcnn.conv_apply(p, jcfg, x, 24, 3, stride))(
        p, x)
    got = tcnn.conv_apply(tp, tcfg, torch.from_numpy(x).permute(0, 3, 1, 2),
                          24, 3, stride)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), np.asarray(want),
                               **LAYER_TOL)
    w = tcnn.conv_weights(tp, tcfg, 16, 24, 3)
    np.testing.assert_allclose(
        _np(w.permute(2, 3, 1, 0)),
        np.asarray(jcnn.conv_weights(p, jcfg, 16, 24, 3)), **LAYER_TOL)


@pytest.mark.parametrize("extract", ["crop", "adaptive"])
def test_spatial_conv_matches_reference(extract):
    jcfg, tcfg, p, tp = _one_conv("spatial", extract, seed=3)
    assert "meta" in tp
    w = tcnn.conv_weights(tp, tcfg, 16, 24, 3)
    assert w.shape == (24, 16, 3, 3)
    np.testing.assert_allclose(
        _np(w.permute(2, 3, 1, 0)),
        np.asarray(jcnn.conv_weights(p, jcfg, 16, 24, 3)), **LAYER_TOL)
    x = np.random.default_rng(1).standard_normal((2, 9, 9, 16)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jcnn.conv_apply(p, jcfg, x, 24, 3, 2))(p, x)
    got = tcnn.conv_apply(tp, tcfg, torch.from_numpy(x).permute(0, 3, 1, 2),
                          24, 3, 2)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), np.asarray(want),
                               **LAYER_TOL)


@pytest.mark.parametrize("h,w", [(7, 7), (8, 8), (112, 112), (9, 16)])
def test_max_pool_same_matches_reduce_window(h, w):
    x = np.random.default_rng(h * w).standard_normal(
        (2, h, w, 3)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = tcnn.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_np(got.permute(0, 2, 3, 1)),
                                  np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_eval_matches_reference(dtype):
    rng = np.random.default_rng(2)
    c = 6
    x = rng.standard_normal((2, 5, 5, c)).astype(np.float32)
    p = {"scale": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    st = {"mean": rng.standard_normal(c).astype(np.float32),
          "var": np.exp(rng.standard_normal(c)).astype(np.float32)}
    jx = jnp.asarray(x).astype(dtype)
    want, _ = jcnn.bn_apply({k: jnp.asarray(v).astype(dtype)
                             for k, v in p.items()}, st, jx, False)
    td = getattr(torch, dtype)
    got, got_st = tcnn.bn_apply(
        {k: torch.from_numpy(v).to(td) for k, v in p.items()},
        {k: torch.from_numpy(v) for k, v in st.items()},
        torch.from_numpy(x).to(td).permute(0, 3, 1, 2))
    assert got.dtype == td
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                               np.asarray(want, np.float32),
                               **(LAYER_TOL if dtype == "float32"
                                  else TOL[dtype]))
    assert got_st is not None


# ---------------------------------------------------------------------------
# parameters: bridge and native init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["matrix", "spatial"])
def test_cnn_bridge_layout_and_round_trip(mode):
    jcfg, tcfg = _cfgs("resnet18", ovsf_mode=mode)
    params, state = _ref_init(jcfg)
    tp, ts = bridge.cnn_params_from_numpy(params, state, tcfg, "cpu")
    assert tp.keys() == params.keys() and ts.keys() == state.keys()
    n_ovsf = 0
    for name, layer in params.items():
        for key, a in layer.items():
            t = tp[name][key]
            if key == "w" and a.ndim == 4:
                np.testing.assert_array_equal(_np(t.permute(2, 3, 1, 0)), a)
            else:
                np.testing.assert_array_equal(_np(t), a)
            assert (t.dtype == torch.float32 if a.dtype.kind == "f"
                    else t.dtype == torch.int32)
        n_ovsf += "alphas" in layer
    assert n_ovsf == 12                # c1 and c2 of stages 1-3
    for st in ts.values():
        assert all(v.dtype == torch.float32 for v in st.values())
    back_p, back_s = bridge.cnn_params_to_numpy(tp, ts)
    for tree, back in ((params, back_p), (state, back_s)):
        assert back.keys() == tree.keys()
        for name in tree:
            assert back[name].keys() == tree[name].keys()
            for key in tree[name]:
                np.testing.assert_array_equal(back[name][key],
                                              tree[name][key])


@pytest.mark.parametrize("mode", ["matrix", "spatial"])
@pytest.mark.parametrize("name", ARCHS)
def test_native_init_matches_reference_layout(name, mode):
    """Keys, shapes (filters HWIO vs OIHW), dtypes and the code ids (a fixed
    schedule) of the port's own init equal the reference's; SqueezeNet at
    half width, where the 3x3 expand convs of fires 2-7 compress."""
    wm = 0.5 if name == "squeezenet1_1" else 0.25
    jcfg, tcfg = _cfgs(name, ovsf_mode=mode, width_mult=wm)
    jp, js = _ref_init(jcfg)
    tp, ts = tcnn.cnn_init(tcfg, 0, device="cpu")
    assert tp.keys() == jp.keys() and ts.keys() == js.keys()
    for tree, ref in ((tp, jp), (ts, js)):
        for lname in ref:
            assert tree[lname].keys() == ref[lname].keys(), lname
            for key, a in ref[lname].items():
                t = tree[lname][key]
                shape = (tuple(t.permute(2, 3, 1, 0).shape)
                         if key == "w" and t.dim() == 4 else tuple(t.shape))
                assert shape == a.shape, (lname, key)
                assert str(t.dtype).split(".")[-1] == str(a.dtype)
                if key in ("idx", "meta"):
                    np.testing.assert_array_equal(_np(t), a)
    assert any("idx" in layer for layer in tp.values())


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50"])
def test_resnet_layer_plan_matches_reference(name):
    for smoke in (False, True):
        jcfg, tcfg = _cfgs(name, smoke=smoke)
        assert tcnn._resnet_layers(tcfg) == jcnn._resnet_layers(jcfg)


def test_cnn_init_needs_gpu_unless_cpu_is_asked(monkeypatch):
    _jcfg, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcnn.cnn_init(tcfg, 0)


# ---------------------------------------------------------------------------
# whole networks
# ---------------------------------------------------------------------------

_NETS = [("resnet18", 0.25), ("resnet50", 0.25), ("squeezenet1_1", 0.25),
         ("squeezenet1_1", 0.5)]


@pytest.mark.parametrize("mode", ["matrix", "spatial"])
@pytest.mark.parametrize("name,wm", _NETS)
def test_logits_match_reference(name, wm, mode, monkeypatch):
    """Smoke configs (SqueezeNet also at half width, where the 3x3 expand
    convs of fires 2-7 have c_in >= 16 and compress, not only fires 6-7)
    with bridged reference
    weights and non-trivial BN: logits within 1e-4 relative L2 error; in
    matrix mode every OVSF conv generates its filters through
    ``ovsf_decompress``."""
    jcfg, tcfg = _cfgs(name, ovsf_mode=mode, width_mult=wm)
    params, state = _perturb_bn(*_ref_init(jcfg, seed=1), seed=2)
    x = np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, s, x: jcnn.cnn_apply(p, s, jcfg, x)[0])(params, state, x))
    tp, ts = bridge.cnn_params_from_numpy(params, state, tcfg, "cpu")
    calls = []
    real = tops.ovsf_decompress
    monkeypatch.setattr(tops, "ovsf_decompress",
                        lambda *a, **kw: calls.append(a[2]) or real(*a, **kw))
    got, new_state = tcnn.cnn_apply(tp, ts, tcfg, torch.from_numpy(x))
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    assert _rel(_np(got), want) <= LOGITS_REL
    assert new_state.keys() == ts.keys()
    n_ovsf = sum("alphas" in p and "meta" not in p for p in tp.values())
    assert len(calls) == n_ovsf
    assert n_ovsf == {("resnet18", "matrix"): 12, ("resnet50", "matrix"): 13,
                      ("squeezenet1_1", "matrix"): 6 if wm == 0.5 else 2
                      }.get((name, mode), 0)


@pytest.mark.parametrize("name,d_ins", [
    ("resnet50", {1152: 4, 2304: 6, 4608: 3}),
    ("squeezenet1_1", {288: 2, 432: 2, 576: 2})])
def test_full_width_matrix_mode_ovsf_convs(name, d_ins):
    """At full width in matrix mode, the OVSF convs (the kernel's launches
    per forward on the card: 13 and 6) and their d_in = Cin * 9, read from
    the shapes of the reference's init without computing it."""
    jcfg, tcfg = _cfgs(name, smoke=False, ovsf_mode="matrix")
    jp, _ = jax.eval_shape(lambda k: jcnn.cnn_init(k, jcfg),
                           jax.random.PRNGKey(0))
    if name == "squeezenet1_1":
        c_in = {f"f{i}e3": f[0] for i, f in enumerate(tcnn._FIRE)}
    else:
        c_in = {d["name"]: d["c_in"] for d in tcnn._resnet_layers(tcfg)}
    got = {}
    for lname, layer in jp.items():
        if "alphas" in layer:
            d_in = c_in[lname] * 9
            assert layer["alphas"].shape[0] == tovsf.next_pow2(d_in) // 2
            got[d_in] = got.get(d_in, 0) + 1
    assert got == d_ins


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_train_matches_reference(dtype):
    """Train-mode BN: the batch's mean and biased variance over N, H, W in
    fp32, and the running statistics moved by momentum 0.9."""
    rng = np.random.default_rng(5)
    c = 6
    x = (2 + 3 * rng.standard_normal((3, 5, 4, c))).astype(np.float32)
    p = {"scale": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    st = {"mean": rng.standard_normal(c).astype(np.float32),
          "var": np.exp(rng.standard_normal(c)).astype(np.float32)}
    jx = jnp.asarray(x).astype(dtype)
    want, want_st = jcnn.bn_apply({k: jnp.asarray(v).astype(dtype)
                                   for k, v in p.items()}, st, jx, True)
    td = getattr(torch, dtype)
    got, got_st = tcnn.bn_apply(
        {k: torch.from_numpy(v).to(td) for k, v in p.items()},
        {k: torch.from_numpy(v) for k, v in st.items()},
        torch.from_numpy(x).to(td).permute(0, 3, 1, 2), train=True)
    assert got.dtype == td
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                               np.asarray(want, np.float32),
                               **(LAYER_TOL if dtype == "float32"
                                  else TOL[dtype]))
    for k in ("mean", "var"):
        assert got_st[k].dtype == torch.float32
        np.testing.assert_allclose(_np(got_st[k]), np.asarray(want_st[k]),
                                   rtol=1e-5, atol=1e-5)


def _grad_tree(tree, live):
    """The gradients of ``live``'s float leaves in ``tree``'s layout."""
    flat = [t for layer in live.values() for t in layer.values()
            if t.requires_grad]
    got = iter(tree)
    out = {name: {k: next(got) for k, t in layer.items() if t.requires_grad}
           for name, layer in live.items()}
    assert next(got, None) is None and len(flat) == sum(map(len,
                                                            out.values()))
    return out


# (arch, mode, width_mult, plan paths, image side)
_TRAIN_NETS = [("resnet18", "matrix", 0.25, None, 64),
               ("resnet18", "spatial", 0.25, None, 64),
               ("squeezenet1_1", "matrix", 0.5, None, 32),
               ("resnet18", "matrix", 0.25, "fused", 64),
               ("resnet18", "matrix", 0.25, "ALL_PATHS", 64)]


@pytest.mark.parametrize("name,mode,wm,paths,side", _TRAIN_NETS)
def test_cnn_loss_grads_and_bn_state_match_reference(name, mode, wm, paths,
                                                     side):
    """``cnn_loss`` at batch 4 in train mode: the loss, every float leaf's
    gradient (1e-4 relative L2) and the new BN running statistics (1e-5)
    against ``jax.value_and_grad`` of the reference's, on the same weights
    and images; matrix mode unplanned (``materialize``: through the
    ``ovsf_decompress`` Function), under an all-``fused`` plan (``ovsf_gemm``)
    and under ``ALL_PATHS`` plans (every conv ``spectral``: ``fwht``).
    ResNet-18 sees 64 x 64 images: at 32 x 32 and batch 2 its last stage's
    BN normalises two values a channel, and that gradient amplifies the
    two packages' fp32 rounding past 1e-4. SqueezeNet sees 32 x 32: at 64
    x 64 the max-pools after its fire modules meet windows whose two
    largest values differ by rounding alone, and each package sends the
    window's gradient to its own maximum (given the same inputs the pools'
    gradients agree exactly)."""
    from repro.runtime import mapper as jmapper
    from repro_torch.runtime import mapper as tmapper
    jcfg, tcfg = _cfgs(name, ovsf_mode=mode, width_mult=wm)
    if paths:
        ps = ("fused",) if paths == "fused" else jmapper.ALL_PATHS
        jcfg = jcfg.__class__(**{**jcfg.__dict__, "exec_plan":
                                 jmapper.plan_cnn(jcfg, batch=4, hw="cpu",
                                                  paths=ps)})
        tcfg = tcfg.replace(exec_plan=tmapper.plan_cnn(tcfg, batch=4,
                                                       hw="cpu", paths=ps))
        want = {"fused": {"fused"}, "ALL_PATHS": {"spectral"}}[paths]
        assert {p.path for _n, p in tcfg.exec_plan.entries} == want
    params, state = _perturb_bn(*_ref_init(jcfg, seed=1), seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, side, side, 3)).astype(np.float32)
    labels = np.array([1, 7, 3, 9], np.int32)

    def jloss(p):
        loss, (st, _lg) = jcnn.cnn_loss(p, state, jcfg, x, labels)
        return loss, st
    (jl, jst), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True,
                                               allow_int=True))(params)
    tp, ts = bridge.cnn_params_from_numpy(params, state, tcfg, "cpu")
    live = {n: {k: t.requires_grad_() if t.is_floating_point() else t
                for k, t in layer.items()} for n, layer in tp.items()}
    tl, (tst, logits) = tcnn.cnn_loss(live, ts, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(labels))
    assert logits.shape == (4, 10)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    flat = [t for layer in live.values() for t in layer.values()
            if t.requires_grad]
    grads = _grad_tree(torch.autograd.grad(tl, flat), live)
    got, got_st = bridge.cnn_params_to_numpy(grads, tst)
    n = 0
    for lname, layer in got.items():
        for k, g in layer.items():
            w = np.asarray(jg[lname][k], np.float32)
            assert g.shape == w.shape, (lname, k)
            assert _rel(g, w) <= 1e-4, (lname, k, _rel(g, w))
            n += 1
    assert n == sum(1 for layer in params.values() for a in layer.values()
                    if np.issubdtype(a.dtype, np.floating))
    assert got_st.keys() == jst.keys()
    for bn, st in got_st.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(st[k], np.asarray(jst[bn][k]),
                                       rtol=1e-5, atol=1e-5)
