"""The port's spectral slice vs the JAX package, on the CPU at small sizes:
``kernels.fwht`` (its plain version) against the Pallas ``fwht_pallas`` in
interpret mode, the monolithic ``spectral`` path of ``ops.ovsf_matmul``,
the three paths under mapper plans, ``mapper.plan_cnn`` entry by entry, and
CNN forwards under a plan.

Inputs are made with numpy (or by the reference's own init) and handed to
both. The CUDA ``fwht`` is held against ``fwht_plain`` on the card by
``chip_smoke.py``.

Tolerances: ``fwht`` in fp32 atol 1e-4 * L and rtol 1e-2, in bf16 atol
0.1 * sqrt(L) (the reference kernel test's own: the Pallas kernel sums by
two matmuls, the plain version by butterflies), exact on integer-valued
inputs; the spectral GEMM 2e-3; the three paths bit for bit on
integer-valued inputs (every sum is exact in fp32); planned CNN logits
within 1e-4 relative L2 error (as the unplanned ones in
``test_torch_cnn.py``); plans equal field by field, the modeled II within
1e-9 relative.
"""
import collections
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import ovsf as jovsf
from repro.kernels import ops as jops
from repro.kernels.fwht import fwht_pallas
from repro.models import cnn as jcnn
from repro.runtime import mapper as jmapper
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.core import ovsf as tovsf
from repro_torch.kernels import fwht as tfwht
from repro_torch.kernels import ops as tops
from repro_torch.models import bridge
from repro_torch.models import cnn as tcnn
from repro_torch.runtime import mapper as tmapper

LOGITS_REL = 1e-4
CNNS = ("resnet18", "resnet50", "squeezenet1_1")
N_OVSF = {"resnet18": 12, "resnet50": 13, "squeezenet1_1": 6}


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# fwht
# ---------------------------------------------------------------------------

def _pallas(x):
    return np.asarray(fwht_pallas(jnp.asarray(x), interpret=True, block_m=8)
                      .astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 2, 8, 64, 256, 2048])
def test_fwht_plain_matches_pallas_interpret(L, dtype):
    """Ragged M (not a multiple of the Pallas block) and leading batch dims;
    the output keeps x's type."""
    rng = np.random.default_rng(L)
    tol = (dict(atol=1e-4 * L, rtol=1e-2) if dtype == "float32"
           else dict(atol=0.1 * np.sqrt(L), rtol=1e-2))
    for shape in ((13, L), (2, 3, L)):
        x = rng.standard_normal(shape).astype(np.float32)
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        got = tfwht.fwht(tx)
        assert got.shape == shape and got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), _pallas(jx), **tol)
    assert tfwht.fwht.launches == 0


@pytest.mark.parametrize("L", [1, 8, 256, 2048])
def test_fwht_plain_exact_on_integers(L):
    x = np.random.default_rng(L).integers(-4, 5, (9, L)).astype(np.float32)
    np.testing.assert_array_equal(_np(tfwht.fwht(torch.from_numpy(x))),
                                  _pallas(x))
    # the ops-level name is the same wrapper
    assert tops.fwht is tfwht.fwht


@pytest.mark.parametrize("shape,dtype,match", [
    ((4, 12), torch.float32, "power of two, got 12"),
    ((2, 0), torch.float32, "power of two, got 0"),
    ((1, 65536), torch.float32, "above the kernel's limit 32768"),
    ((3, 8), torch.float64, "must be float32 or bfloat16"),
    ((3, 8), torch.int32, "must be float32 or bfloat16")])
def test_fwht_refuses_before_any_launch(shape, dtype, match):
    """The wrapper's refusals hold on every device, before any launch."""
    for dev in ("cpu", "meta"):
        x = torch.zeros(shape, dtype=dtype, device=dev)
        with pytest.raises(ValueError, match=match):
            tfwht.fwht(x)
    assert tfwht.fwht.launches == 0


def test_fwht_off_the_cpu_never_runs_plain():
    """A tensor on another device than the CPU (``meta`` standing in for
    the card) reaches the device check, never ``fwht_plain``."""
    with pytest.raises(ValueError, match="fwht: unsupported device"):
        tfwht.fwht(torch.zeros((3, 8), device="meta"))
    assert tfwht.fwht.launches == 0


# ---------------------------------------------------------------------------
# the spectral path
# ---------------------------------------------------------------------------

def _mono(d_in, d_out, M, seed):
    rng = np.random.default_rng(seed)
    L = jovsf.next_pow2(d_in)
    J = L // 2
    idx = np.sort(rng.choice(L, J, replace=False)).astype(np.int32)
    al = (rng.standard_normal((J, d_out)) / np.sqrt(J)).astype(np.float32)
    x = rng.standard_normal((M, d_in)).astype(np.float32)
    return x, al, idx


@pytest.mark.parametrize("alpha_dtype", ["", "int8", "int4"])
@pytest.mark.parametrize("d_in,d_out,M", [(100, 24, 7), (128, 40, 5),
                                          (288, 16, 3)])
def test_spectral_matmul_matches_reference_pallas(d_in, d_out, M,
                                                  alpha_dtype):
    """Monolithic codes at a ragged d_in (100 -> L 128) and a power of two:
    the port's ``spectral`` path vs the reference's with the Pallas
    ``fwht_pallas`` in interpret mode; quantised alphas are dequantised
    first on both sides."""
    x, al, idx = _mono(d_in, d_out, M, seed=d_in + M)
    s = None
    if alpha_dtype:
        al, s = (np.array(a) for a in
                 jovsf.quantize_alphas(jnp.asarray(al), 1, alpha_dtype))
    want = np.asarray(jax.jit(functools.partial(
        jops.spectral_matmul, alpha_dtype=alpha_dtype, use_pallas=True,
        interpret=True))(x, al, idx, alpha_scale=s))
    kw = dict(alpha_dtype=alpha_dtype,
              alpha_scale=None if s is None else torch.from_numpy(s))
    got = tops.ovsf_matmul(torch.from_numpy(x).reshape(1, M, d_in),
                           torch.from_numpy(al), torch.from_numpy(idx),
                           path="spectral", **kw)
    assert got.shape == (1, M, d_out)
    np.testing.assert_allclose(_np(got)[0], want, rtol=2e-3, atol=2e-3)


def test_spectral_off_the_cpu_reaches_fwht():
    """Off the CPU (``meta`` standing in for the card) monolithic codes
    reach the ``fwht`` wrapper, whose device check refuses meta; segmented
    codes run their plain per-segment WHT on any device (the reference's
    is plain jnp, not ``fwht_pallas``)."""
    x, al, idx = _mono(100, 8, 3, seed=0)
    mx, mal, midx = (torch.from_numpy(a).to("meta") for a in (x, al, idx))
    with pytest.raises(ValueError, match="fwht: unsupported device"):
        tops.ovsf_matmul(mx, mal, midx, path="spectral")
    with pytest.raises(ValueError, match="fwht: unsupported device"):
        tops.spectral_transform(mx, midx)
    seg_idx = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    x64 = torch.zeros((3, 64), device="meta")
    assert tops.spectral_transform(x64, seg_idx).shape == (3, 32)
    out = tops.ovsf_matmul(x64, torch.zeros((32, 8), device="meta"), seg_idx,
                           path="spectral")
    assert out.device.type == "meta" and out.shape == (3, 8)


def _integer_case(d_in, d_out, rho, seg, seed=0):
    """Integer-valued alphas and activations: every path is exact in fp32,
    so the three paths must agree bit for bit."""
    spec = jovsf.OVSFSpec(d_in, d_out, rho=rho, seg=seg)
    p = jovsf.init_ovsf(jax.random.PRNGKey(seed), spec, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    al = rng.integers(-4, 5, p["alphas"].shape).astype(np.float32)
    x = rng.integers(-4, 5, (16, d_in)).astype(np.float32)
    return x, al, np.asarray(p["idx"])


@pytest.mark.parametrize("seg", [0, 16])
def test_paths_bit_identical_under_plans(seg):
    """Port of the reference's ``test_paths_bit_identical_under_plans``: the
    port's three paths under plans agree bit for bit and equal the
    reference's output."""
    x, al, idx = _integer_case(256, 128, 0.5, seg)
    tbase = tmapper.classify_gemm(16, 256, 128, 0.5, seg=seg,
                                  paths=tmapper.ALL_PATHS)
    jbase = jmapper.classify_gemm(16, 256, 128, 0.5, seg=seg,
                                  paths=jmapper.ALL_PATHS)
    want = np.asarray(jops.ovsf_matmul(
        jnp.asarray(x), jnp.asarray(al), jnp.asarray(idx),
        plan=dataclasses.replace(jbase, path="materialize")))
    for path in tops.EXEC_PATHS:
        got = tops.ovsf_matmul(torch.from_numpy(x), torch.from_numpy(al),
                               torch.from_numpy(idx),
                               plan=dataclasses.replace(tbase, path=path))
        np.testing.assert_array_equal(_np(got), want)
        ref = np.asarray(jops.ovsf_matmul(
            jnp.asarray(x), jnp.asarray(al), jnp.asarray(idx),
            plan=dataclasses.replace(jbase, path=path)))
        np.testing.assert_array_equal(ref, want)


# ---------------------------------------------------------------------------
# plan_cnn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", ["v5e", "cpu"])
@pytest.mark.parametrize("all_paths", [False, True])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", CNNS)
def test_plan_cnn_matches_reference(name, batch, all_paths, hw):
    """Entry by entry: name, path, blocks, cache policy, bound, alpha dtype;
    the modeled II within 1e-9 relative."""
    tpaths = tmapper.ALL_PATHS if all_paths else tmapper.DEFAULT_PATHS
    jpaths = jmapper.ALL_PATHS if all_paths else jmapper.DEFAULT_PATHS
    got = tmapper.plan_cnn(tget_config(name), batch=batch, hw=hw,
                           paths=tpaths)
    want = jmapper.plan_cnn(jget_config(name), batch=batch, hw=hw,
                            paths=jpaths)
    assert got.hw_label == want.hw_label == hw
    assert got.names() == want.names()
    assert len(got.entries) == N_OVSF[name]
    for (_n, g), (_m, w) in zip(got.entries, want.entries):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        gi, wi = gd.pop("ii_s"), wd.pop("ii_s")
        assert gd == wd
        assert abs(gi - wi) <= 1e-9 * abs(wi)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", CNNS)
def test_plan_cnn_h100_paths(name, batch):
    """On the ``h100`` target at full width, every OVSF conv is planned
    ``materialize`` under the default candidates and ``spectral`` under all
    three; the plan's defaults are the reference's (v5e, batch 1)."""
    cfg = tget_config(name)
    for paths, want in ((tmapper.DEFAULT_PATHS, "materialize"),
                        (tmapper.ALL_PATHS, "spectral")):
        plan = tmapper.plan_cnn(cfg, batch=batch, hw="h100", paths=paths)
        assert plan.hw_label == "h100"
        assert [p.path for _n, p in plan.entries] == [want] * N_OVSF[name]
    assert tmapper.plan_cnn(cfg) == tmapper.plan_cnn(cfg, batch=1, hw="v5e")
    planned = cfg.replace(exec_plan=tmapper.plan_cnn(cfg))
    hash(planned)                                 # configs stay hashable


# ---------------------------------------------------------------------------
# planned CNN forwards
# ---------------------------------------------------------------------------

def _perturb_bn(params, state, seed):
    rng = np.random.default_rng(seed)
    for lname in state:
        c = state[lname]["mean"].shape[0]
        params[lname] = {
            "scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
        state[lname] = {
            "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
            "var": np.exp(0.2 * rng.standard_normal(c)).astype(np.float32)}
    return params, state


@pytest.mark.parametrize("hw", ["cpu", "v5e"])
@pytest.mark.parametrize("name,wm", [("resnet18", 0.25), ("resnet50", 0.25),
                                     ("squeezenet1_1", 0.25),
                                     ("squeezenet1_1", 0.5)])
def test_planned_logits_match_reference(name, wm, hw, monkeypatch):
    """Smoke configs in matrix mode with bridged reference weights and
    non-trivial BN, under an ``ALL_PATHS`` plan (target ``cpu``: every conv
    ``spectral``; ``v5e``: ``fused`` and ``spectral`` mixed), against the
    reference's forward under its own plan: logits within 1e-4 relative L2
    error, and each OVSF conv runs the path its plan names."""
    over = dict(ovsf_mode="matrix", width_mult=wm)
    jcfg = jget_smoke_config(name)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, **over})
    tcfg = tget_smoke_config(name).replace(**over)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "exec_plan": jmapper.plan_cnn(
        jcfg, batch=2, hw=hw, paths=jmapper.ALL_PATHS)})
    tcfg = tcfg.replace(exec_plan=tmapper.plan_cnn(
        tcfg, batch=2, hw=hw, paths=tmapper.ALL_PATHS))
    params, state = jcnn.cnn_init(jax.random.PRNGKey(1), jcfg)
    params, state = _perturb_bn(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, state), 2)
    x = np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, s, x: jcnn.cnn_apply(p, s, jcfg, x)[0])(params, state, x))
    tp, ts = bridge.cnn_params_from_numpy(params, state, tcfg, "cpu")
    calls = collections.Counter()
    for path, fn in (("spectral", "fwht"), ("fused", "ovsf_gemm"),
                     ("materialize", "ovsf_decompress")):
        real = getattr(tops, fn)
        monkeypatch.setattr(tops, fn, lambda *a, _r=real, _p=path, **k:
                            calls.update([_p]) or _r(*a, **k))
    got, _ = tcnn.cnn_apply(tp, ts, tcfg, torch.from_numpy(x))
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    assert _rel(_np(got), want) <= LOGITS_REL
    ovsf = [n for n, p in tp.items() if "alphas" in p]
    assert ovsf and calls == collections.Counter(
        tcfg.exec_plan.plan_for(n).path for n in ovsf)
    if hw == "cpu":
        assert set(calls) == {"spectral"}


def test_spatial_mode_ignores_the_plan(monkeypatch):
    """Spatial mode reconstructs its filters and convolves them, plan or
    no plan, as the reference does."""
    tcfg = tget_smoke_config("resnet18").replace(ovsf_mode="spatial")
    tp, ts = tcnn.cnn_init(tcfg, 0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    want, _ = tcnn.cnn_apply(tp, ts, tcfg, x)
    monkeypatch.setattr(tops, "fwht", None)       # any call would fail
    planned = tcfg.replace(exec_plan=tmapper.plan_cnn(
        tcfg, batch=1, hw="cpu", paths=tmapper.ALL_PATHS))
    got, _ = tcnn.cnn_apply(tp, ts, planned, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["resnet50", "squeezenet1_1"])
def test_chip_smoke_fwht_shapes_are_the_planned_forwards(name):
    """``chip_smoke.py`` checks and sums the kernel at (M, L, calls per
    forward) constants: they must be the ``fwht`` calls of a full-width
    forward at batch 8 under the h100 ``ALL_PATHS`` plan, reckoned here
    from the layer shapes alone."""
    cfg = tget_config(name).replace(ovsf_mode="matrix")
    plan = tmapper.plan_cnn(cfg, batch=8, hw="h100", paths=tmapper.ALL_PATHS)
    side = cfg.in_hw // 4                       # after stem and max-pool
    shapes = collections.Counter()
    if name == "squeezenet1_1":
        for i, (sq, _e1, _e3, _stage) in enumerate(tcnn._fire_widths(cfg)):
            if plan.plan_for(f"f{i}e3") is not None:
                shapes[(8 * side * side, tovsf.next_pow2(9 * sq))] += 1
            if i in tcnn._POOL_AFTER:
                side = (side + 1) // 2
        want = _chip_smoke().SQUEEZENET_FWHT
    else:
        for d in tcnn._resnet_layers(cfg)[1:-1]:
            if d["name"].endswith("proj"):
                continue
            side = -(-side // d["stride"])
            if plan.plan_for(d["name"]) is not None and d["k"] == 3:
                shapes[(8 * side * side,
                        tovsf.next_pow2(9 * d["c_in"]))] += 1
        want = _chip_smoke().RESNET50_FWHT
    assert shapes == {(m, L): c for m, L, c in want}
    assert sum(shapes.values()) == N_OVSF[name]
