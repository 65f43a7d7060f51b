"""The port's model-level perf model, CNN workloads, rho autotuner,
``suggest_rhos`` and DSE vs the JAX package: the same inputs must give the
same layers (field for field), bounds, ratios and design points, and every
modeled time within 1e-12 relative.
"""
import dataclasses

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.hwmodel import autotune as jat
from repro.hwmodel import cnn_workload as jcw
from repro.hwmodel import dse as jdse
from repro.hwmodel import perf_model as jpm
from repro.models import cnn as jcnn
from repro.runtime import mapper as jmapper
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.hwmodel import autotune as tat
from repro_torch.hwmodel import cnn_workload as tcw
from repro_torch.hwmodel import dse as tdse
from repro_torch.hwmodel import perf_model as tpm
from repro_torch.models import cnn as tcnn
from repro_torch.runtime import mapper as tmapper

REF_TARGETS = ["v5e", "v5p", "v6e", "cpu"]
ADTS = ["", "int8", "int4"]
CNNS = ["resnet18", "resnet34", "resnet50", "squeezenet1_1"]
RTOL = 1e-12


def _close(got: float, want: float) -> None:
    assert abs(got - want) <= RTOL * abs(want), (got, want)


def _j_hw(hw: tpm.HW) -> jpm.HW:
    """The reference's HW with the port target's constants (for h100)."""
    return jpm.HW(**dataclasses.asdict(hw))


def _same_layers(got, want):
    assert [dataclasses.asdict(l) for l in got] == \
        [dataclasses.asdict(l) for l in want]


def _same_timing(got, want):
    _same_layers(got.layers, want.layers)
    assert got.bounds == want.bounds
    _close(got.total_s, want.total_s)
    assert abs(got.wasted_s - want.wasted_s) <= RTOL * want.total_s
    _close(got.step_efficiency, want.step_efficiency)
    for g, w in zip(got.timings, want.timings):
        _close(g.ii, w.ii)
        assert g.bound == w.bound
        assert abs(g.t_wasted - w.t_wasted) <= RTOL * w.ii


def _same_tune(got, want):
    assert got.rhos == want.rhos and got.bounds == want.bounds
    assert got.steps == want.steps
    _close(got.baseline_total_s, want.baseline_total_s)
    _close(got.tuned_total_s, want.tuned_total_s)


def _with(cfg, **ovsf):
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, **ovsf))


# -- perf model ----------------------------------------------------------------

@pytest.mark.parametrize("factor", [0.125, 0.5, 1.0, 8.0])
@pytest.mark.parametrize("hw", REF_TARGETS)
def test_scaled_bw_matches_reference(hw, factor):
    assert dataclasses.asdict(tpm.hw_by_name(hw).scaled_bw(factor)) == \
        dataclasses.asdict(jpm.hw_by_name(hw).scaled_bw(factor))
    assert tpm.H100.scaled_bw(factor).hbm_bw == 3.35e12 * factor


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("hw", REF_TARGETS)
def test_model_timing_and_throughput_match_reference(hw, alpha_dtype):
    for arch in ("tinyllama_1_1b", "qwen2_5_14b", "qwen1_5_32b"):
        jc, tc = (_with(f(arch), alpha_dtype=alpha_dtype)
                  for f in (j_full, t_full))
        for shape in ("train_4k", "decode_32k"):
            kw = dict(n_devices=256, tp=16, m_valid=200, kv_len=1024)
            tl = tpm.model_layers(tc, T_SHAPES[shape], **kw)
            jl = jpm.model_layers(jc, J_SHAPES[shape], **kw)
            _same_timing(tpm.model_timing(tl, tpm.hw_by_name(hw)),
                         jpm.model_timing(jl, jpm.hw_by_name(hw)))
            _close(tpm.throughput(tl, tpm.hw_by_name(hw), 32.0),
                   jpm.throughput(jl, jpm.hw_by_name(hw), 32.0))
            name = tl[5].name
            assert tpm.model_timing(tl, tpm.hw_by_name(hw)).bound_of(name) \
                == jpm.model_timing(jl, jpm.hw_by_name(hw)).bound_of(name)
    with pytest.raises(KeyError):
        tpm.model_timing(tl).bound_of("nope")
    assert tpm.throughput([]) == jpm.throughput([]) == float("inf")


@pytest.mark.parametrize("valid,batch,kv_len", [(4, 4, 0), (3, 256, 512),
                                                (61, 64, 128), (1, 1, 32768)])
@pytest.mark.parametrize("hw", REF_TARGETS)
def test_serve_step_timing_matches_reference(hw, valid, batch, kv_len):
    for full in (False, True):
        jc = (j_full if full else j_smoke)("tinyllama_1_1b")
        tc = (t_full if full else t_smoke)("tinyllama_1_1b")
        kw = dict(valid_tokens=valid, batch_tokens=batch, kv_len=kv_len)
        _same_timing(tpm.serve_step_timing(tc, hw=tpm.hw_by_name(hw), **kw),
                     jpm.serve_step_timing(jc, hw=jpm.hw_by_name(hw), **kw))


def test_padding_efficiency_matches_reference():
    for v, b in ((0, 0), (3, 4), (61, 64), (4, 4)):
        assert tpm.padding_efficiency(v, b) == jpm.padding_efficiency(v, b)


# -- CNN workloads -------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("arch", CNNS)
def test_cnn_gemm_layers_match_reference(arch, batch):
    for tc, jc in ((t_full(arch), j_full(arch)),
                   (t_smoke(arch), j_smoke(arch)),
                   (dataclasses.replace(t_full(arch), ovsf_enable=False),
                    dataclasses.replace(j_full(arch), ovsf_enable=False))):
        _same_layers(tcw.cnn_gemm_layers(tc, batch),
                     jcw.cnn_gemm_layers(jc, batch))
        for keep in (0.25, 0.5, 0.75):
            _same_layers(tcw.pruned_variant(tcw.cnn_gemm_layers(tc, batch),
                                            keep),
                         jcw.pruned_variant(jcw.cnn_gemm_layers(jc, batch),
                                            keep))


def test_cnn_gemm_layers_track_the_real_sides():
    """ResNet-50 at batch 8: the OVSF convs' rows are the forward's im2col
    rows (56 -> 28 -> 14 -> 7 after each stage's stride-2 conv), unlike
    ``mapper._resnet_convs``, which halves again at ``proj``."""
    cfg = t_full("resnet50").replace(ovsf_mode="matrix")
    ovsf = [l for l in tcw.cnn_gemm_layers(cfg, 8) if l.ovsf]
    assert [l.M for l in ovsf] == [6272] * 4 + [1568] * 6 + [392] * 3
    assert [(l.d_in, l.d_out) for l in ovsf[:1] + ovsf[4:5] + ovsf[10:11]] \
        == [(1152, 128), (2304, 256), (4608, 512)]
    planned = {n: hw for n, _ci, _co, _k, _s, rho, hw
               in tmapper._resnet_convs(cfg) if rho < 1.0}
    assert planned["s1b1c2"] == 14 and planned["s1b0c2"] == 28
    sq = [l for l in tcw.cnn_gemm_layers(t_full("squeezenet1_1"), 8)
          if l.ovsf]
    assert [(l.M, l.d_in, l.d_out) for l in sq] == \
        [(6272, 288, 128)] * 2 + [(1568, 432, 192)] * 2 + \
        [(1568, 576, 256)] * 2


@pytest.mark.parametrize("name", ["ZC706", "ZU7EV"])
def test_fpga_constants_match_reference(name):
    assert dataclasses.asdict(getattr(tcw, name)) == \
        dataclasses.asdict(getattr(jcw, name))
    assert tcw.T_R == jcw.T_R


# -- rho autotuner -------------------------------------------------------------

@pytest.mark.parametrize("rho,n,bw", [(0.25, 20, 1.0), (0.125, 12, 0.25)])
def test_autotune_rhos_matches_reference_lm(rho, n, bw):
    """The reference's ``test_perf_model`` cases: qwen2_5_14b train_4k."""
    tc, jc = _with(t_full("qwen2_5_14b"), rho=rho), \
        _with(j_full("qwen2_5_14b"), rho=rho)
    tl = tpm.model_layers(tc, T_SHAPES["train_4k"], n_devices=256, tp=16)[:n]
    jl = jpm.model_layers(jc, J_SHAPES["train_4k"], n_devices=256, tp=16)[:n]
    got = tat.autotune_rhos(tl, tpm.V5E.scaled_bw(bw))
    _same_tune(got, jat.autotune_rhos(jl, jpm.V5E.scaled_bw(bw)))
    for l in tl:
        if l.ovsf:
            assert got.rhos[l.name] >= l.rho - 1e-9
    assert got.tuned_total_s <= got.baseline_total_s * (1 + 1e-6)
    if bw < 1.0:
        assert all(got.bounds[k] != "W" for k, r in got.rhos.items()
                   if r < 1.0)


@pytest.mark.parametrize("slack", [1.0, 0.5])
@pytest.mark.parametrize("bw", [1.1e9, 2.2e9, 4.4e9])
def test_autotune_rhos_matches_reference_table1(bw, slack):
    """ResNet-18 from OVSF25-analogue ratios at ZC706 1.1 / 2.2 / 4.4 GB/s,
    as ``benchmarks/table1_autotune.py`` runs it."""
    kw = dict(name="resnet18", depth="resnet18", ovsf_enable=True,
              block_rhos=(1.0, 0.4, 0.25, 0.125))
    tl = tcw.cnn_gemm_layers(tcnn.CNNConfig(**kw), batch=1)
    jl = jcw.cnn_gemm_layers(jcnn.CNNConfig(**kw), batch=1)
    thw = dataclasses.replace(tcw.ZC706, hbm_bw=bw)
    jhw = dataclasses.replace(jcw.ZC706, hbm_bw=bw)
    _same_timing(tpm.model_timing(tl, thw), jpm.model_timing(jl, jhw))
    got = tat.autotune_rhos(tl, thw, slack=slack)
    _same_tune(got, jat.autotune_rhos(jl, jhw, slack=slack))
    uni_t = [dataclasses.replace(l, rho=1.0) for l in tl]
    uni_j = [dataclasses.replace(l, rho=1.0) for l in jl]
    _close(tpm.model_timing(uni_t, thw).total_s,
           jpm.model_timing(uni_j, jhw).total_s)
    if bw == 1.1e9 and slack == 1.0:
        assert got.steps                    # the paper's raises at 1.1 GB/s


def test_rho_ladder_matches_reference():
    assert tat.RHO_LADDER == jat.RHO_LADDER


@pytest.mark.parametrize("batch", [1, 4, 128])
@pytest.mark.parametrize("hw", REF_TARGETS + ["h100"])
def test_suggest_rhos_matches_reference(hw, batch):
    for rho in (0.125, 0.5):
        tc = _with(t_full("tinyllama_1_1b"), rho=rho)
        jc = _with(j_full("tinyllama_1_1b"), rho=rho)
        shape_t = TShape("serve_decode", 1, batch, "decode")
        shape_j = JShape("serve_decode", 1, batch, "decode")
        jhw = _j_hw(tpm.hw_by_name(hw)) if hw == "h100" else hw
        _same_tune(tmapper.suggest_rhos(tc, shape_t, hw=hw),
                   jmapper.suggest_rhos(jc, shape_j, hw=jhw))


# -- DSE -----------------------------------------------------------------------

def _same_points(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.exec_path, g.tp, g.feasible, g.hbm_per_device) == \
            (w.exec_path, w.tp, w.feasible, w.hbm_per_device)
        assert dataclasses.asdict(g.blocks) == dataclasses.asdict(w.blocks)
        _close(g.total_s, w.total_s)


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_dse_explore_matches_reference(alpha_dtype):
    tc = _with(t_full("qwen1_5_32b"), alpha_dtype=alpha_dtype)
    jc = _with(j_full("qwen1_5_32b"), alpha_dtype=alpha_dtype)
    _same_points(tdse.explore(tc, T_SHAPES["decode_32k"], n_devices=4,
                              tps=(4,)),
                 jdse.explore(jc, J_SHAPES["decode_32k"], n_devices=4,
                              tps=(4,)))
    tc = _with(t_full("tinyllama_1_1b"), alpha_dtype=alpha_dtype)
    jc = _with(j_full("tinyllama_1_1b"), alpha_dtype=alpha_dtype)
    got = tdse.explore(tc, T_SHAPES["decode_32k"], hw=tpm.H100, n_devices=1,
                       tps=(1,))
    _same_points(got, jdse.explore(jc, J_SHAPES["decode_32k"],
                                   hw=_j_hw(tpm.H100), n_devices=1, tps=(1,)))
    assert [p.feasible for p in got] == [True] * 3


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("hw", ["v5e", "cpu"])
def test_dse_explore_matches_reference_tinyllama(hw, shape):
    """TinyLlama over the default 256 devices and TP 8 / 16 / 32."""
    _same_points(
        tdse.explore(t_full("tinyllama_1_1b"), T_SHAPES[shape],
                     hw=tpm.hw_by_name(hw)),
        jdse.explore(j_full("tinyllama_1_1b"), J_SHAPES[shape],
                     hw=jpm.hw_by_name(hw)))


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen2_5_14b",
                                  "qwen1_5_32b"])
def test_hbm_per_device_matches_eval_shape(arch, alpha_dtype):
    """The port's ``model_init_specs`` (``meta`` tensors) count the bytes
    the reference's ``jax.eval_shape`` does, at full width, unallocated."""
    tc = _with(t_full(arch), alpha_dtype=alpha_dtype)
    jc = _with(j_full(arch), alpha_dtype=alpha_dtype)
    for n_dev, tp, train, cache in ((1, 1, False, 0.0), (4, 4, True, 1e9)):
        kw = dict(train=train, cache_bytes=cache)
        assert tdse.hbm_per_device(tc, n_dev, tp, **kw) == \
            jdse.hbm_per_device(jc, n_dev, tp, **kw)
