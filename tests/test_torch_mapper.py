"""The port's perf model, tile balancer and mapper vs the JAX package: the
same (shape, rho, alpha dtype, target) must give the same plan (path, blocks,
cache policy, bound, alpha dtype; modeled II within 1e-12 relative), the
port's engine must plan on the CPU as the reference's does, and on the card
it must plan only the path that has a kernel there.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.hwmodel import perf_model as jpm
from repro.hwmodel import tile_balance as jtb
from repro.models import registry as jR
from repro.runtime import mapper as jmapper
from repro.serving import LLMEngine as JEngine
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import ovsf as tovsf
from repro_torch.hwmodel import perf_model as tpm
from repro_torch.hwmodel import tile_balance as ttb
from repro_torch.kernels import ops as tops
from repro_torch.models import bridge
from repro_torch.runtime import mapper as tmapper
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import plan_cfg

ROOT = Path(__file__).resolve().parents[1]
REF_TARGETS = ["v5e", "v5p", "v6e", "cpu"]
ADTS = ["", "int8", "int4"]


def _same_plan(got, want):
    """LayerPlan fields equal; the modeled II within 1e-12 relative."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    gi, wi = g.pop("ii_s"), w.pop("ii_s")
    assert g == w
    assert abs(gi - wi) <= 1e-12 * abs(wi)


def _same_exec_plan(got, want):
    assert got.hw_label == want.hw_label
    assert got.names() == want.names()
    for (_n, g), (_m, w) in zip(got.entries, want.entries):
        _same_plan(g, w)


def _with_alphas(cfg, alpha_dtype):
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf,
                                                alpha_dtype=alpha_dtype))


@pytest.mark.parametrize("name", REF_TARGETS)
def test_hw_registry_matches_reference(name):
    assert dataclasses.asdict(tpm.hw_by_name(name)) == dataclasses.asdict(
        jpm.hw_by_name(name))
    assert tpm.resolve_hw(tpm.hw_by_name(name)) is tpm.hw_by_name(name)


def test_h100_target():
    h = tpm.hw_by_name("h100")
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes, h.vmem_bytes,
            h.vpu_flops) == (989e12, 3.35e12, 80e9, 232_448, 67e12)
    assert tpm.hw_names() == ("v5e", "v5p", "v6e", "cpu", "h100")
    with pytest.raises(KeyError, match="unknown HW target"):
        tpm.hw_by_name("tpu9")


@pytest.mark.parametrize("M,K,N", [(4, 2048, 5632), (128, 5632, 2048),
                                   (1000, 96, 40), (7, 64, 64)])
@pytest.mark.parametrize("vmem", [96 * 2**20, 174_336])
def test_balance_blocks_matches_reference(M, K, N, vmem):
    g = ttb.balance_blocks(M, K, N, vmem_limit=vmem)
    w = jtb.balance_blocks(M, K, N, vmem_limit=vmem)
    assert dataclasses.asdict(g) == dataclasses.asdict(w)


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("seg", [0, 16])
@pytest.mark.parametrize("hw", REF_TARGETS)
def test_classify_gemm_matches_reference(hw, seg, alpha_dtype):
    n = 0
    for M in (1, 4, 128, 2048):
        for d_in, d_out in ((2048, 2048), (2048, 5632), (5632, 2048),
                            (1000, 1000), (128, 96)):
            for rho in (0.25, 0.5, 1.0):
                for reuse in (1, 256):
                    for paths in (tmapper.DEFAULT_PATHS, tmapper.ALL_PATHS):
                        kw = dict(seg=seg, hw=hw, name="mlp_up",
                                  weight_reuse=reuse, paths=paths,
                                  alpha_dtype=alpha_dtype)
                        _same_plan(tmapper.classify_gemm(M, d_in, d_out, rho,
                                                         **kw),
                                   jmapper.classify_gemm(M, d_in, d_out, rho,
                                                         **kw))
                        n += 1
    assert n == 240


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("hw", REF_TARGETS)
def test_plan_model_matches_reference(hw, full, alpha_dtype):
    jc = _with_alphas((j_full if full else j_smoke)("tinyllama_1_1b"),
                      alpha_dtype)
    tc = _with_alphas((t_full if full else t_smoke)("tinyllama_1_1b"),
                      alpha_dtype)
    for batch in (1, 4):
        for reuse in (1, None):
            _same_exec_plan(
                tmapper.plan_model(tc, TShape("d", 1, batch, "decode"),
                                   hw=hw, weight_reuse=reuse),
                jmapper.plan_model(jc, JShape("d", 1, batch, "decode"),
                                   hw=hw, weight_reuse=reuse))


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_h100_plans_fused_for_full_tinyllama_decode(alpha_dtype):
    cfg = _with_alphas(t_full("tinyllama_1_1b"), alpha_dtype)
    plan = tmapper.plan_model(cfg, TShape("serve_decode", 1, 4, "decode"),
                              hw="h100", weight_reuse=1)
    assert plan.hw_label == "h100"
    assert {n: p.path for n, p in plan.entries} == dict.fromkeys(
        ("attn_q", "attn_o", "mlp_gate", "mlp_up", "mlp_down"), "fused")
    assert all(p.alpha_dtype == alpha_dtype for _n, p in plan.entries)
    assert plan.plan_for("L3/mlp_up") is plan.plan_for("mlp_up")
    assert tmapper.apply_plan(cfg, plan).exec_plan is plan
    hash(tmapper.apply_plan(cfg, plan))           # configs stay hashable


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("batch_slots", [1, 4])
def test_engine_plan_matches_reference_engine(batch_slots, alpha_dtype):
    """On the CPU the port's engine plans against the ``cpu`` target with
    the reference's default candidates, as the JAX engine does with
    ``hw="cpu"``."""
    jcfg = _with_alphas(j_smoke("tinyllama_1_1b"), alpha_dtype)
    tcfg = _with_alphas(t_smoke("tinyllama_1_1b"), alpha_dtype)
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    kw = dict(batch_slots=batch_slots, buffer_len=64, chunk_size=8,
              packed=True, paged=True, page_size=8)
    jeng = JEngine(jparams, jcfg, hw="cpu", **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    _same_exec_plan(teng.cfg.exec_plan, jeng.cfg.exec_plan)
    assert teng.cfg.exec_plan.hw_label == "cpu"


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("batch_slots", [4, 1024])
def test_card_plan_has_fused_only(batch_slots, alpha_dtype):
    """On the card the engine plans with the reference's candidates
    (``materialize`` and ``fused``, both with a hand-written kernel there):
    its plan is the h100 model's own choice, every weight type ``fused`` at
    the main path's 4 slots (full-width TinyLlama decode, every alpha
    storage), and not all ``fused`` at 1024 slots, where the model prefers
    ``materialize``."""
    cfg = _with_alphas(t_full("tinyllama_1_1b"), alpha_dtype)
    planned = plan_cfg(cfg, batch_slots, "cuda")
    plan = planned.exec_plan
    assert plan.hw_label == "h100"
    free = tmapper.plan_model(cfg, TShape("d", 1, batch_slots, "decode"),
                              hw="h100", paths=tmapper.DEFAULT_PATHS,
                              weight_reuse=1)
    assert {n: p.path for n, p in plan.entries} == {
        n: p.path for n, p in free.entries}
    assert sorted(n for n, _p in plan.entries) == sorted(
        ("attn_q", "attn_o", "mlp_gate", "mlp_up", "mlp_down"))
    assert ({p.path for _n, p in plan.entries} == {"fused"}) == (
        batch_slots == 4)
    assert plan_cfg(planned, batch_slots, "cpu") is planned  # a plan stays
    assert plan_cfg(cfg, batch_slots, "cpu").exec_plan.hw_label == "cpu"


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("path", ["materialize", "spectral"])
def test_plain_paths_refuse_off_the_cpu(path, alpha_dtype):
    """``materialize`` of segmented codes goes to the segmented
    ``ovsf_decompress`` kernel: on any device but the CPU (here ``meta``,
    standing in for the card) a plan naming it reaches the wrapper, whose
    device check refuses meta, and never runs plain tensor code.
    ``spectral`` of segmented codes is plain tensor code on every device, as
    the reference's jnp is (the multi-model gateway's path): off the CPU it
    runs."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    al = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    idx = torch.from_numpy(np.stack([np.sort(rng.choice(16, 8, replace=False))
                                     for _ in range(16)]).astype(np.int32))
    s = None
    if alpha_dtype:
        al, s = tovsf.quantize_alphas(al, 16, alpha_dtype)
    kw = dict(plan=tmapper.LayerPlan(path), alpha_scale=s,
              alpha_dtype=alpha_dtype)
    want = tops.ovsf_matmul(x, al, idx, path="fused", alpha_scale=s,
                            alpha_dtype=alpha_dtype)
    torch.testing.assert_close(tops.ovsf_matmul(x, al, idx, **kw), want,
                               rtol=2e-3, atol=2e-3)      # runs on the CPU
    meta = [t.to("meta") for t in (x, al, idx)]
    kw["alpha_scale"] = None if s is None else s.to("meta")
    if path == "spectral":
        out = tops.ovsf_matmul(*meta, **kw)
        assert out.device.type == "meta" and out.shape == want.shape
        return
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported device"):
        tops.ovsf_matmul(*meta, **kw)


def test_import_of_new_modules_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch.runtime.mapper, "
            "repro_torch.hwmodel.perf_model, repro_torch.hwmodel.tile_balance"
            ", repro_torch.kernels.ops, repro_torch.runtime.calibrate, "
            "repro_torch.hwmodel.autotune, repro_torch.hwmodel.cnn_workload, "
            "repro_torch.hwmodel.dse, repro_torch.checkpoint.ckpt, "
            "repro_torch.models.registry, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.configs.qwen2_5_14b, "
            "repro_torch.configs.qwen1_5_32b; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
