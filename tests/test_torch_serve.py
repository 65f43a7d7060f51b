"""The port's serving slice vs the JAX package on the smoke TinyLlama config
(fp32, OVSF layers on the ``fused`` path): the parameter bridge, one paged
packed step's logits (rtol = atol = 1e-4) and greedy token streams of the
paged + packed ``LLMEngine`` (identical), plus the port's import boundary
and device contract.
"""
import dataclasses
import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import registry as jR
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SamplingParams as TSampling

torch.backends.cuda.matmul.allow_tf32 = False
ROOT = Path(__file__).resolve().parents[1]


def _fused(cfg):
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, exec_path="fused"))


@functools.lru_cache(maxsize=1)
def _smoke():
    jcfg = _fused(j_smoke("tinyllama_1_1b"))
    tcfg = _fused(t_smoke("tinyllama_1_1b"))
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree


def _assert_tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_bridge_round_trip():
    _jcfg, tcfg, _jp, tree = _smoke()
    tparams = bridge.params_from_numpy(tree, tcfg, "cpu")
    assert len(tparams["blocks"]) == tcfg.n_layers
    assert tparams["blocks"][1]["attn"]["q"]["idx"].dtype == torch.int32
    _assert_tree_equal(bridge.params_to_numpy(tparams), tree)


def test_native_init_matches_reference_layout():
    """Same keys, shapes and dtypes as the reference's init."""
    _jcfg, tcfg, _jp, tree = _smoke()
    got = bridge.params_to_numpy(tR.model_init(tcfg, 0, "cpu"))

    def layout(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {jax.tree_util.keystr(p): (v.shape, v.dtype) for p, v in leaves}

    assert layout(got) == layout(tree)


@pytest.mark.parametrize("name,d_in,d_out", [
    ("attn_q", 2048, 2048), ("attn_k", 2048, 256), ("attn_v", 2048, 256),
    ("attn_o", 2048, 2048), ("mlp_gate", 2048, 5632), ("mlp_up", 2048, 5632),
    ("mlp_down", 5632, 2048), ("attn_k", 128, 64)])
def test_ovsf_eligibility_matches_reference(name, d_in, d_out):
    """Full width: k/v (d_out 256 < min_dim 512) stay dense, the rest are
    OVSF; the smoke config (min_dim 32) makes k/v OVSF too."""
    from repro.configs import get_config as j_full
    from repro.models.layers import ovsf_eligible as j_elig
    from repro_torch.configs import get_config as t_full
    from repro_torch.models.layers import ovsf_eligible as t_elig
    for jc, tc in ((j_full("tinyllama_1_1b"), t_full("tinyllama_1_1b")),
                   (j_smoke("tinyllama_1_1b"), t_smoke("tinyllama_1_1b"))):
        assert t_elig(tc, name, d_in, d_out) == j_elig(jc, name, d_in, d_out)


def _step_inputs(n_slots, ps, npg, P):
    """A mixed packed step: slot 0 a 5-token chunk at 0..4, slot 1 a decode
    at position 6, slot 2 a 2-token chunk at 0..1, padding to T = 16."""
    table = np.full((n_slots + 1, npg), P, np.int32)
    table[0, :2] = [3, 0]
    table[1, :2] = [5, 1]
    table[2, :1] = [2]
    T = 16
    tokens = np.zeros(T, np.int32)
    tokens[:8] = np.random.default_rng(7).integers(1, 500, 8)
    slot_ids = np.full(T, n_slots, np.int32)
    slot_ids[:8] = [0, 0, 0, 0, 0, 1, 2, 2]
    positions = np.zeros(T, np.int32)
    positions[:8] = [0, 1, 2, 3, 4, 6, 0, 1]
    new_pos = np.array([5, 7, 2, 0], np.int32)
    emit_idx = np.array([4, 5, 7, 0], np.int32)
    return table, tokens, slot_ids, positions, new_pos, emit_idx


def test_serve_step_paged_logits_match_reference():
    jcfg, tcfg, jparams, tree = _smoke()
    n_slots, ps, npg, P = 4, 4, 4, 16
    inputs = _step_inputs(n_slots, ps, npg, P)
    rng = np.random.default_rng(11)
    shape = (tcfg.n_layers, P, ps, tcfg.n_kv_heads, tcfg.hd)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jcache = {"k": k0, "v": v0, "pos": np.zeros(n_slots, np.int32)}
    jlogits, jnew = jax.jit(functools.partial(jR.serve_step_paged,
                                              cfg=jcfg))(
        jparams, cache=jcache, page_table=inputs[0], tokens=inputs[1],
        slot_ids=inputs[2], positions=inputs[3], new_pos=inputs[4],
        emit_idx=inputs[5])
    tparams = bridge.params_from_numpy(tree, tcfg, "cpu")
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy()),
              "pos": torch.zeros(n_slots, dtype=torch.int32)}
    tlogits, tnew = tR.serve_step_paged(tparams, tcfg, tcache,
                                        *map(torch.from_numpy, inputs))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tnew[name].numpy(), np.asarray(jnew[name]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tnew["pos"].numpy(), inputs[4])


def test_serve_step_window_paged_matches_reference():
    """The (B, W) window flattened onto the paged step: slot 0 feeds 3
    tokens from position 2, slot 1 one token at 5, slot 2 nothing."""
    jcfg, tcfg, jparams, tree = _smoke()
    n_slots, ps, npg, P = 3, 4, 3, 9
    table = np.full((n_slots + 1, npg), P, np.int32)
    table[0, :2] = [4, 1]
    table[1, :2] = [0, 7]
    tokens = np.random.default_rng(3).integers(1, 500, (n_slots, 4)).astype(
        np.int32)
    n_valid = np.array([3, 1, 0], np.int32)
    pos = np.array([2, 5, 0], np.int32)
    shape = (tcfg.n_layers, P, ps, tcfg.n_kv_heads, tcfg.hd)
    k0 = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jlogits, _ = jax.jit(functools.partial(jR.serve_step_window_paged,
                                           cfg=jcfg))(
        jparams, cache={"k": k0, "v": k0 * 0.5, "pos": pos},
        page_table=table, tokens=tokens, n_valid=n_valid)
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(k0 * 0.5), "pos": torch.from_numpy(pos)}
    tlogits, tnew = tR.serve_step_window_paged(
        bridge.params_from_numpy(tree, tcfg, "cpu"), tcfg, tcache,
        torch.from_numpy(table), torch.from_numpy(tokens),
        torch.from_numpy(n_valid))
    np.testing.assert_allclose(tlogits[:2].numpy(), np.asarray(jlogits)[:2],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tnew["pos"].numpy(), pos + n_valid)


def _requests(make, n=6, max_new=6):
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=max_new) for j in range(n)]


def test_engine_greedy_streams_match_reference():
    jcfg, tcfg, jparams, tree = _smoke()
    kw = dict(batch_slots=4, buffer_len=64, chunk_size=8, packed=True,
              paged=True, page_size=8)
    jeng = JEngine(jparams, jcfg, use_mapper=False, **kw)
    teng = TEngine(bridge.params_from_numpy(tree, tcfg, "cpu"), tcfg,
                   device="cpu", **kw)
    for r in _requests(JRequest):
        jeng.submit(r)
    for r in _requests(TRequest):
        teng.submit(r)
    jeng.run_until_drained(max_steps=200)
    tstats = teng.run_until_drained(max_steps=200)
    want = {o.rid: (o.finish_reason, o.tokens) for o in jeng.outputs()}
    got = {o.rid: (o.finish_reason, o.tokens) for o in teng.outputs()}
    assert len(got) == 6 and got == want
    assert tstats.completed == 6 and tstats.tokens_out == 36
    assert tstats.kv_pages_used > 0 and tstats.padding_efficiency <= 1.0
    assert teng.core.pager.used_pages == 0      # every page came back


def test_engine_sampled_streams_are_seed_deterministic():
    """Sampled streams depend only on each request's seed: the same
    requests give the same tokens with one slot or four."""
    _jcfg, tcfg, _jp, tree = _smoke()
    params = bridge.params_from_numpy(tree, tcfg, "cpu")

    def run(slots):
        eng = TEngine(params, tcfg, batch_slots=slots, buffer_len=64,
                      chunk_size=8, packed=True, paged=True, page_size=8,
                      device="cpu")
        for r in _requests(TRequest, n=3, max_new=5):
            r.sampling = TSampling(temperature=0.8, top_k=20, seed=r.rid)
            eng.submit(r)
        eng.run_until_drained(max_steps=200)
        return {o.rid: o.tokens for o in eng.outputs()}

    assert run(1) == run(4)


def test_engine_rejects_overflow_and_requires_chunk_size():
    _jcfg, tcfg, _jp, tree = _smoke()
    params = bridge.params_from_numpy(tree, tcfg, "cpu")
    eng = TEngine(params, tcfg, batch_slots=2, buffer_len=16, chunk_size=8,
                  packed=True, paged=True, page_size=8, device="cpu")
    assert not eng.submit(TRequest(0, np.ones(10, np.int32),
                                   max_new_tokens=10))
    assert eng.outputs()[0].finish_reason == "rejected"
    # the reference's refusals: the packed step and the paged cache serve
    # prompts via chunks (without either, chunk_size=None is the legacy
    # path, tests/test_torch_legacy.py)
    with pytest.raises(ValueError, match="packed=True requires chunk_size"):
        TEngine(params, tcfg, packed=True, paged=True, device="cpu")
    with pytest.raises(ValueError, match="paged=True requires chunk_size"):
        TEngine(params, tcfg, paged=True, device="cpu")


def test_engine_needs_gpu_unless_cpu_is_asked(monkeypatch):
    _jcfg, tcfg, _jp, tree = _smoke()
    params = bridge.params_from_numpy(tree, tcfg, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(params, tcfg, chunk_size=8, packed=True, paged=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tR.model_init(tcfg, 0)


def test_launcher_serves_on_cpu(capsys):
    tserve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
                 "--paged", "--packed", "--chunk-size", "16", "--requests",
                 "3", "--max-new", "4", "--buffer", "64"])
    assert "completed=3" in capsys.readouterr().out


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.launch.serve, repro_torch.models.bridge, "
            "repro_torch.kernels.ops, repro_torch.kernels.build, "
            "repro_torch.runtime.mapper, repro_torch.hwmodel.perf_model, "
            "repro_torch.hwmodel.tile_balance, repro_torch.kernels.ovsf_gemm, "
            "repro_torch.models.cnn, repro_torch.configs.resnet18, "
            "repro_torch.configs.resnet34, repro_torch.configs.resnet50, "
            "repro_torch.configs.squeezenet1_1, repro_torch.runtime.faults, "
            "repro_torch.serving.journal, repro_torch.launch.supervise, "
            "repro_torch.serving.scheduler, repro_torch.serving.core, "
            "repro_torch.serving.engine, repro_torch.models.attention, "
            "repro_torch.models.transformer, repro_torch.models.registry, "
            "repro_torch.kernels.decode_attn, repro_torch.kernels.ref, "
            "repro_torch.configs.base, repro_torch.serving.gateway, "
            "repro_torch.serving.model_registry, "
            "repro_torch.serving.health, repro_torch.launch.gateway, "
            "repro_torch.serving.api, repro_torch.models.moe, "
            "repro_torch.configs.olmoe_1b_7b, "
            "repro_torch.configs.kimi_k2_1t_a32b, repro_torch.models.ssm, "
            "repro_torch.configs.falcon_mamba_7b, "
            "repro_torch.configs.zamba2_1_2b, "
            "repro_torch.configs.starcoder2_15b, "
            "repro_torch.configs.whisper_tiny, "
            "repro_torch.configs.llava_next_34b, "
            "repro_torch.data.synthetic, repro_torch.train.optim, "
            "repro_torch.train.compress, repro_torch.train.steps, "
            "repro_torch.runtime.supervisor, repro_torch.launch.train, "
            "repro_torch.checkpoint.ckpt, repro_torch.core.ovsf, "
            "repro_torch.models.layers; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_no_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro|ml_dtypes)"
                     r"(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    assert ROOT / "src" / "repro_torch" / "models" / "moe.py" in files
    assert ROOT / "src" / "repro_torch" / "models" / "ssm.py" in files
    assert (ROOT / "src" / "repro_torch" / "configs" /
            "zamba2_1_2b.py") in files
    for name in ("whisper_tiny.py", "llava_next_34b.py"):
        assert ROOT / "src" / "repro_torch" / "configs" / name in files
    for name in ("data/synthetic.py", "train/optim.py", "train/compress.py",
                 "train/steps.py", "runtime/supervisor.py", "launch/train.py",
                 "checkpoint/ckpt.py", "core/ovsf.py", "models/layers.py",
                 "hwmodel/tile_balance.py", "serving/scheduler.py",
                 "kernels/ovsf_gemm.py", "kernels/ops.py"):
        assert ROOT / "src" / "repro_torch" / name in files
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"
