"""The port's calibration loop vs the JAX package: ``CalibrationTable``
(factors, JSON, save/load), ``attribute_step`` / ``update_from_step``,
calibrated ``classify_gemm`` / ``plan_model``, the engine's samples and
``replan()`` on the CPU, and ``launch.serve --calibrate``. Plans must be
equal (modeled II within 1e-12 relative), factors within 1e-12 relative.
"""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.models import registry as jR
from repro.runtime import calibrate as jcal
from repro.runtime import mapper as jmapper
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models import bridge
from repro_torch.runtime import calibrate as tcal
from repro_torch.runtime import mapper as tmapper
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest

REF_TARGETS = ["v5e", "v5p", "v6e", "cpu"]
ADTS = ["", "int8", "int4"]
RTOL = 1e-12
STYLES = {"paged packed": dict(paged=True, packed=True, page_size=8),
          "paged window": dict(paged=True, page_size=8),
          "contiguous packed": dict(packed=True),
          "contiguous window": dict()}


def _same_plan(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    gi, wi = g.pop("ii_s"), w.pop("ii_s")
    assert g == w
    assert abs(gi - wi) <= RTOL * abs(wi)


def _same_exec_plan(got, want):
    assert got.hw_label == want.hw_label
    assert got.names() == want.names()
    for (_n, g), (_m, w) in zip(got.entries, want.entries):
        _same_plan(g, w)


def _same_factors(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= RTOL * want[k], k


def _with_alphas(cfg, alpha_dtype):
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf,
                                                alpha_dtype=alpha_dtype))


def _tables(records):
    """The same records in a port and a reference table."""
    t, j = tcal.CalibrationTable(), jcal.CalibrationTable()
    for r in records:
        t.record(*r)
        j.record(*r)
    return t, j


def _random_records(seed, names, paths, hws, n=60):
    rng = np.random.default_rng(seed)
    return [(str(rng.choice(names)), str(rng.choice(paths)),
             str(rng.choice(hws)), float(rng.lognormal(3.0, 1.0)),
             float(rng.lognormal(-9.0, 2.0))) for _ in range(n)]


# -- the table -----------------------------------------------------------------

@pytest.mark.parametrize("mod", [tcal, jcal], ids=["port", "reference"])
def test_calibration_table_relative_factors(mod):
    """The reference's cases: a uniform model error normalises to 1.0, one
    deviating layer is penalised and the rest credited, an unmeasured key
    keeps 1.0, and factors survive a JSON round trip."""
    t = mod.CalibrationTable()
    for n in ("a", "b", "c"):
        t.record(n, "fused", "v5e", 100.0, 1.0)
    for n in ("a", "b", "c"):
        assert t.factor(n, "fused", "v5e") == pytest.approx(1.0)
    t2 = mod.CalibrationTable()
    t2.record("a", "fused", "v5e", 10.0, 1.0)
    t2.record("b", "fused", "v5e", 1.0, 1.0)
    assert t2.factor("a", "fused", "v5e") > 1.0 > t2.factor("b", "fused",
                                                            "v5e")
    assert t2.factor("unseen", "fused", "v5e") == 1.0
    t3 = mod.CalibrationTable.from_json(t2.to_json())
    assert t3.factor("a", "fused", "v5e") == pytest.approx(
        t2.factor("a", "fused", "v5e"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_factors_match_reference(seed):
    recs = _random_records(seed, ["mlp_up", "attn_q", "s1b0c2", "f2e3"],
                           ["materialize", "fused", "spectral"],
                           ["v5e", "cpu", "h100"])
    recs += [("x", "fused", "cpu", 0.0, 1.0), ("x", "fused", "cpu", 1.0, -1)]
    t, j = _tables(recs)
    assert len(t) == len(j) and t.to_json() == j.to_json()
    for hw in ("v5e", "cpu", "h100", "v6e"):
        _same_factors(t.factors(hw), j.factors(hw))
        for name, path, *_ in recs:
            assert t.raw_ratio(name, path, hw) == j.raw_ratio(name, path, hw)
            tf, jf = t.factor(name, path, hw), j.factor(name, path, hw)
            assert abs(tf - jf) <= RTOL * jf
    assert t.factor("x", "fused", "cpu") == 1.0     # both samples dropped


def test_json_and_save_load_round_trip(tmp_path):
    t, j = _tables(_random_records(3, ["a", "b"], ["fused", "spectral"],
                                   ["h100", "cpu"]))
    back = tcal.CalibrationTable.from_json(json.loads(json.dumps(t.to_json())))
    assert back.to_json() == t.to_json()
    path = tmp_path / "table.json"
    t.save(str(path))
    assert not (tmp_path / "table.json.tmp").exists()
    loaded = tcal.CalibrationTable.load(str(path))
    assert loaded.to_json() == t.to_json()
    _same_factors(loaded.factors("h100"), j.factors("h100"))
    # the reference loads the port's file, and the port the reference's
    assert jcal.CalibrationTable.load(str(path)).to_json() == j.to_json()
    j.save(str(tmp_path / "ref.json"))
    assert tcal.CalibrationTable.load(
        str(tmp_path / "ref.json")).to_json() == t.to_json()


def test_atomic_write_json_replaces_whole_file(tmp_path):
    path = tmp_path / "f.json"
    ckpt.atomic_write_json(str(path), {"a": 1})
    ckpt.atomic_write_json(str(path), {"b": [1, 2]}, indent=2)
    assert json.loads(path.read_text()) == {"b": [1, 2]}
    assert [p.name for p in tmp_path.iterdir()] == ["f.json"]
    ckpt.fsync_dir(str(tmp_path))


# -- attribution ----------------------------------------------------------------

@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("hw", REF_TARGETS)
def test_attribute_and_update_match_reference(hw, alpha_dtype):
    tc = _with_alphas(t_smoke("tinyllama_1_1b"), alpha_dtype)
    jc = _with_alphas(j_smoke("tinyllama_1_1b"), alpha_dtype)
    tplan = tmapper.plan_model(tc, TShape("d", 1, 4, "decode"), hw=hw,
                               weight_reuse=1)
    jplan = jmapper.plan_model(jc, JShape("d", 1, 4, "decode"), hw=hw,
                               weight_reuse=1)
    for wall in (1.0, 0.0123, 0.0):
        got = tcal.attribute_step(tplan, wall)
        want = jcal.attribute_step(jplan, wall)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            assert abs(g[2] - w[2]) <= RTOL * w[2]
            assert abs(g[3] - w[3]) <= RTOL * w[3]
        if wall:
            assert abs(sum(g[2] for g in got) - wall) <= 1e-9 * wall
    t, j = tcal.CalibrationTable(), jcal.CalibrationTable()
    for wall in (0.5, 0.02, 0.0):
        assert tcal.update_from_step(t, tplan, wall, hw) == \
            jcal.update_from_step(j, jplan, wall, hw)
    assert len(t) == len(j) == len(tplan.entries)
    _same_factors(t.factors(hw), j.factors(hw))
    assert all(abs(f - 1.0) <= 1e-9 for f in t.factors(hw).values())
    assert tcal.attribute_step(None, 1.0) == []


# -- calibrated planning ------------------------------------------------------

def _skewed(hw, names):
    """Records that push ``fused`` up and ``materialize`` down on some
    names, ``spectral`` down on others, around a uniform baseline."""
    recs = []
    for i, n in enumerate(names):
        for path in tmapper.ALL_PATHS:
            skew = {0: {"fused": 50.0, "materialize": 0.02},
                    1: {"spectral": 0.01}, 2: {}}[i % 3].get(path, 1.0)
            recs.append((n, path, hw, 3.0 * skew, 1e-6))
    return recs


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("seg", [0, 16])
@pytest.mark.parametrize("hw", REF_TARGETS + ["h100"])
def test_classify_gemm_with_table_matches_reference(hw, seg, alpha_dtype):
    names = ["mlp_up", "attn_q", "mlp_down"]
    t, j = _tables(_skewed(hw, names))
    jhw = hw if hw != "h100" else jmapper.pm.HW(
        **dataclasses.asdict(tmapper.pm.H100))
    changed = 0
    for M in (1, 4, 128, 2048):
        for d_in, d_out in ((2048, 2048), (2048, 5632), (1152, 128)):
            for rho in (0.25, 0.5):
                for name in names:
                    for paths in (tmapper.DEFAULT_PATHS, tmapper.ALL_PATHS):
                        kw = dict(seg=seg, name=name, weight_reuse=256,
                                  paths=paths, alpha_dtype=alpha_dtype)
                        got = tmapper.classify_gemm(
                            M, d_in, d_out, rho, hw=hw, calibration=t, **kw)
                        _same_plan(got, jmapper.classify_gemm(
                            M, d_in, d_out, rho, hw=jhw, calibration=j, **kw))
                        free = tmapper.classify_gemm(M, d_in, d_out, rho,
                                                     hw=hw, **kw)
                        changed += got.path != free.path
    assert changed                          # the skew re-maps some layers


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("hw", REF_TARGETS)
def test_plan_model_with_table_matches_reference(hw, full, alpha_dtype):
    tc = _with_alphas((t_full if full else t_smoke)("tinyllama_1_1b"),
                      alpha_dtype)
    jc = _with_alphas((j_full if full else j_smoke)("tinyllama_1_1b"),
                      alpha_dtype)
    t, j = _tables(_skewed(hw, ["attn_q", "attn_o", "mlp_gate", "mlp_up",
                                "mlp_down", "attn_k", "attn_v"]))
    for batch in (1, 4, 1024):
        for paths in (tmapper.DEFAULT_PATHS, tmapper.ALL_PATHS):
            kw = dict(hw=hw, weight_reuse=1, paths=paths)
            _same_exec_plan(
                tmapper.plan_model(tc, TShape("d", 1, batch, "decode"),
                                   calibration=t, **kw),
                jmapper.plan_model(jc, JShape("d", 1, batch, "decode"),
                                   calibration=j, **kw))


def test_empty_table_leaves_plans_unchanged():
    cfg = t_full("tinyllama_1_1b")
    shape = TShape("d", 1, 4, "decode")
    for hw in ("cpu", "h100"):
        _same_exec_plan(
            tmapper.plan_model(cfg, shape, hw=hw,
                               calibration=tcal.CalibrationTable()),
            tmapper.plan_model(cfg, shape, hw=hw))


# -- the engine's loop -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _smoke(alpha_dtype=""):
    jcfg = _with_alphas(j_smoke("tinyllama_1_1b"), alpha_dtype)
    tcfg = _with_alphas(t_smoke("tinyllama_1_1b"), alpha_dtype)
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


def _requests(make):
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=6) for j in range(5)]


def _engines(style, alpha_dtype=""):
    """The reference's and the port's engines, calibrating, after the same
    requests; the port's ``chunk_free`` counts its steps without chunks."""
    jcfg, tcfg, jparams, tparams = _smoke(alpha_dtype)
    kw = dict(batch_slots=4, buffer_len=64, chunk_size=8, calibrate=True,
              **STYLES[style])
    jeng = JEngine(jparams, jcfg, hw="cpu", **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    teng.chunk_free = 0
    core_step = teng.core.step

    def counting_step(so, last=None):
        teng.chunk_free += bool(so.decode_slots and not so.chunks)
        return core_step(so, last)

    teng.core.step = counting_step
    for eng, make in ((jeng, JRequest), (teng, TRequest)):
        for r in _requests(make):
            eng.submit(r)
        eng.run_until_drained(max_steps=300)
    return jeng, teng


def _samples(table) -> dict:
    return {k: v["n"] for k, v in table.to_json().items()}


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("style", list(STYLES))
def test_engine_samples_and_replan_match_reference(style, alpha_dtype):
    """One sample per plan entry per chunk-free step, as the reference
    engine records on the same requests; uniform factors; ``replan()``
    equal to the engine's plan and to the reference's."""
    jeng, teng = _engines(style, alpha_dtype)
    assert teng.hw_label == jeng.hw_label == "cpu"
    got = _samples(teng.calibration)
    assert got == _samples(jeng.calibration)
    plan = teng.cfg.exec_plan
    assert len(got) == len(plan.entries)
    assert 0 < teng.chunk_free < teng.stats.steps
    assert set(got.values()) == {teng.chunk_free}
    assert all(abs(f - 1.0) <= 1e-9
               for f in teng.calibration.factors("cpu").values())
    _same_exec_plan(teng.replan(), plan)
    _same_exec_plan(teng.replan(), jeng.replan())


def test_calibration_skew_changes_engine_replan():
    """The reference's acceptance test on the port, side by side: the
    measured factors keep every layer on its path, and a large injected
    skew on one executed ``fused`` entry re-maps that entry, to the same
    plan the reference engine re-maps to."""
    jeng, teng = _engines("paged packed")
    base = teng.cfg.exec_plan
    assert [lp.path for _n, lp in teng.replan().entries] == \
        [lp.path for _n, lp in base.entries]
    name, lp = next((n, lp) for n, lp in base.entries if lp.path == "fused")
    for eng in (teng, jeng):
        r = eng.calibration.raw_ratio(name, lp.path, "cpu") or 1.0
        for _ in range(200):
            eng.calibration.record(name, lp.path, "cpu",
                                   100.0 * r * lp.ii_s, lp.ii_s)
    corrected = teng.replan()
    changed = [(n, a.path, b.path) for (n, a), (_n, b)
               in zip(base.entries, corrected.entries) if a.path != b.path]
    assert changed and changed[0][0] == name
    assert changed[0][1] == "fused" and changed[0][2] != "fused"
    _same_exec_plan(corrected, jeng.replan())
    assert teng.cfg.exec_plan is base              # replan swaps nothing in


def test_engine_without_calibrate_records_nothing():
    _jcfg, tcfg, _jp, tparams = _smoke()
    eng = TEngine(tparams, tcfg, batch_slots=4, buffer_len=64, chunk_size=8,
                  device="cpu")
    for r in _requests(TRequest):
        eng.submit(r)
    eng.run_until_drained(max_steps=300)
    assert len(eng.calibration) == 0 and eng.stats.decode_s > 0
    _same_exec_plan(eng.replan(), eng.cfg.exec_plan)


# -- the launcher ---------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--paged", "--packed"], []])
def test_launcher_calibrate_on_cpu(flags, tmp_path, capsys):
    out_file = tmp_path / "cal.json"
    tserve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
                 "--chunk-size", "16", "--requests", "3", "--max-new", "5",
                 "--buffer", "64", "--calibrate", "--calibration-out",
                 str(out_file), *flags])
    out = capsys.readouterr().out
    assert "completed=3" in out
    assert "[serve] calibrate: 7 keys, relative factors: " in out
    assert "keep every layer on its modeled path" in out
    assert f"[serve] calibrate: table -> {out_file}" in out
    table = tcal.CalibrationTable.load(str(out_file))
    assert len(table) == 7
    assert all(abs(f - 1.0) <= 1e-9 for f in table.factors("cpu").values())
