"""The port's training slice (``repro_torch.train``, ``data.synthetic``,
``runtime.supervisor``, ``launch.train``, ``models.transformer.lm_loss``)
against the JAX package, on the CPU at smoke size.

Weights come from the reference's own init (carried over by
``models.bridge``), batches from ``TokenStream`` (bit for bit the
reference's). Tolerances: the train step's loss within 1e-5, every
gradient leaf within 1e-4 relative L2 and the updated state within 1e-4
relative L2 a leaf (fp32 sums in another order than XLA's); AdamW fed
identical gradients within 1e-6.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.data import synthetic as jdata
from repro.models import registry as jR
from repro.runtime import faults as jfaults
from repro.train import compress as jcompress
from repro.train import optim as joptim
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import OVSFConfig as TOVSF
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import ovsf_gemm as tgemm
from repro_torch.launch import train as tlaunch
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import supervisor as tsup
from repro_torch.train import compress as tcompress
from repro_torch.train import optim as toptim
from repro_torch.train import steps as tsteps

ARCH = "tinyllama_1_1b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its smoke-sized steps
    gain nothing from more, and beside the rest of the suite on several
    workers every parallel region would wait for threads that the other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(jpath) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in jpath)


def _ref_leaves(tree) -> dict:
    """{reference path: leaf} of a JAX pytree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path(p): x for p, x in flat}


def _port_leaves(tree) -> dict:
    """{reference path: numpy leaf} of a port tree, lists stacked (None
    leaves left out)."""
    out: dict = {}

    def add(path, t):
        if t is not None:
            out.setdefault(path, []).append(t.detach().float().numpy())
    toptim.tree_map(add, tree)
    return {p: (v[0] if len(v) == 1 else np.stack(v)) for p, v in
            out.items()}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / (den if den else 1.0))


def _cfgs(path="materialize", arch=ARCH, alpha_dtype=""):
    jc, tc = j_smoke(arch), t_smoke(arch)
    if jc.ovsf.enable:
        kw = dict(exec_path=path, alpha_dtype=alpha_dtype)
        jc = jc.replace(ovsf=dataclasses.replace(jc.ovsf, **kw))
        tc = tc.replace(ovsf=dataclasses.replace(tc.ovsf, **kw))
    return jc, tc


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("seed,hosts", [(0, 1), (3, 1), (7, 2)])
def test_token_stream_is_the_reference_stream(seed, hosts):
    for host in range(hosts):
        j = jdata.TokenStream(512, 33, 8, seed=seed, n_hosts=hosts,
                              host_id=host)
        t = tdata.TokenStream(512, 33, 8, seed=seed, n_hosts=hosts,
                              host_id=host)
        for step in (0, 1, 17, 1000):
            a, b = j.batch_at(step)["tokens"], t.batch_at(step)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        it = iter(tdata.Prefetcher(iter(t), depth=2))
        np.testing.assert_array_equal(next(it)["tokens"],
                                      j.batch_at(0)["tokens"])
        np.testing.assert_array_equal(next(it)["tokens"],
                                      j.batch_at(1)["tokens"])


def test_pack_documents_matches_reference():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 50, n).astype(np.int32)
            for n in (3, 9, 2, 16, 7, 1, 20)]
    for seq in (8, 16):
        np.testing.assert_array_equal(tdata.pack_documents(docs, seq),
                                      jdata.pack_documents(docs, seq))
    assert tdata.pack_documents([], 4).shape == (0, 4)


# -- optimizer -------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(schedule):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule)
    jc, tc = joptim.OptConfig(**kw), toptim.OptConfig(**kw)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        got = toptim.lr_at(tc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(joptim.lr_at(jc, jnp.int32(s))),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", [ARCH, "falcon_mamba_7b", "whisper_tiny",
                                  "olmoe_1b_7b", "zamba2_1_2b",
                                  "llava_next_34b"])
def test_decay_mask_decides_every_leaf_as_the_reference(arch):
    """Leaf by leaf over the smoke params: the port's paths (lists left
    out) and decisions are the reference's (its "/b" test also catches
    "encoder/blocks", copied as it is)."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    jp = jR.model_init(jax.random.PRNGKey(0), jc)
    want = {p: joptim._decay_mask(jp_path) for jp_path, p in (
        (path, _path(path)) for path, _x in
        jax.tree_util.tree_flatten_with_path(jp)[0])}
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  tc, "cpu")
    got = {}
    toptim.tree_map(lambda p, _t: got.__setitem__(p, toptim._decay_mask(p)),
                    tp)
    assert got == want
    assert True in got.values() and False in got.values()


def _state(path="materialize"):
    jc, tc = _cfgs(path)
    jstate = jsteps.train_state_init(jax.random.PRNGKey(0), jc)
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    return jc, tc, jstate, bridge.state_from_numpy(tree, tc, "cpu")


def test_train_state_layout_matches_reference():
    _jc, tc, jstate, tstate = _state()
    want = {p: x.shape for p, x in _ref_leaves(jstate).items()}
    got = {p: x.shape for p, x in _port_leaves(tstate).items()}
    assert got == want
    # fp32 m and v for every leaf, the int code ids' included
    for name in ("m", "v"):
        assert {t.dtype for t in toptim.tree_leaves(tstate["opt"][name])} \
            == {torch.float32}
    back = bridge.state_to_numpy(tstate)
    for p, x in _ref_leaves(back).items():
        np.testing.assert_array_equal(x, np.asarray(_ref_leaves(jstate)[p]))
    native = tsteps.train_state_init(tc, 0, "cpu")
    assert {p: x.shape for p, x in _port_leaves(native).items()} == want
    assert native["opt"]["step"].dtype == torch.int32


def test_global_norm_and_adamw_update_match_reference():
    """Three updates fed identical gradients (int leaves: none), within
    1e-6, and the params' types kept."""
    _jc, _tc, jstate, tstate = _state()
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jo, to = joptim.OptConfig(**kw), toptim.OptConfig(**kw)
    rng = np.random.default_rng(0)
    jparams, jopt = jstate["params"], jstate["opt"]
    tparams, topt = tstate["params"], tstate["opt"]
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape).astype(np.float32)
                       if jnp.issubdtype(p.dtype, jnp.floating)
                       else np.zeros(p.shape, jax.dtypes.float0)), jparams)
        tg = bridge.params_from_numpy(
            jax.tree_util.tree_map(
                lambda a: a if a.dtype != jax.dtypes.float0
                else np.zeros(a.shape, np.int32), g), _tc, "cpu")
        tg = toptim.tree_map(lambda _p, t: t if t.is_floating_point()
                             else None, tg)
        np.testing.assert_allclose(float(toptim.global_norm(tg)),
                                   float(joptim.global_norm(g)), rtol=1e-6)
        jparams, jopt, jm = joptim.adamw_update(jo, g, jopt, jparams)
        tparams, topt, tm = toptim.adamw_update(to, tg, topt, tparams)
        for k in ("lr", "grad_norm", "step"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    for name, jt, tt in (("params", jparams, tparams),
                         ("m", jopt["m"], topt["m"]),
                         ("v", jopt["v"], topt["v"])):
        want, got = _ref_leaves(jt), _port_leaves(tt)
        assert got.keys() == want.keys()
        for p in want:
            np.testing.assert_allclose(got[p], np.asarray(want[p]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {p}")
    assert {t.dtype for t in toptim.tree_leaves(tparams)} == \
        {torch.float32, torch.int32}


def test_adamw_converges_and_skips_int_leaves():
    cfg = toptim.OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                           weight_decay=0.0, schedule="constant")
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3), "idx": torch.arange(4, dtype=torch.int32)}
    opt = toptim.adamw_init(params)
    for _ in range(150):
        g = {"w": 2 * (params["w"] - target), "idx": None}
        params, opt, _m = toptim.adamw_update(cfg, g, opt, params)
    torch.testing.assert_close(params["w"], target, atol=0.05, rtol=0)
    assert torch.equal(params["idx"], torch.arange(4, dtype=torch.int32))


# -- compression -----------------------------------------------------------------

def test_quantize_matches_reference():
    g = np.random.default_rng(0).standard_normal(257).astype(np.float32)
    jq, js = jcompress.quantize(jnp.asarray(g))
    tq, ts = tcompress.quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    np.testing.assert_allclose(tcompress.dequantize(tq, ts).numpy(),
                               np.asarray(jcompress.dequantize(jq, js)),
                               rtol=1e-7)


def test_compress_with_feedback_matches_reference():
    rng = np.random.default_rng(1)
    g = {"w": (rng.standard_normal((8, 4)) * 1e-3).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jerr, terr = jcompress.ef_init(g), tcompress.ef_init(tg)
    jacc = tacc = 0
    for _ in range(5):
        jq, js, jerr, jr = jcompress.compress_with_feedback(g, jerr)
        tq, ts, terr, tr = tcompress.compress_with_feedback(tg, terr)
        for k in g:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_allclose(terr[k].numpy(), np.asarray(jerr[k]),
                                       rtol=1e-6, atol=1e-9)
        jacc = jacc + jcompress.decompress(jq, js)["w"]
        tacc = tacc + tcompress.decompress(tq, ts)["w"]
        assert tr == pytest.approx(float(jr))
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-6)
    # an int leaf (or a leaf without a gradient) passes through
    q, s, e, _r = tcompress.compress_with_feedback(
        {"idx": torch.arange(3, dtype=torch.int32), "w": None},
        {"idx": torch.zeros(()), "w": torch.zeros(())})
    assert torch.equal(q["idx"], torch.arange(3, dtype=torch.int32))
    assert q["w"] is None


# -- the train step --------------------------------------------------------------

@pytest.mark.parametrize("path", ["materialize", "fused"])
def test_train_step_matches_reference(path):
    """One step of the smoke TinyLlama: the loss (1e-5), every gradient
    leaf (1e-4 relative L2), the metrics and the updated params and
    optimizer state (1e-4 relative L2 a leaf) against the reference's
    ``make_train_step`` under ``jax.jit``."""
    jc, tc, jstate, tstate = _state(path)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    batch = tdata.TokenStream(tc.vocab, 24, 3, seed=4).batch_at(2)

    @jax.jit
    def ref(state, b):
        (loss, _m), g = jax.value_and_grad(
            lambda p: jR.loss_fn(p, jc, b), has_aux=True,
            allow_int=True)(state["params"])
        new, metrics = jsteps.make_train_step(jc, joptim.OptConfig(**kw))(
            state, b)
        return loss, g, new, metrics
    jloss, jg, jnew, jm = ref(jstate, batch)

    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    loss, aux, grads = tsteps.loss_and_grads(tc, tstate["params"], tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(aux["aux"]) == 0.0
    want = {p: g for p, g in _ref_leaves(jg).items()
            if g.dtype != jax.dtypes.float0}
    got = _port_leaves(grads)
    assert got.keys() == want.keys()
    for p in want:
        assert _rel(got[p], want[p]) <= 1e-4, (p, _rel(got[p], want[p]))

    step = tsteps.make_train_step(tc, toptim.OptConfig(**kw))
    tnew, tm = step(tstate, batch)
    for k in ("total_loss", "loss", "lr", "grad_norm", "step"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    want, got = _ref_leaves(jnew), _port_leaves(tnew)
    assert got.keys() == want.keys()
    for p in want:
        assert _rel(got[p], want[p]) <= 1e-4, (p, _rel(got[p], want[p]))


def _count_gemms(monkeypatch) -> list:
    calls = []
    real = tgemm.ovsf_gemm_plain

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(tgemm, "ovsf_gemm_plain", counted)
    return calls


def test_remat_recomputes_each_block_with_the_same_gradients(monkeypatch):
    """Under ``remat`` every block's forward runs again in the backward
    (``ovsf_gemm`` twice a projection), the segmented backward calls no
    ``ovsf_gemm``, and the gradients are the same bit for bit."""
    _jc, tc, _js, tstate = _state("fused")
    tb = {"tokens": torch.from_numpy(
        tdata.TokenStream(tc.vocab, 16, 2, seed=1).batch_at(0)["tokens"])}
    calls = _count_gemms(monkeypatch)
    n_ovsf = sum("idx" in lin for blk in tstate["params"]["blocks"]
                 for grp in ("attn", "mlp") for lin in blk[grp].values())
    out = {}
    for remat in (False, True):
        calls.clear()
        out[remat] = tsteps.loss_and_grads(tc.replace(remat=remat),
                                           tstate["params"], tb)
        assert len(calls) == n_ovsf * (2 if remat else 1)
    assert n_ovsf == 2 * 7
    a, b = _port_leaves(out[False][2]), _port_leaves(out[True][2])
    for p in a:
        np.testing.assert_array_equal(a[p], b[p])
    assert float(out[False][0]) == float(out[True][0])


def test_train_refuses_what_is_not_ported():
    """A missing card is refused; every family builds its train step and
    state (the MoE and hybrid cases were refusals before the other
    families trained), and so do int8 alphas (a refusal before training
    with quantised alphas was ported): their scales are float leaves with
    AdamW moments, the integers stay integers."""
    assert callable(tsteps.make_train_step(t_smoke("olmoe_1b_7b"),
                                           toptim.OptConfig()))
    st = tsteps.train_state_init(t_smoke("zamba2_1_2b"), 0, "cpu")
    assert "shared_attn" in st["params"] and "shared_attn" in st["opt"]["m"]
    q = t_smoke(ARCH)
    q = q.replace(ovsf=dataclasses.replace(q.ovsf, alpha_dtype="int8"))
    assert callable(tsteps.make_train_step(q, toptim.OptConfig()))
    qs = tsteps.train_state_init(q, 0, "cpu")
    lin = qs["params"]["blocks"][0]["attn"]["q"]
    assert lin["alphas_q8"].dtype == torch.int8
    assert lin["alpha_scale"].dtype == torch.float32
    assert qs["opt"]["m"]["blocks"][0]["attn"]["q"]["alpha_scale"].shape \
        == lin["alpha_scale"].shape
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            tsteps.train_state_init(t_smoke(ARCH))
        else:
            raise RuntimeError("no CUDA device")


def test_forward_eval_prefill_and_decode_steps_match_reference():
    jc, tc, jstate, tstate = _state("fused")
    batch = tdata.TokenStream(tc.vocab, 12, 2, seed=2).batch_at(0)
    jlg0, _c, jaux = jR.forward(jstate["params"], jc, batch)
    tlg0, tcache, taux = tR.forward(tstate["params"], tc,
                                    {"tokens": torch.from_numpy(
                                        batch["tokens"])})
    assert tcache is None and float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(tlg0.detach().numpy(), np.asarray(jlg0),
                               rtol=1e-4, atol=1e-4)
    jl = jsteps.make_eval_step(jc)(jstate["params"], batch)
    tl = tsteps.make_eval_step(tc)(tstate["params"], batch)
    np.testing.assert_allclose(float(tl["total_loss"]),
                               float(jl["total_loss"]), rtol=1e-5)
    jlg, jcache = jsteps.make_prefill(jc, 16)(jstate["params"], batch)
    tlg, tcache = tsteps.make_prefill(tc, 16)(tstate["params"], batch)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=1e-4,
                               atol=1e-4)
    tok = np.array([[3], [5]], np.int32)
    jlg2, _ = jsteps.make_decode_step(jc)(jstate["params"], jcache, tok)
    tlg2, _ = tsteps.make_decode_step(tc)(tstate["params"], tcache, tok)
    np.testing.assert_allclose(tlg2.numpy(), np.asarray(jlg2), rtol=1e-4,
                               atol=1e-4)


# -- supervisor ------------------------------------------------------------------

def _system_cfg():
    return t_smoke(ARCH).replace(ovsf=TOVSF(enable=True, rho=0.5, min_dim=32,
                                            exec_path="spectral"))


def test_train_loss_decreases_and_recovers_from_failure(tmp_path):
    """``tests/test_system.py``'s end-to-end case on the port: train, fail
    at step 12, restore and replay, then serve the trained params."""
    cfg = _system_cfg()
    state = tsteps.train_state_init(cfg, 0, "cpu")
    step = tsteps.make_train_step(cfg, toptim.OptConfig(
        lr=5e-3, warmup_steps=2, total_steps=40))
    stream = tdata.TokenStream(cfg.vocab, 32, 4, seed=3)
    boom = {"armed": True}

    def injector(s):
        if s == 12 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected failure")

    scfg = tsup.SupervisorConfig(ckpt_dir=str(tmp_path), save_every=5,
                                 log_every=1000)
    state, rep = tsup.run(step, state, stream.batch_at, 20, scfg,
                          failure_injector=injector, log=lambda *_: None)
    assert rep.failures == 1 and rep.restores >= 1
    assert rep.steps_run >= 20
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5])
    assert len(rep.save_write_s) == len(rep.save_snapshot_s) == 4
    lg, cache = tR.serve_prefill(state["params"], cfg,
                                 torch.zeros((1, 8), dtype=torch.int32), 16)
    lg, cache = tR.serve_step(state["params"], cfg, cache,
                              torch.zeros((1, 1), dtype=torch.int32))
    assert torch.isfinite(lg).all()


def test_replayed_steps_equal_the_first_pass_bit_for_bit(tmp_path):
    """A ``FaultPlan`` ``fail`` between two checkpoints: the supervisor
    restores the earlier one and replays; every replayed loss and the final
    state equal an uninterrupted run's bit for bit."""
    cfg = _system_cfg()
    ocfg = toptim.OptConfig(lr=5e-3, warmup_steps=2, total_steps=20)
    stream = tdata.TokenStream(cfg.vocab, 16, 2, seed=5)
    runs = {}
    for name, plan in (("clean", None),
                       ("fault", tfaults.FaultPlan.parse(["fail:step=7"]))):
        state = tsteps.train_state_init(cfg, 0, "cpu")
        runs[name] = tsup.run(
            tsteps.make_train_step(cfg, ocfg), state, stream.batch_at, 10,
            tsup.SupervisorConfig(ckpt_dir=str(tmp_path / name),
                                  save_every=4, log_every=1000),
            faults=plan, log=lambda *_: None)
    (cs, crep), (fs, frep) = runs["clean"], runs["fault"]
    assert frep.failures == 1 and frep.restores == 1
    # steps 0-6, then 4-9 again from the step-4 checkpoint
    assert frep.losses == crep.losses[:7] + crep.losses[4:]
    a, b = _port_leaves(cs), _port_leaves(fs)
    for p in a:
        np.testing.assert_array_equal(a[p], b[p])


def test_failure_injector_matches_reference():
    specs = ["fail:step=3", "fail:step=5,every=4", "nan:step=2",
             "delay:step=4,s=0.001", "die:step=1", "fail:p=0.2",
             "flip:step=2,leaf=0,bit=1"]
    fired = {}
    for name, mod in (("j", jfaults), ("t", tfaults)):
        inj = mod.FaultPlan.parse(specs, seed=11).failure_injector()
        out = []
        for s in [0, 1, 2, 3, 3, 4, 5, 5, 6, 9, 9, 13, 13, 20]:
            try:
                inj(s)
                out.append((s, "ok"))
            except RuntimeError as e:
                out.append((s, type(e).__name__))
        fired[name] = out
    assert fired["t"] == fired["j"]
    assert ("InjectedFault" in {r for _s, r in fired["t"]})


def test_supervisor_default_ckpt_dir_is_the_ports_own(monkeypatch,
                                                       tmp_path):
    """A run of either package never resumes from the other's checkpoints
    by default: the port's directory is under the run's temporary
    directory, as the launcher's, and not the reference's."""
    from repro.runtime import supervisor as jsup
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = tsup.SupervisorConfig().ckpt_dir
    assert got == str(tmp_path / "repro_torch_ckpt")
    assert got != jsup.SupervisorConfig().ckpt_dir


# -- launcher --------------------------------------------------------------------

def test_launcher_trains_on_cpu(tmp_path, capsys):
    state, rep = tlaunch.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6",
        "--batch", "2", "--seq", "16", "--save-every", "3", "--ckpt",
        str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "[train] params:" in out and "[train] done: steps=6" in out
    assert "first loss=" in out and "last loss=" in out
    assert rep.steps_run == 6 and len(rep.losses) == 6
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000003", "step_00000006"]
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--data-par", "2"])
