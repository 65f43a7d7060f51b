"""The port's write-ahead request journal (``serving.journal``) and the
supervised launcher, on the CPU:

* the journal's mechanics as ``tests/test_durability.py`` holds the
  reference's: round trip, admission idempotent by rid, torn tail, CRC
  corruption, rotation and compaction, degrade on an I/O error;
* the format is the reference's: a journal the port writes replays in
  ``repro.serving.journal.RequestJournal`` to the same entries, and the
  other way round; ``key_after`` (a numpy threefry2x32) equals the
  reference's for seeds 0..20 and n 0..12; ``body_fingerprint`` equals it;
* crash recovery is token-identical to the port's fault-free run, greedy
  and sampled, contiguous and paged, window and packed; a request that
  finished before the crash is not re-run; a deadline that passed while
  the process was down finishes it ``timeout`` once;
* ``python -m repro_torch.launch.serve --device cpu --smoke ... --journal
  DIR --supervise --inject die:step=3`` (the CI kill-9 line) exits 0 with
  every request finished once, streams equal to the same run without the
  kill.
"""
import dataclasses
import functools
import glob
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSampling
from repro.serving import journal as jj
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import registry as tR
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SamplingParams as TSampling
from repro_torch.serving import journal as tj

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its smoke-sized steps
    gain nothing from more, and beside the rest of the suite on several
    workers every parallel region would wait for threads that the other
    workers hold (the module ran 15-100x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _req(rid, plen, max_new=6, make=TRequest, **kw):
    rng = np.random.default_rng(rid)
    return make(rid, rng.integers(0, 512, plen, dtype=np.int32),
                max_new_tokens=max_new, **kw)


# -- mechanics ---------------------------------------------------------------

def test_journal_roundtrip_replay(tmp_path):
    d = str(tmp_path / "j")
    j = tj.RequestJournal(d)
    j.admit_request(_req(0, 4, sampling=TSampling(temperature=0.7, top_k=5,
                                                  seed=9)))
    j.admit_request(_req(1, 3))
    j.tokens(0, (17, 23))
    j.tokens(1, (5,))
    j.finish(1, "eos")
    j.tokens(0, (42,))
    before = j.appended
    j.admit_request(_req(0, 4))         # re-admission journals nothing
    assert j.appended == before
    j.close()

    j2 = tj.RequestJournal(d)
    e0, e1 = j2.entries[0], j2.entries[1]
    assert e0.tokens == [17, 23, 42] and not e0.done
    assert (e0.temperature, e0.top_k, e0.seed) == (0.7, 5, 9)
    assert e1.tokens == [5] and e1.finish_reason == "eos"
    assert [e.rid for e in j2.live_entries()] == [0]
    assert [e.rid for e in j2.finished_entries()] == [1]
    assert j2.max_rid == 1


def test_torn_tail_and_crc_corruption(tmp_path):
    d = str(tmp_path / "torn")
    j = tj.RequestJournal(d)
    j.admit_request(_req(0, 4))
    j.tokens(0, (7,))
    j.close()
    seg = sorted(glob.glob(os.path.join(d, "seg_*.wal")))[0]
    with open(seg, "ab") as f:
        f.write(b"\x99\x03")            # a crash mid-append
    assert tj.RequestJournal(d).entries[0].tokens == [7]

    d = str(tmp_path / "crc")
    j = tj.RequestJournal(d)
    j.admit_request(_req(0, 4))
    j.flush()
    j.admit_request(_req(1, 4))
    j.close()
    seg = sorted(glob.glob(os.path.join(d, "seg_*.wal")))[0]
    raw = bytearray(open(seg, "rb").read())
    raw[-1] ^= 0xFF                     # bit rot in the last record
    open(seg, "wb").write(bytes(raw))
    assert sorted(tj.RequestJournal(d).entries) == [0]


def test_rotation_compacts_and_keep_finished_false_drops(tmp_path):
    d = str(tmp_path)
    j = tj.RequestJournal(d, segment_bytes=256)
    j.admit_request(_req(0, 4))
    j.admit_request(_req(1, 4))
    for i in range(40):
        j.tokens(0, (i,))
        j.flush()
    j.finish(1, "eos")
    assert len(glob.glob(os.path.join(d, "seg_*.wal"))) == 1
    j.close()
    j2 = tj.RequestJournal(d)
    assert j2.entries[0].tokens == list(range(40)) and j2.entries[1].done
    j2.compact(keep_finished=False)
    j2.close()
    assert sorted(tj.RequestJournal(d).entries) == [0]


def test_journal_io_failure_degrades_non_durable(tmp_path):
    j = tj.RequestJournal(str(tmp_path))
    j.admit_request(_req(0, 4))
    j.flush()
    os.close(j._fh.fileno())            # the volume goes away
    j.tokens(0, (1,))
    with pytest.warns(RuntimeWarning, match="NON-DURABLE"):
        j.flush()
    assert j.broken
    j.tokens(0, (2,))                   # every later call a no-op
    j.finish(0, "eos")
    j.flush()
    j.compact()
    j.close()


# -- the reference's format and keys -----------------------------------------

def _write(journal_mod, make, sampling, d):
    j = journal_mod.RequestJournal(d)
    j.admit_request(make(0, np.arange(5, dtype=np.int32), max_new_tokens=8,
                         sampling=sampling(temperature=0.9, top_k=4, seed=13),
                         priority=2, deadline_s=30.0,
                         idempotency_key="k-0"))
    r1 = make(1, np.arange(3, 9, dtype=np.int32), max_new_tokens=4)
    r1.prompt_len_orig = 4              # a re-admitted preempted request
    j.admit_request(r1)
    j.tokens(0, (11, 12))
    j.tokens(1, (3,))
    j.finish(1, "length")
    j.flush()
    j.tokens(0, (13,))
    j.close()


def _entries(journal_mod, d):
    return {rid: {k: v for k, v in dataclasses.asdict(e).items()
                  if k != "wall"}
            for rid, e in journal_mod.RequestJournal(d).entries.items()}


def test_journals_replay_across_packages(tmp_path):
    _write(tj, TRequest, TSampling, str(tmp_path / "port"))
    _write(jj, JRequest, JSampling, str(tmp_path / "ref"))
    for d in ("port", "ref"):
        want = _entries(jj, str(tmp_path / d))
        assert _entries(tj, str(tmp_path / d)) == want
        assert want[0]["tokens"] == [11, 12, 13]
        assert want[1]["prompt"] == [3, 4, 5, 6]
        assert want[0]["ikey"] == "k-0" and want[0]["priority"] == 2
    assert _entries(tj, str(tmp_path / "port")) == \
        _entries(tj, str(tmp_path / "ref"))


def test_key_after_matches_reference():
    for seed in range(21):
        for n in range(13):
            want = jj.key_after(seed, n)
            got = tj.key_after(seed, n)
            if n == 0:
                assert want is None and got is None
            else:
                assert got.dtype == np.uint32
                np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(tj.prng_key(7),
                                  np.asarray(jax.random.PRNGKey(7)))
    np.testing.assert_array_equal(
        tj.split(tj.prng_key(3), 4),
        np.asarray(jax.random.split(jax.random.PRNGKey(3), 4)))


@pytest.mark.parametrize("body", [
    ([1, 2, 3], 8, 0.0, 0, 0, None), ([1, 2, 3], 8, 0.0, 0, 0, "m"),
    (np.array([5, 9]), 3, 0.7, 20, 11, None), ([], 1, 1.5, 0, 2 ** 31, "x")])
def test_body_fingerprint_matches_reference(body):
    assert tj.body_fingerprint(*body) == jj.body_fingerprint(*body)


def test_to_request_rebuilds_preempt_shape():
    e = tj.JournalEntry(rid=5, prompt=[1, 2, 3], max_new_tokens=10,
                        temperature=0.9, top_k=4, seed=13, tokens=[40, 41],
                        wall=time.time() - 2.5, ikey="k", fp=123)
    r = e.to_request()
    assert r.rid == 5 and list(r.prompt) == [1, 2, 3, 40, 41]
    assert r.out_tokens == [40, 41] and r.prompt_len_orig == 3
    assert r.idempotency_key == "k" and r.sampling.seed == 13
    assert time.perf_counter() - r.t_submit >= 2.4
    assert r.output().prompt_len == 3


# -- crash recovery ----------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _smoke():
    cfg = t_smoke("tinyllama_1_1b")
    return cfg, tR.model_init(cfg, 0, "cpu")


def _mixed_requests(max_new=8):
    """Two greedy and two sampled requests."""
    return [_req(0, 5, max_new=max_new),
            _req(1, 9, max_new=max_new,
                 sampling=TSampling(temperature=0.8, top_k=8, seed=11)),
            _req(2, 7, max_new=max_new,
                 sampling=TSampling(temperature=1.1, seed=3)),
            _req(3, 6, max_new=max_new)]


def _engine(journal=None, **kw):
    cfg, params = _smoke()
    return TEngine(params, cfg, batch_slots=4, buffer_len=64, chunk_size=8,
                   journal=journal, device="cpu", **kw)


_MODES = {"window": {}, "packed": {"packed": True},
          "paged window": {"paged": True, "page_size": 4},
          "paged packed": {"packed": True, "paged": True, "page_size": 4}}


@pytest.mark.parametrize("mode", list(_MODES))
def test_crash_recovery_token_identical(tmp_path, mode):
    kw = _MODES[mode]
    ref_eng = _engine(**kw)
    for r in _mixed_requests():
        ref_eng.submit(r)
    ref_eng.run_until_drained()
    ref = {o.rid: o.tokens for o in ref_eng.outputs()}

    d = str(tmp_path / "j")
    j = tj.RequestJournal(d)
    eng = _engine(journal=j, **kw)
    for r in _mixed_requests():
        eng.submit(r)
    for _ in range(3):                  # die mid-stream
        eng.step()
    j.close()

    j2 = tj.RequestJournal(d)
    assert j2.live_entries() and any(e.tokens for e in j2.live_entries())
    eng2 = _engine(journal=j2, **kw)
    assert eng2.recover_from_journal()
    eng2.run_until_drained()
    assert {o.rid: o.tokens for o in eng2.outputs()} == ref
    for rid, toks in ref.items():
        assert tuple(j2.entries[rid].tokens) == toks
        assert j2.entries[rid].finish_reason in ("eos", "length")
    assert len(glob.glob(os.path.join(d, "seg_*.wal"))) == 1  # compacted


def test_recovery_finishes_each_request_exactly_once(tmp_path):
    d = str(tmp_path / "j")
    j = tj.RequestJournal(d)
    eng = _engine(journal=j)
    short, long_ = _req(0, 4, max_new=2), _req(1, 4, max_new=12)
    eng.submit(short)
    eng.submit(long_)
    while short.finish_reason is None:
        eng.step()
    j.close()

    j2 = tj.RequestJournal(d)
    assert j2.entries[0].done
    fins = []
    eng2 = _engine(journal=j2)
    recovered = eng2.recover_from_journal(
        wire=lambda r: setattr(r, "on_finish",
                               lambda out: fins.append(out.rid)))
    assert [r.rid for r in recovered] == [1]
    eng2.run_until_drained()
    assert fins == [1] and j2.entries[1].done


def test_deadline_expired_while_down_times_out_once(tmp_path):
    d = str(tmp_path / "j")
    j = tj.RequestJournal(d)
    eng = _engine(journal=j)
    eng.submit(_req(0, 4, max_new=50, deadline_s=0.2))
    eng.step()
    j.close()
    time.sleep(0.3)                     # the outage outlives the deadline
    j2 = tj.RequestJournal(d)
    fins = []
    eng2 = _engine(journal=j2)
    assert eng2.recover_from_journal(
        wire=lambda r: setattr(r, "on_finish", fins.append)) == []
    eng2.run_until_drained()
    assert [o.finish_reason for o in fins] == ["timeout"]
    assert j2.entries[0].finish_reason == "timeout"
    assert eng2.stats.timeouts == 1


# -- the supervised launcher -------------------------------------------------

def _serve(tmp_path, name, *extra):
    d = str(tmp_path / name)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "tinyllama_1_1b", "--smoke", "--device", "cpu", "--requests", "6",
           "--max-new", "8", "--chunk-size", "8", "--temperature", "0.8",
           "--top-k", "20", "--journal", d, *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout, tj.RequestJournal(d).entries


def test_supervised_kill9_launcher(tmp_path):
    out, got = _serve(tmp_path, "die", "--supervise", "--inject",
                      "die:step=3")
    assert "restart #1 with die injector stripped" in out
    assert "child exited 0 after 1 restart(s)" in out
    assert "live request(s) recovered mid-stream" in out
    _out, want = _serve(tmp_path, "clean")
    assert sorted(got) == list(range(6))
    assert {r: (e.finish_reason, e.tokens) for r, e in got.items()} == \
        {r: (e.finish_reason, e.tokens) for r, e in want.items()}
    assert all(e.finish_reason == "length" for e in got.values())
