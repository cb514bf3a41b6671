"""Trace validation in the port (``tpuvsr_torch/validate``) on the
counter stub, held against the JAX package: the TRACE.jsonl format, the
interpreter validator, the batch validator's reports (``BatchValidator``
with the plain step on the CPU) against JAX's ``BatchValidator`` and
``host_validate_batch`` on the same ``stub_trace_records``, and the plain
step of K16 (``validate/batch.select`` and ``commit``) against JAX's
validation chunk (``one_trace`` vmapped over traces) bit for bit.

The JAX validator is built once for the file (one compile of its chunk
for 48 traces, 4 candidate slots, 4 steps).  Every comparison is of
integers: tolerance 0."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import tpuvsr.testing as jt
from tpuvsr.validate.batch import ev_slice_d
from tpuvsr.validate.batch import traces_digest as j_digest
from tpuvsr.validate.host import host_validate_batch as j_host_batch
from tpuvsr.validate.traces import traces_from_records as j_traces
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch.core.values import TLAError
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.testing import (counter_binding, counter_spec,
                                  stub_trace_records, stub_validator)
from tpuvsr_torch.validate import (BatchValidator, ObservationUnsupported,
                                   load_traces, save_traces, traces_digest,
                                   validate_result_summary, validate_trace)
from tpuvsr_torch.validate import batch as vb
from tpuvsr_torch.validate.host import host_validate_batch
from tpuvsr_torch.validate.traces import (trace_from_record,
                                          traces_from_records)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 48                  # traces a JAX round
VARIANTS = {
    "genuine": {},
    "mutated": {"mutate": (11, 2)},
    "mutated_late": {"mutate": (31, 4)},
    "partial": {"drop_vars": ("y",)},
    "blank": {"blank_every": 3},
    "actions_only": {"drop_vars": ("x", "y")},
    "vars_only": {"drop_actions": True},
}


def mk_traces(spec=None, **kw):
    spec = spec or counter_spec()
    return traces_from_records(stub_trace_records(spec=spec, **kw), spec)


def div_sig(res):
    return json.dumps(res.divergences, sort_keys=True)


@pytest.fixture(scope="module")
def jax_validator():
    """The JAX stub validator: N traces a round, 4 slots, 4-step chunks
    (compiled once; every variant below keeps 4 slots)."""
    return jt.stub_validator(batch=N, n_devices=1, cand_cap=4,
                             chunk_steps=4)


# ---------------------------------------------------------------------
# the TRACE.jsonl format
# ---------------------------------------------------------------------
def test_traces_roundtrip(tmp_path):
    spec = counter_spec()
    recs = stub_trace_records(n=4, depth=5, seed=0)
    path = str(tmp_path / "t.jsonl")
    save_traces(path, recs)
    traces = load_traces(path, spec)
    assert [t.tid for t in traces] == [r["trace"] for r in recs]
    assert [t.to_record() for t in traces] == recs
    save_traces(path, traces)
    assert [t.to_record() for t in load_traces(path, spec)] == recs


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_records_and_traces_match_jax(variant):
    """The port's stub walks are the JAX package's (same seed), and its
    parsed traces print the same records."""
    kw = VARIANTS[variant]
    recs = stub_trace_records(n=N, depth=6, seed=0, **kw)
    assert recs == jt.stub_trace_records(n=N, depth=6, seed=0, **kw)
    traces = traces_from_records(recs, counter_spec())
    jtraces = j_traces(recs, jt.counter_spec())
    assert [t.to_record() for t in traces] == \
        [t.to_record() for t in jtraces]
    assert traces_digest(traces) == j_digest(jtraces)


def test_trace_unknown_names_fail_loudly():
    spec = counter_spec()
    with pytest.raises(TLAError, match="unknown to the spec"):
        trace_from_record({"init": {"z": 0}, "events": []}, spec)
    with pytest.raises(TLAError, match="not a spec action"):
        trace_from_record(
            {"events": [{"action": "Nope", "vars": {"x": 1}}]}, spec)
    with pytest.raises(TLAError, match="unknown to the spec"):
        trace_from_record({"events": [{"vars": {"zz": 1}}]}, spec)


# ---------------------------------------------------------------------
# the interpreter validator
# ---------------------------------------------------------------------
def test_host_accepts_genuine_walks():
    spec = counter_spec()
    res = host_validate_batch(spec, mk_traces(n=16, depth=6, seed=0))
    assert res.ok and res.accepted == res.traces_checked == 16
    assert not res.divergences


def test_host_divergence_at_exact_mutated_step():
    spec = counter_spec()
    res = host_validate_batch(
        spec, mk_traces(n=8, depth=6, seed=1, mutate=(5, 3)))
    assert not res.ok and res.accepted == 7
    rec = res.first_divergence
    assert rec["trace"] == "t-0005" and rec["step"] == 3
    assert rec["candidates"] >= 1
    assert {e["action"] for e in rec["enabled"]} <= {"IncX", "IncY"}
    assert all(e["location"] for e in rec["enabled"])


def test_host_partial_observation_stays_accepted():
    spec = counter_spec()
    traces = mk_traces(n=8, depth=6, seed=2, drop_vars=("y",),
                       blank_every=3)
    assert host_validate_batch(spec, traces).ok
    v = validate_trace(spec, traces[0])
    assert v.ok and v.max_candidates > 1


def test_host_no_init_state_is_a_step0_divergence():
    spec = counter_spec()
    traces = traces_from_records(
        [{"trace": "bad-init", "init": {"x": "5"}, "events": []}], spec)
    for res in (host_validate_batch(spec, traces),
                stub_validator(batch=4, device="cpu").run(traces)):
        rec = res.first_divergence
        assert rec["trace"] == "bad-init" and rec["step"] == 0
        assert rec["reason"] == "no-init-state" and rec["enabled"] == []


def test_host_invariant_metadata_on_conforming_trace():
    spec = counter_spec(inv_x_bound=2)
    rec = {"trace": "t-inv", "init": {"x": "0", "y": "0"},
           "events": [{"action": "IncX", "vars": {"x": str(i)}}
                      for i in (1, 2, 3)]}
    v = validate_trace(spec, trace_from_record(rec, spec))
    assert v.ok
    assert v.violated_invariant == "Bound" and v.violated_at == 2


def test_next_action_record_is_action_unobserved():
    spec = counter_spec()
    recs = stub_trace_records(n=4, depth=6, seed=0)
    for r in recs:
        for ev in r["events"]:
            if "action" in ev:
                ev["action"] = "Next"
    traces = traces_from_records(recs, spec)
    assert all(e.action is None for t in traces for e in t.events)
    assert host_validate_batch(spec, traces).ok
    assert stub_validator(batch=4, device="cpu").run(traces).ok


def test_deadline_stop_is_incomplete_not_diverged():
    spec = counter_spec()
    traces = mk_traces(n=32, depth=6, seed=0)
    hres = host_validate_batch(spec, traces, max_seconds=1e-9)
    assert hres.error == "deadline" and hres.ok
    assert hres.traces_checked < 32
    bres = stub_validator(batch=8, chunk_steps=2, device="cpu").run(
        traces, max_seconds=1e-9)
    assert bres.error == "deadline" and bres.ok
    assert bres.traces_checked < 32


def test_host_candidate_cap_is_a_policy_error():
    spec = counter_spec()
    traces = traces_from_records(
        [{"trace": "wide", "events": [{}, {}, {}]}], spec)
    with pytest.raises(TLAError, match="candidate set exceeds"):
        validate_trace(spec, traces[0], max_candidates=2)


# ---------------------------------------------------------------------
# the batch validator against the interpreter and against JAX
# ---------------------------------------------------------------------
def test_batch_matches_host_oracle():
    spec = counter_spec()
    traces = mk_traces(n=48, depth=6, seed=3, mutate=(31, 4))
    hres = host_validate_batch(spec, traces)
    bres = stub_validator(batch=16, device="cpu").run(traces)
    assert bres.traces_checked == hres.traces_checked == 48
    assert bres.accepted == hres.accepted == 47
    bd, hd = bres.first_divergence, hres.first_divergence
    assert (bd["trace"], bd["step"], bd["candidates"]) \
        == (hd["trace"], hd["step"], hd["candidates"]) \
        == ("t-0031", 4, 1)
    assert bres.divergences == hres.divergences


def test_batch_partial_observation_stays_accepted():
    traces = mk_traces(n=16, depth=6, seed=2, drop_vars=("y",),
                       blank_every=3)
    res = stub_validator(batch=16, device="cpu").run(traces)
    assert res.ok and res.accepted == 16
    bv = stub_validator(batch=16, cand_cap=1, device="cpu")
    r2 = bv.run(traces)
    assert r2.ok and bv.K > 1


def test_batch_cand_cap_growth_is_counted():
    traces = mk_traces(n=8, depth=6, seed=2, blank_every=2)
    bv = stub_validator(batch=8, cand_cap=1, device="cpu")
    res = bv.run(traces)
    assert res.ok
    assert bv.counters["grow_cand_cap"] >= 1
    assert res.metrics["gauges"]["cand_cap"] == bv.K > 1
    assert res.metrics["gauges"]["max_candidates"] == max(
        max(v) for v in bv.sizes.values())


def test_divergence_identical_across_batch_sizes():
    traces = mk_traces(n=64, depth=6, seed=1, mutate=(40, 5))
    sigs = {B: div_sig(stub_validator(batch=B, device="cpu").run(traces))
            for B in (8, 32, 64)}
    assert sigs[8] == sigs[32] == sigs[64]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reports_match_jax(jax_validator, variant):
    """The port's batch and host validators report what JAX's batch and
    host validators report (step, event, enabled set with locations,
    candidates) on the same records, accepted and mutated."""
    kw = VARIANTS[variant]
    recs = stub_trace_records(n=N, depth=6, seed=0, **kw)
    jtr = j_traces(recs, jt.counter_spec())
    jres = jax_validator.run(jtr)
    assert jax_validator.K == 4
    want = json.loads(json.dumps(jres.divergences))
    assert want == json.loads(json.dumps(
        j_host_batch(jt.counter_spec(), jtr).divergences))
    traces = traces_from_records(recs, counter_spec())
    res = stub_validator(batch=N, device="cpu").run(traces)
    assert json.loads(json.dumps(res.divergences)) == want
    assert json.loads(json.dumps(host_validate_batch(
        counter_spec(), traces).divergences)) == want
    assert (res.traces_checked, res.accepted) == (jres.traces_checked,
                                                  jres.accepted)
    if "mutate" in kw:
        i, s = kw["mutate"]
        assert [(d["trace"], d["step"]) for d in want] == \
            [(f"t-{i:04d}", s)]
    else:
        assert res.ok


def _jax_flat(d, keys):
    T, K = d[keys[0]].shape[:2]
    return np.concatenate([np.asarray(d[k]).reshape(T * K, -1)
                           for k in keys], axis=1).astype(np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_step_is_jax_one_trace(jax_validator, variant):
    """Four steps of the port's plain step (select, the stub's actions
    and fingerprints, commit) against one JAX chunk of four steps on the
    same encoded round: candidate rows, alive, div_at, div_en, div_cand
    and the chunk's remaining, diverged, overflow and error flags, bit
    for bit."""
    recs = stub_trace_records(n=N, depth=6, seed=0, **VARIANTS[variant])
    jv = jax_validator
    jarr, jpre, jS = jv._encode_round(j_traces(recs, jt.counter_spec()))
    C = jv.chunk
    out = jv._chunk(
        {k: v for k, v in jarr["cands"].items()}, jarr["alive"],
        np.full((jv.T_pad,), -1, np.int32),
        np.zeros((jv.T_pad, jv.L), bool), np.zeros((jv.T_pad,), np.int32),
        jarr["tlen"], ev_slice_d(jarr, "aid_obs", 0, C, jv.T_pad, -1),
        {k: ev_slice_d(jarr["ob_m"], k, 0, C, jv.T_pad, False)
         for k in jarr["ob_m"]},
        {k: ev_slice_d(jarr["ob_v"], k, 0, C, jv.T_pad, 0)
         for k in jarr["ob_v"]}, np.int32(0))
    bv = stub_validator(batch=N, chunk_steps=C, device="cpu")
    traces = traces_from_records(recs, counter_spec())
    arr, pre, S = bv._encode_round(traces)
    keys = [k for k, _s, _a, _e in bv.pk._splits]
    assert (pre, S, bv.K) == (jpre, jS, jv.K)
    st, dev_obs = bv._round_state(arr)
    assert np.array_equal(st["cands"].numpy(),
                          _jax_flat(jarr["cands"], keys))
    assert np.array_equal(st["alive"].numpy(),
                          np.asarray(jarr["alive"]).reshape(-1))
    for s in range(min(C, S)):
        bv._step(st, dev_obs, s, s == min(C, S) - 1, C)
    assert np.array_equal(st["cands"].numpy(), _jax_flat(out[0], keys))
    assert np.array_equal(st["alive"].numpy(),
                          np.asarray(out[1]).reshape(-1))
    assert np.array_equal(st["div_at"].numpy(), np.asarray(out[2]))
    assert np.array_equal(st["div_en"].numpy(), np.asarray(out[3]))
    assert np.array_equal(st["div_cand"].numpy(), np.asarray(out[4]))
    ovf, err, rem, n_div = st["red"].tolist()
    assert (rem, n_div, ovf > 0, err > 0) == (
        int(out[5]), int(out[6]), bool(out[7]), bool(out[8]))


def test_commit_dedups_without_pairs():
    """The plain commit keeps the first occurrence of each fingerprint in
    queue order: duplicates of one successor in two candidates collapse
    to the first, and ranks past K overflow."""
    T, K, W, L = 2, 2, 3, 2
    st = {"cands": torch.zeros((T * K, W), dtype=torch.int32),
          "alive": torch.tensor([1, 1, 1, 0], dtype=torch.bool),
          "div_at": torch.tensor([-1, -1], dtype=torch.int32),
          "div_en": torch.zeros((T, L), dtype=torch.bool),
          "div_cand": torch.zeros((T,), dtype=torch.int32),
          "tlen": torch.tensor([3, 3], dtype=torch.int32),
          "red": torch.zeros((4,), dtype=torch.int64)}
    en = torch.tensor([[1, 1], [1, 1], [1, 0], [0, 0]], dtype=torch.bool)
    roff = torch.tensor([0, 2, 4, 4, 4], dtype=torch.int64)
    succ = torch.tensor([[1, 0, 0], [2, 0, 0], [2, 0, 0], [3, 0, 0]],
                        dtype=torch.int32)
    fp = succ[:, :1].repeat(1, 4)
    none = torch.zeros((T,), dtype=torch.int32)
    vb.commit_plain(st, roff, succ, torch.ones(4, dtype=torch.bool),
                    torch.zeros(4, dtype=torch.int32), fp, en, none, none,
                    torch.zeros(0, dtype=torch.int32),
                    torch.zeros(0, dtype=torch.int32), 0, True, 1)
    # trace 0: successors 1, 2, (2), 3 -> three new, two kept, overflow
    assert st["cands"][:2, 0].tolist() == [1, 2]
    # trace 1: no item -> it diverges with one candidate, lane 0 enabled,
    # and keeps its candidates
    assert st["alive"].tolist() == [True, True, True, False]
    assert st["div_at"].tolist() == [-1, 0]
    assert st["div_cand"].tolist() == [0, 1]
    assert st["div_en"][1].tolist() == [True, False]
    assert st["red"].tolist() == [1, 0, 1, 1]   # trace 0 runs on past 1


def test_observation_and_confirmation_refusals():
    spec = counter_spec()
    traces = traces_from_records(
        [{"trace": "t", "events": [{"action": "IncX",
                                    "vars": {"x": "<<1>>"}}]}], spec)
    with pytest.raises(ObservationUnsupported):
        stub_validator(device="cpu").check_observations(traces)
    from tpuvsr_torch.testing import stub_model_factory
    with pytest.raises(TLAError, match="confirm=False"):
        BatchValidator(counter_binding(), device="cpu",
                       model_factory=stub_model_factory())
    with pytest.raises(TLAError, match="confirm=False"):
        BatchValidator(load_binding(os.path.join(
            ROOT, "tpuvsr_torch", "configs", "VSR_shipped.cfg"), "VSR"),
            device="cpu")


def test_summary_is_json():
    res = stub_validator(batch=8, device="cpu").run(
        mk_traces(n=8, depth=4, seed=1, mutate=(3, 1)))
    doc = validate_result_summary(res)
    assert json.loads(json.dumps(doc))["first_divergence"]["trace"] == \
        "t-0003"
    assert doc["traces"] == 8 and doc["accepted"] == 7 and not doc["ok"]
