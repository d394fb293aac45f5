"""The PyTorch port's training substrate on the CPU, against the JAX
reference: checkpoints, the fault policy and recovery, chaos injection,
the data cursor, the pinned schedule of an elastic restart, and the
driver's recovery loop.

* **Module parity.**  The same inputs go through both packages:
  ``ChaosSchedule.parse`` over valid and invalid specs, fire-once hooks,
  ``FaultPolicy``, ``StragglerDetector``, ``run_with_recovery`` and
  ``FaultEventLog`` (the same returns and events, less the wall time
  ``"t"``), ``DataCursor`` and ``resume`` hardening, host sharding, and
  ``SPMConfig.schedule_shards`` (the strides, ``sharded_eligible`` and
  ``plan_steps``).
* **The on-disk format, cross-checked.**  A train state of the paper's MLP
  in the reference's tree (every moment live), carried over with
  ``state_from_jax`` and saved by both packages: the manifests are equal
  entry for entry, each package verifies the other's directory, and each
  restores the other's bit for bit.  Each corruption mode, drawn from the
  same seeded generator on both directories, hits the same step and byte
  and gives the same problems and the same quarantine in either package.
* **The driver** (``launch.train.train`` at smoke size): a run hit by a
  NaN burst, a flipped byte and a preemption ends bit for bit equal to the
  clean run, with the reference test's numbers and event checks
  (``tests/test_chaos.py``); a rollback with no checkpoint restarts fresh;
  a ``slow@`` event is flagged (the port's step clock starts before
  ``pre_step``; the reference's starts after it, so its driver never
  flags one); a process that dies after 3 steps resumes bit for bit equal
  to 6 straight steps.
* **The elastic restart** at the reference's N = 256, on CPU meshes.
  (a) A run that trains 4-way, rolls back, has its newest checkpoint
  truncated and is preempted, then resumes 2-way, ends bit for bit equal
  to a fault-free run that trains 4-way for steps 0-5 and 2-way for 6-11.
  The reference's own test (``tests/test_chaos_distributed.py``) compares
  against a run that stays 8-way throughout; on jax 0.9.0 its one step
  across widths differs by f32 ulps, so the port is held to the contract
  instead: an exact restore and a pinned schedule, the rounding of each
  step being that of its width.  (b) The same restored state's grads on 4
  shards and on 2: each within gamma_rows of the sum of its terms'
  magnitudes.  They need not be bit for bit: a table grad may sum the
  rows in an order that follows the shard width (the plain versions'
  reductions over slabs of 64 or 128 lanes here, K2's plan on the card,
  ``chip_smoke.py`` phase 21).  The step's only width-dependent part is
  the grads, so they are what is held.
* **``state_from_jax``**: two reference steps of the smoke ``qwen3-1.7b``
  on numpy batches carry over exactly (moments unstacked, count, step),
  and one more step in each package agrees within
  ``tests/test_torch_train.py``'s bound.
"""

import dataclasses
import json
import logging
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import train as J  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.configs.paper import student_cfg as j_student_cfg  # noqa: E402
from repro.core import eligibility as J_el  # noqa: E402
from repro.core import spm as J_spm  # noqa: E402
from repro.data import loader as J_loader  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import mlp as J_MLP  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.optim import adamw as J_opt  # noqa: E402
from repro.train import chaos as J_chaos  # noqa: E402
from repro.train import fault as J_fault  # noqa: E402
from repro_torch import train as T  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core import eligibility as T_el  # noqa: E402
from repro_torch.core import spm as T_spm  # noqa: E402
from repro_torch.data import loader as T_loader  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.parallel import (activation_sharding,  # noqa: E402
                                  make_feature_mesh)
from repro_torch.params import Params  # noqa: E402
from repro_torch.train import chaos as T_chaos  # noqa: E402
from repro_torch.train import fault as T_fault  # noqa: E402
from repro_torch.train.state import tree_leaves_with_path  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


def _no_t(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def _leaves(state):
    return tree_leaves_with_path(state)


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


# ---------------------------------------------------------------------------
# chaos plans, the fault policy, the watchdog, recovery, the event log
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "nan@13+5; corrupt@18:truncate; preempt@19; slow@3:0.01",
    "corrupt@5;slow@2", "", "nan@6+5;corrupt@11:delmeta;preempt@11;"
    "slow@11:2.0", "corrupt@1:orphan;;nan@0", "explode@3", "nan@x",
    "corrupt@5:gamma", "preempt@5:arg", "corrupt@5+3", "nan@", "slow@2:abc"])
def test_chaos_parse_matches_reference(spec):
    """The same ``(kind, step, arg)`` events in the same order, or a
    ``ValueError`` from both."""
    def parse(mod):
        try:
            return [(e.kind, e.step, e.arg, e.fired)
                    for e in mod.ChaosSchedule.parse(spec).events]
        except ValueError:
            return ValueError

    assert parse(T_chaos) == parse(J_chaos)


def test_chaos_hooks_fire_once_as_in_reference(tmp_path):
    """One call sequence through both schedules: poison, pre_step and
    post_step return and raise alike, each event fires once, and the
    emitted events agree."""
    spec = "nan@3;slow@1:0.001;corrupt@4:bitflip;preempt@5"

    def drive(mod, fault):
        sched, log, out = mod.ChaosSchedule.parse(spec), \
            fault.FaultEventLog(), []
        out += [sched.poison(2), sched.poison(3), sched.poison(3),
                sched.pre_step(1), sched.pre_step(1)]
        sched.post_step(4, None, event_log=log)   # no dir: skipped, fired
        for _ in range(2):
            try:
                sched.post_step(5, None, event_log=log)
                out.append("ran")
            except mod.ChaosPreemption as e:
                out.append(str(e))
        return out, sched.remaining(), _no_t(log.events)

    got, want = drive(T_chaos, T_fault), drive(J_chaos, J_fault)
    assert got == want and got[1] == ()
    assert got[0] == [0.0, 1.0, 0.0, 0.001, 0.0,
                      "injected preemption after step 5", "ran"]


@pytest.mark.parametrize("max_skips", [2, 5])
def test_fault_policy_matches_reference(max_skips):
    flags = [0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1]
    got, want = T_fault.FaultPolicy(max_skips), J_fault.FaultPolicy(max_skips)
    for i, f in enumerate(flags):
        assert got.on_metrics({"skipped": float(f)}) == \
            want.on_metrics({"skipped": float(f)}), i
        if i == 7:
            got.reset()
            want.reset()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("factor, patience, min_samples",
                         [(1.5, 1, 3), (1.5, 2, 5), (3.0, 1, 5)])
def test_straggler_detector_matches_reference(factor, patience,
                                              min_samples):
    dts = [0.5, 0.01, 0.01, 0.012, 0.01, 0.011, 0.05, 0.01, 0.03, 0.03,
           0.04, 0.01, 0.2]
    logs = T_fault.FaultEventLog(), J_fault.FaultEventLog()
    dets = [mod.StragglerDetector(factor=factor, patience=patience,
                                  min_samples=min_samples, event_log=log)
            for mod, log in zip((T_fault, J_fault), logs)]
    for s, dt in enumerate(dts):
        assert dets[0].observe(s, dt) == dets[1].observe(s, dt), s
    assert _no_t(logs[0].events) == _no_t(logs[1].events)
    assert logs[0].kinds()


@pytest.mark.parametrize("scenario", ["two_failures", "crash_loop",
                                      "interrupt", "backoff_cap"])
def test_run_with_recovery_matches_reference(scenario):
    """The same loop through both: the resume intents it was called with,
    the backoffs slept, the return or the exception, and the events."""
    def drive(fault):
        calls, slept, log = [], [], fault.FaultEventLog()

        def loop(resume):
            calls.append(resume)
            if scenario == "interrupt":
                raise KeyboardInterrupt
            if scenario == "crash_loop" or len(calls) < 4 - (
                    scenario == "two_failures"):
                raise RuntimeError(f"fault {len(calls)}")
            return "done"

        kw = dict(max_restarts=2 if scenario == "crash_loop" else 3,
                  event_log=log, sleep=slept.append)
        if scenario == "backoff_cap":
            kw.update(backoff_base=10.0, backoff_max=15.0)
        try:
            out = fault.run_with_recovery(loop, **kw)
        except (RuntimeError, KeyboardInterrupt) as e:
            out = repr(e)
        return out, calls, slept, _no_t(log.events)

    got = drive(T_fault)
    assert got == drive(J_fault)
    assert T_fault.RESUME_LATEST == J_fault.RESUME_LATEST
    if scenario == "two_failures":
        assert got[:3] == ("done", [None, -1, -1], [0.5, 1.0])
    if scenario == "crash_loop":
        assert [e["kind"] for e in got[3]] == [
            "restart", "restart", "restart_budget_exhausted"]


def test_event_log_jsonl_matches_reference(tmp_path):
    lines = []
    for mod, name in ((T_fault, "port"), (J_fault, "ref")):
        path = str(tmp_path / name / "events.jsonl")
        log = mod.FaultEventLog(path)
        log.emit("skip", step=3, cause="non-finite grads")
        log.emit("restart", attempt=1, backoff_s=0.5)
        log.emit("quarantine", step=np.int64(9), cause="x", path="c")
        lines.append([json.loads(line) for line in open(path)])
        assert all(e["t"] > 0 for e in lines[-1])
        assert _no_t(lines[-1]) == _no_t(log.events)
    assert _no_t(lines[0]) == _no_t(lines[1])


# ---------------------------------------------------------------------------
# the data cursor and host sharding
# ---------------------------------------------------------------------------

def test_cursor_and_resume_hardening_match_reference(caplog):
    t_load = T_loader.DeterministicLoader(lambda rng, n: {}, 8, seed=1)
    j_load = J_loader.DeterministicLoader(lambda key, n: {}, 8, seed=1)
    for cur in ({"seed": 7, "step": 42}, None, {"step": 5}, "garbage",
                {"seed": "x", "step": 1}, {"seed": 3, "step": "9"}):
        with caplog.at_level(logging.WARNING):
            assert t_load.resume(cur) == j_load.resume(cur), cur
        assert t_load.state_dict() == j_load.state_dict(), cur
    assert t_load.cursor == T_loader.DataCursor.from_state(
        j_load.cursor.state_dict())
    assert "keeping fresh cursor" in caplog.text
    # the iterator walks the cursor as the reference's does
    t_load.batch_fn = lambda rng, n: {"x": rng.integers(0, 100, n)}
    first = next(t_load)
    assert t_load.cursor.step == 10
    np.testing.assert_array_equal(first["x"], t_load.batch_at(9)["x"])


def test_host_sharding_slices_the_global_batch():
    """Each host's rows are its slice of the global batch, in both
    packages (their draws differ: numpy and jax.random)."""
    def t_fn(rng, n):
        return {"x": torch.from_numpy(rng.standard_normal((n, 3))),
                "nest": {"y": np.arange(n)}}

    def j_fn(key, n):
        return {"x": jax.random.normal(key, (n, 3)),
                "nest": {"y": jnp.arange(n)}}

    for mod, fn, cat in ((T_loader, t_fn, np.concatenate),
                         (J_loader, j_fn, np.concatenate)):
        whole = mod.DeterministicLoader(fn, 8, seed=3).batch_at(5)
        parts = [mod.DeterministicLoader(fn, 8, seed=3, n_hosts=4,
                                         host_id=h).batch_at(5)
                 for h in range(4)]
        for key in ("x", ("nest", "y")):
            get = ((lambda b: b[key]) if isinstance(key, str)
                   else (lambda b: b[key[0]][key[1]]))
            np.testing.assert_array_equal(
                cat([np.asarray(get(p)) for p in parts]),
                np.asarray(get(whole)))


# ---------------------------------------------------------------------------
# the pinned schedule of an elastic restart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [96, 256])
@pytest.mark.parametrize("m", [4, 2, 1])
def test_schedule_shards_matches_reference(n, m):
    """``schedule_shards=4`` keeps the strides of the 4-shard schedule at
    every executing width, as the reference's does; ``sharded_eligible``
    and the split into local runs and exchanges (``plan_steps``) agree."""
    L = 12 if n == 256 else 8
    kw = dict(n=n, n_stages=L, schedule="two_level", backward="custom")
    tc = T_spm.SPMConfig(n_shards=m, schedule_shards=4, **kw)
    jc = J_spm.SPMConfig(n_shards=m, schedule_shards=4, **kw)
    strides = tc.pairing.strides()
    assert strides == jc.pairing.strides()
    assert strides == T_spm.SPMConfig(n_shards=4, **kw).pairing.strides()
    unpinned = T_spm.SPMConfig(n_shards=m, **kw).pairing.strides()
    assert (unpinned == strides) == (
        J_spm.SPMConfig(n_shards=m, **kw).pairing.strides() == strides)
    assert T_el.sharded_eligible(tc) == J_el.sharded_eligible(jc)
    assert T_el.sharded_eligible(tc) == (m > 1)
    if m > 1:
        assert T_el.plan_steps(n, strides, m) == J_el.plan_steps(n, strides,
                                                                 m)


# ---------------------------------------------------------------------------
# the on-disk format, cross-checked on the paper's MLP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mlp_states():
    """A train state of the reference's Table 1 student (SPM mix, dense
    head) in the reference's tree, numpy leaves drawn from a seed with
    every moment live and count and step at 3, as jax arrays and as numpy,
    and the port's ``state_from_jax`` of it."""
    cfg = j_student_cfg(32, 10, "spm_general")
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(lambda: J.make_train_state(
        J_MLP.init_mlp(jax.random.PRNGKey(0), cfg)))
    jnp_state = jax.tree.map(
        lambda s: (np.asarray(3, s.dtype) if s.dtype == jnp.int32 else
                   rng.standard_normal(s.shape).astype(s.dtype)), shapes)
    jstate = jax.tree.map(jnp.asarray, jnp_state)
    return jstate, jnp_state, state_from_jax(jnp_state, device="cpu")


def _fresh_like(jnp_state):
    return state_from_jax(jax.tree.map(np.zeros_like, jnp_state),
                          device="cpu")


def _save_both(tmp_path, mlp_states, steps=(2, 5)):
    jstate, _, tstate = mlp_states
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    for s in steps:
        extra = {"cursor": {"seed": 1, "step": s}}
        J.save_checkpoint(dj, s, jstate, extra=extra)
        T.save_checkpoint(dt, s, tstate, extra=extra)
    return dj, dt


def _meta(d, step):
    with open(os.path.join(d, f"step_{step}", "meta.json")) as f:
        return json.load(f)


def test_both_packages_write_and_read_the_same_format(tmp_path,
                                                      mlp_states):
    jstate, jnp_state, tstate = mlp_states
    dj, dt = _save_both(tmp_path, mlp_states, steps=(5,))
    mj, mt = _meta(dj, 5), _meta(dt, 5)
    assert mt["manifest"] == mj["manifest"]
    assert len(mt["manifest"]) == mt["n_arrays"] == mj["n_arrays"]
    for key in ("treedef", "step", "format", "extra"):
        assert mt[key] == mj[key], key
    assert mt["format"] == 2
    assert {e["dtype"] for e in mt["manifest"].values()} == {"float32",
                                                             "int32"}
    assert T.tree_signature(tstate)["treedef"] == str(
        jax.tree_util.tree_structure(jstate))
    assert os.path.getsize(os.path.join(dt, "step_5", "arrays.npz")) == \
        os.path.getsize(os.path.join(dj, "step_5", "arrays.npz"))
    # each verifies the other's
    assert J.verify_checkpoint(dt, 5) == [] == T.verify_checkpoint(dj, 5)
    # the port restores the reference's bit for bit, in place
    like = _fresh_like(jnp_state)
    decay = like["opt"]["decay"]
    got, extra = T.restore_checkpoint(dj, like)
    assert got is like and extra == {"cursor": {"seed": 1, "step": 5}}
    assert got["opt"]["decay"] is decay
    _assert_bitwise(got, tstate)
    # and the reference the port's
    back, _ = J.restore_checkpoint(dt, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_state)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _corruption_result(mod, fault, chaos_mod, d, mode):
    before = open(os.path.join(d, "step_5", "arrays.npz"), "rb").read()
    victim = chaos_mod.corrupt_checkpoint(d, mode,
                                          rng=np.random.default_rng(11))
    npz = os.path.join(d, "step_5", "arrays.npz")
    after = open(npz, "rb").read() if os.path.exists(npz) else b""
    flipped = [i for i in range(min(len(before), len(after)))
               if before[i] != after[i]]
    staged = sorted(n for n in os.listdir(d) if n.startswith("tmp."))
    verdicts = [mod.verify_checkpoint(d, 5)]
    log = fault.FaultEventLog()
    best = mod.latest_valid_step(d, event_log=log)
    quarantined = sorted(n.rsplit(".", 1)[0] for n in os.listdir(d)
                         if n.startswith("corrupt."))
    events = [{k: v for k, v in e.items() if k not in ("t", "path")}
              for e in log.events]
    return (victim, flipped, len(after), staged, verdicts, best,
            quarantined, events)


@pytest.mark.parametrize("mode", T_chaos.CORRUPTION_MODES)
def test_corruption_modes_agree_across_packages(tmp_path, mlp_states, mode):
    """The same seeded generator corrupts the same step and byte of either
    package's directory; each package's verdict on both directories, the
    walk-back and the quarantine agree."""
    assert T_chaos.CORRUPTION_MODES == J_chaos.CORRUPTION_MODES
    dj, dt = _save_both(tmp_path, mlp_states)
    copies = {k: str(tmp_path / f"copy_{k}") for k in ("ref", "port")}
    shutil.copytree(dj, copies["ref"])
    shutil.copytree(dt, copies["port"])
    # each package corrupts and judges its own directory ...
    got = _corruption_result(T, T_fault, T_chaos, dt, mode)
    want = _corruption_result(J, J_fault, J_chaos, dj, mode)
    assert got == want
    victim, flipped, _, staged, verdicts, best, quarantined, events = got
    assert victim == 5
    assert len(flipped) == (mode == "bitflip")
    assert len(staged) == (mode == "orphan")
    assert (verdicts[0] == []) == (best == 5) == (mode == "orphan")
    assert quarantined == ([] if mode == "orphan" else ["corrupt.5"])
    # ... and the other's, after the same corruption
    assert _corruption_result(T, T_fault, J_chaos, copies["ref"], mode) \
        == _corruption_result(J, J_fault, T_chaos, copies["port"], mode) \
        == got
    if mode == "orphan":                 # the next save sweeps the orphan
        T.save_checkpoint(dt, 6, mlp_states[2])
        assert not [n for n in os.listdir(dt) if n.startswith("tmp.")]


@pytest.mark.parametrize("fname", ["arrays.npz", "meta.json"])
def test_any_byte_flip_fails_verification(tmp_path, mlp_states, fname):
    d = str(tmp_path)
    T.save_checkpoint(d, 20, mlp_states[2])
    path = os.path.join(d, "step_20", fname)
    orig = open(path, "rb").read()
    size = len(orig)
    for off in {0, 1, size // 3, size // 2, (2 * size) // 3, size - 1}:
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(bytes([orig[off] ^ 0xFF]))
        assert T.verify_checkpoint(d, 20) != [], off
        assert J.verify_checkpoint(d, 20) != [], off
        with open(path, "wb") as f:
            f.write(orig)
    assert T.verify_checkpoint(d, 20) == []


def test_crash_leftovers_are_swept_and_publish_is_nondestructive(
        tmp_path, mlp_states):
    d, state = str(tmp_path), mlp_states[2]
    T.save_checkpoint(d, 10, state, extra={"v": 1})
    stale = os.path.join(d, "tmp.20.deadbeef")
    os.makedirs(stale)
    with open(os.path.join(stale, "arrays.npz"), "w") as f:
        f.write("partial")
    T.save_checkpoint(d, 10, state, extra={"v": 2})
    assert not [n for n in os.listdir(d) if n.startswith("tmp.")]
    assert T.list_checkpoints(d) == [10]
    assert T.restore_checkpoint(d, state)[1] == {"v": 2}


def test_crash_mid_republish_is_recovered(tmp_path, mlp_states):
    """Step 10's copy moved aside and the re-save's payload stranded in
    staging: the read path republishes the fresh payload on its own, and
    the next save keeps it."""
    d, state = str(tmp_path), mlp_states[2]
    T.save_checkpoint(d, 10, state, extra={"v": "old"})
    T.save_checkpoint(d, 11, state, extra={"v": "new"})
    os.rename(os.path.join(d, "step_10"),
              os.path.join(d, "tmp.10.aaaa1111.displaced"))
    os.rename(os.path.join(d, "step_11"), os.path.join(d, "tmp.10.aaaa1111"))
    assert T.list_checkpoints(d) == []
    assert T.latest_step(d) == 10
    T.save_checkpoint(d, 20, state, extra={"v": 3})
    assert T.list_checkpoints(d) == [10, 20]
    assert not [n for n in os.listdir(d) if n.startswith("tmp.")]
    assert T.restore_checkpoint(d, state, step=10)[1] == {"v": "new"}


def test_keep_n_spares_quarantined_dirs(tmp_path, mlp_states):
    d, state = str(tmp_path), mlp_states[2]
    T.save_checkpoint(d, 10, state)
    T_chaos.corrupt_checkpoint(d, "bitflip", step=10)
    assert T.latest_valid_step(d) is None
    for s in (20, 30, 40, 50):
        T.save_checkpoint(d, s, state, keep=3)
    assert T.list_checkpoints(d) == [30, 40, 50]
    assert [n for n in os.listdir(d) if n.startswith("corrupt.10.")]


def test_structure_mismatch_raises_before_touching(tmp_path, mlp_states):
    _, jnp_state, tstate = mlp_states
    d = str(tmp_path)
    T.save_checkpoint(d, 5, tstate)
    flat = [t for _, t in _leaves(_fresh_like(jnp_state))]
    with pytest.raises(ValueError, match="treedef"):    # same leaf count
        T.restore_checkpoint(d, {f"k{i:02d}": t for i, t in enumerate(flat)},
                             step=5)
    like = _fresh_like(jnp_state)
    like["opt"]["mu"]["head.w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="a2 is"):      # same treedef
        T.restore_checkpoint(d, like, step=5)
    assert all(not t.any() for _, t in _leaves(like))
    like["opt"]["count"] = torch.zeros((), dtype=torch.float32)
    with pytest.raises(ValueError, match="structure mismatch"):
        T.restore_checkpoint(d, like, step=5, verify=False)


def test_explicit_corrupt_step_raises_and_is_quarantined(tmp_path,
                                                         mlp_states):
    d, state = str(tmp_path), mlp_states[2]
    for s in (10, 20):
        T.save_checkpoint(d, s, state)
    T_chaos.corrupt_checkpoint(d, "bitflip", step=20)
    log = T_fault.FaultEventLog()
    with pytest.raises(T.CheckpointCorruptError):
        T.restore_checkpoint(d, state, step=20, event_log=log)
    assert [n for n in os.listdir(d) if n.startswith("corrupt.20.")]
    assert T.latest_step(d) == 10 and log.kinds() == ["quarantine"]


def test_a_verified_step_is_copied_without_a_second_read(
        tmp_path, mlp_states, monkeypatch):
    """``latest_valid_step(keep=)`` hands over the arrays that its
    verification read (a corrupt newer step is quarantined and keeps
    nothing), and ``restore_checkpoint(verified=)`` copies exactly those:
    one hash of the step, no second read of its payload."""
    from repro_torch.train import checkpoint as T_ckpt
    d, state = str(tmp_path), mlp_states[2]
    for s in (5, 10):
        T.save_checkpoint(d, s, state)
    T_chaos.corrupt_checkpoint(d, "bitflip", step=10)
    kept, timings = {}, []
    assert T.latest_valid_step(d, timings=timings, keep=kept) == 5
    assert sorted(kept) == sorted(_meta(d, 5)["manifest"])

    def read_again(path):
        raise AssertionError(f"{path} read a second time")

    monkeypatch.setattr(T_ckpt, "_mapped_members", read_again)
    got, extra = T.restore_checkpoint(d, _fresh_like(mlp_states[1]),
                                      step=5, verified=kept,
                                      timings=timings)
    _assert_bitwise(got, state)
    assert [t["op"] for t in timings] == ["verify", "verify", "restore"]
    assert [t["ok"] for t in timings[:2]] == [False, True]


def test_a_bf16_leaf_is_refused_by_name(tmp_path):
    state = {"params": Params({"w": torch.ones(2, dtype=torch.bfloat16)}),
             "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match="params.w is torch.bfloat16"):
        T.save_checkpoint(str(tmp_path), 1, state)


def test_timings_go_to_the_callers_list(tmp_path, mlp_states):
    """Each save, verify and restore appends its times to the list it is
    given (a restore's own verify included), and to nothing else."""
    d, state = str(tmp_path), mlp_states[2]
    T.save_checkpoint(d, 5, state)
    timings = []
    T.save_checkpoint(d, 10, state, timings=timings)
    assert T.verify_checkpoint(d, 10, timings=timings) == []
    T.restore_checkpoint(d, state, step=10, timings=timings)
    T.restore_checkpoint(d, state, timings=timings)
    assert [t["op"] for t in timings] == ["save", "verify", "verify",
                                          "restore", "verify", "restore"]
    save = timings[0]
    assert save["bytes"] == os.path.getsize(
        os.path.join(d, "step_10", "arrays.npz"))
    assert save["s"] >= save["d2h_s"] + save["write_s"] + save["hash_s"] \
        + save["publish_s"] - 1e-9
    assert all(t["step"] == 10 and t["s"] >= 0 for t in timings)


def test_a_compressed_payload_is_unreadable(tmp_path, mlp_states):
    """Both packages write ``arrays.npz`` with ``np.savez`` (stored
    members).  A compressed payload, with digests made to match it, is
    reported unreadable, and a restore without verification refuses it."""
    import hashlib
    d, state = str(tmp_path), mlp_states[2]
    T.save_checkpoint(d, 5, state)
    npz = os.path.join(d, "step_5", "arrays.npz")
    with np.load(npz) as f:
        arrays = {k: f[k] for k in f.files}
    np.savez_compressed(npz, **arrays)
    meta_path = os.path.join(d, "step_5", "meta.json")
    meta = json.load(open(meta_path))
    meta["npz_sha256"] = hashlib.sha256(open(npz, "rb").read()).hexdigest()
    core = {k: v for k, v in meta.items() if k != "meta_sha256"}
    meta["meta_sha256"] = hashlib.sha256(
        json.dumps(core, sort_keys=True).encode()).hexdigest()
    json.dump(meta, open(meta_path, "w"))
    (problem,) = T.verify_checkpoint(d, 5)
    assert problem.startswith("step_5: arrays.npz unreadable (member a")
    with pytest.raises(ValueError, match="not a stored .npy array"):
        T.restore_checkpoint(d, state, step=5, verify=False)


def test_flatten_order_and_treedef_match_jax():
    """List indices compare as ints (``layers.2`` before ``layers.10``),
    dict keys as strings, at every level; the treedef string is
    ``jax.tree_util``'s for the same nested dicts and lists."""
    rng = np.random.default_rng(0)
    jtree = {"layers": [{"w": rng.standard_normal(2).astype(np.float32),
                         "b": np.float32(i)} for i in range(11)],
             "embed": {"table": np.zeros((3, 2), np.float32)},
             "step": np.int32(4)}
    params = Params({"layers": [{"w": torch.from_numpy(d["w"]),
                                 "b": torch.tensor(d["b"])}
                                for d in jtree["layers"]],
                     "embed": {"table": torch.zeros(3, 2)}})
    flat_names = dict(params.named_parameters())
    port = {"params": params, "mu": flat_names,
            "decay": {k: True for k in flat_names},
            "step": torch.tensor(4, dtype=torch.int32)}
    ref = {"params": {k: v for k, v in jtree.items() if k != "step"},
           "mu": {k: v for k, v in jtree.items() if k != "step"},
           "step": jtree["step"]}
    sig = T.tree_signature(port)
    assert sig["treedef"] == str(jax.tree_util.tree_structure(ref))
    got = [t.numpy() for _, t in _leaves(port)]
    want = jax.tree.leaves(ref)
    assert len(got) == len(want) == len(sig["leaves"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    paths = [p for p, _ in _leaves(port)]
    assert paths.index(("params", "layers", 2, "w")) < \
        paths.index(("params", "layers", 10, "w"))


# ---------------------------------------------------------------------------
# the driver's recovery loop at smoke size
# ---------------------------------------------------------------------------

def _drv(ckpt_dir=None, *extra, steps=24, batch=2, seq=8):
    return LT.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", str(steps), "--batch",
         str(batch), "--seq", str(seq), "--ckpt-every", "6",
         "--log-every", "100", "--backoff-base", "0.0"]
        + (["--ckpt-dir", ckpt_dir] if ckpt_dir else []) + list(extra))


def test_smoke_chaos_run_ends_bitwise_equal_to_clean(tmp_path):
    """A 5-step NaN burst (a rollback), a flipped byte in the newest
    checkpoint and a preemption (a restart that quarantines it and walks
    back): the state ends bit for bit the clean run's."""
    clean = LT.train(_drv(str(tmp_path / "clean")))
    chaos = T_chaos.ChaosSchedule.parse(
        "nan@13+5;corrupt@17:bitflip;preempt@18")
    d = str(tmp_path / "chaos")
    state = LT.train(_drv(d), chaos=chaos)
    _assert_bitwise(state, clean)
    assert chaos.remaining() == ()
    assert [n for n in os.listdir(d) if n.startswith("corrupt.18.")]
    assert T.verify_checkpoint(d, 24) == []
    kinds = [json.loads(line)["kind"]
             for line in open(os.path.join(d, "events.jsonl"))]
    assert kinds.count("skip") == 5
    assert {"rollback", "quarantine", "restart"} <= set(kinds)
    assert kinds.index("rollback") < kinds.index("restart")


@pytest.mark.parametrize("with_dir", [True, False])
def test_rollback_without_a_checkpoint_restarts_fresh(tmp_path, with_dir):
    args = _drv(str(tmp_path / "ck") if with_dir else None, "--ckpt-every",
                "100", steps=7)
    log = T_fault.FaultEventLog()
    state = LT.train(args, event_log=log,
                     chaos=T_chaos.ChaosSchedule.parse("nan@1+5"))
    assert int(state["step"]) == 7 and int(state["opt"]["count"]) == 7
    # (a noisy host may add slow_step events; the recovery trail is fixed)
    assert [k for k in log.kinds() if k != "slow_step"] == \
        ["skip"] * 5 + ["rollback", "resume_fallback_fresh"]


def test_a_slow_step_is_flagged():
    """The step clock starts before ``pre_step`` sleeps."""
    log = T_fault.FaultEventLog()
    seen = []
    LT.train(_drv(None, steps=7), event_log=log,
             chaos=T_chaos.ChaosSchedule.parse("slow@6:1.0"),
             on_step=lambda s, st, m, dt: seen.append(dt))
    assert 6 in [e["step"] for e in log.events if e["kind"] == "slow_step"]
    assert seen[6] >= 1.0


def test_resume_after_a_process_death_is_bitwise(tmp_path):
    """Six straight steps equal three steps, a death right after the step-3
    save, and a new ``train`` call that resumes from the directory."""
    straight = LT.train(_drv(None, steps=6))
    d = str(tmp_path)
    args = _drv(d, "--ckpt-every", "3", "--max-restarts", "0", steps=6)
    with pytest.raises(T.ChaosPreemption):
        LT.train(args, chaos=T_chaos.ChaosSchedule.parse("preempt@2"))
    assert T.list_checkpoints(d) == [3]
    seen = []
    resumed = LT.train(args, on_step=lambda s, *_: seen.append(s))
    assert seen == [3, 4, 5]
    _assert_bitwise(resumed, straight)


# ---------------------------------------------------------------------------
# the elastic restart, 4 -> 2 shards at N = 256
# ---------------------------------------------------------------------------

EL_N, EL_L, EL_B, EL_STEPS, EL_EVERY = 256, 12, 8, 12, 3


def _el_cfg(shards):
    return T_spm.SPMConfig(n=EL_N, n_stages=EL_L, schedule="two_level",
                           n_shards=shards, schedule_shards=4,
                           backward="custom")


def _el_batch(step):
    rng = np.random.default_rng([0, step])
    return {k: torch.from_numpy(rng.standard_normal((EL_B, EL_N))
                                .astype(np.float32)) for k in ("x", "y")}


def _el_forward(params, x, shards):
    with activation_sharding(make_feature_mesh(shards, device="cpu"),
                             shard_feature=True):
        return T_spm.spm_apply(params, x, _el_cfg(shards))


def _el_loss(params, batch, shards):
    loss = torch.mean((_el_forward(params, batch["x"], shards)
                       - batch["y"]) ** 2)
    return loss, {"loss": loss}


def _el_fresh():
    return T.make_train_state(T_spm.init_spm(
        _el_cfg(4), torch.Generator().manual_seed(0), torch.device("cpu")))


def _el_run(ckpt_dir, shards, chaos=None, event_log=None, until=EL_STEPS):
    """The SPM regression job under the sharded executor with the
    driver's wiring: rollback to the newest valid checkpoint, verified
    restore into a fresh state, saves with the cursor, chaos hooks, and
    ``run_with_recovery`` with no restart budget (a preemption kills it)."""
    event_log = event_log or T.FaultEventLog()
    step_fn = T.make_train_step(
        lambda p, b: _el_loss(p, b, shards),
        OptimizerConfig(lr=1e-2, total_steps=EL_STEPS), chaos_guard=True)

    def try_restore():
        state = _el_fresh()
        step = T.latest_valid_step(ckpt_dir, event_log=event_log)
        if step is None:
            return state, 0
        state, extra = T.restore_checkpoint(ckpt_dir, state, step=step,
                                            event_log=event_log)
        return state, int(extra["cursor"]["step"])

    def loop(resume):
        state, s = try_restore()
        policy = T.FaultPolicy(max_consecutive_skips=2)
        while s < until:
            poison = chaos.poison(s) if chaos else 0.0
            state, metrics = step_fn(state, _el_batch(s), poison)
            if policy.on_metrics({"skipped": float(metrics["skipped"])}):
                event_log.emit("rollback", step=s)
                state, s = try_restore()
                policy.reset()
                continue
            s += 1
            if s % EL_EVERY == 0:
                T.save_checkpoint(ckpt_dir, s, state,
                                  extra={"cursor": {"seed": 0, "step": s}})
            if chaos:
                chaos.post_step(s - 1, ckpt_dir, event_log=event_log)
        return state

    return T.run_with_recovery(loop, max_restarts=0, event_log=event_log,
                               sleep=lambda _: None)


@pytest.fixture(scope="module")
def elastic_clean(tmp_path_factory):
    """The fault-free run: 4-way for steps 0-5, 2-way from step_6."""
    d = str(tmp_path_factory.mktemp("elastic_clean"))
    _el_run(d, 4, until=6)
    return d, _el_run(d, 2)


def test_elastic_restart_resumes_bitwise(tmp_path, elastic_clean):
    """Life 1 (4-way): a 2-step NaN burst rolls back to step_3, step_9 is
    truncated, a preemption with no restart budget kills it.  Life 2
    (2-way) quarantines step_9, walks back to step_6 and runs to the end:
    bit for bit the fault-free run."""
    d = str(tmp_path)
    log = T.FaultEventLog(os.path.join(d, "events.jsonl"))
    chaos = T_chaos.ChaosSchedule.parse("nan@4+2;corrupt@8:truncate;"
                                        "preempt@9")
    with pytest.raises(T.ChaosPreemption):
        _el_run(d, 4, chaos=chaos, event_log=log)
    assert chaos.remaining() == ()
    state = _el_run(d, 2, event_log=log)
    _assert_bitwise(state, elastic_clean[1])
    assert [n for n in os.listdir(d) if n.startswith("corrupt.9.")]
    assert T.verify_checkpoint(d, EL_STEPS) == []
    assert log.kinds() == ["rollback", "chaos_corrupt", "chaos_preempt",
                           "restart_budget_exhausted", "quarantine"]


def _gamma(k):
    u = EPS32 / 2
    return k * u / (1 - k * u)


def test_one_step_across_widths_within_gamma_rows(elastic_clean):
    """step_6 restored and differentiated on 4 shards and on 2: every
    grad within gamma_rows of the sum of its terms' magnitudes (the grads
    of the same operator on absolute values of every input, which bound
    the terms of each sum)."""
    d, _ = elastic_clean
    batch = _el_batch(6)
    grads = {}
    for shards in (4, 2):
        state, _ = T.restore_checkpoint(d, _el_fresh(), step=6)
        loss, _ = _el_loss(state["params"], batch, shards)
        names = [k for k, _ in state["params"].named_parameters()]
        grads[shards] = dict(zip(names, torch.autograd.grad(
            loss, list(state["params"].parameters()))))
    p = state["params"]
    with torch.no_grad():
        y = _el_forward(p, batch["x"], 4)
        gy = 2 * (y - batch["y"]) / y.numel()
    absp = Params({k: v.detach().abs() for k, v in p.named_parameters()})
    absp.trainable()
    mags = dict(zip(grads[4], torch.autograd.grad(
        _el_forward(absp, batch["x"].abs(), 4), list(absp.parameters()),
        gy.abs())))
    for k, g4 in grads[4].items():
        lim = _gamma(EL_B) * mags[k]
        assert bool(((g4 - grads[2][k]).abs() <= lim).all()), k
        assert bool(torch.isfinite(g4).all()) and bool(g4.any()), k


# ---------------------------------------------------------------------------
# the reference's whole train state carried over
# ---------------------------------------------------------------------------

def _model_depth(cfg) -> int:
    """Dependent f32 roundings of the smoke model's forward, as
    ``tests/test_torch_train.py`` counts them."""
    L_attn, L_ffn = 6, 7
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    return cfg.n_layers * per_layer + 2 * cfg.d_model


def test_state_from_jax_carries_a_trained_state():
    """Two reference steps (stacked layers) on numpy batches; the
    port's copy holds the moments unstacked, the count and the step
    exactly, and a third step in each package agrees within the bound of
    ``tests/test_torch_train.py``: loss and grad norm relative, the params'
    difference against the update's size."""
    jcfg = j_get_smoke("qwen3-1.7b")
    tcfg = get_smoke("qwen3-1.7b")
    assert jcfg.stacked_params
    # remat changes no value; without it the reference compiles faster
    jcfg = dataclasses.replace(jcfg, remat=False)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: J_T.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    jparams = jax.tree.map(lambda s: jnp.asarray(
        0.05 * rng.standard_normal(s.shape), s.dtype), shapes)
    opt = dict(lr=1e-2, total_steps=3, warmup_steps=1)
    jstep = jax.jit(J.make_train_step(
        lambda p, b: J_LM.lm_loss(p, b, jcfg), J_opt.OptimizerConfig(**opt),
        chaos_guard=True))
    batches = [{k: rng.integers(0, tcfg.vocab_size, (4, 16))
                for k in ("tokens", "labels")} for _ in range(3)]
    jstate = J.make_train_state(jparams)
    for b in batches[:2]:
        jstate, _ = jstep(jstate, {k: jnp.asarray(v, jnp.int32)
                                   for k, v in b.items()}, 0.0)
    jnp_state = jax.tree.map(np.asarray, jstate)
    tstate = state_from_jax(jnp_state, tcfg, device="cpu")
    assert int(tstate["step"]) == 2 == int(tstate["opt"]["count"])
    for name in ("mu", "nu"):
        want = {k: v.detach() for k, v in params_from_jax(
            jnp_state["opt"][name], tcfg, device="cpu").named_parameters()}
        assert want.keys() == tstate["opt"][name].keys()
        for k, v in want.items():
            assert torch.equal(tstate["opt"][name][k], v), (name, k)
        layer = jnp_state["opt"][name]["layers"]["l0"]["mlp"]["up"]["mix"]
        np.testing.assert_array_equal(
            tstate["opt"][name]["layers.1.mlp.up.mix"].numpy(), layer[1])
    p0 = {k: v.detach().clone()
          for k, v in tstate["params"].named_parameters()}
    tstep = T.make_train_step(lambda p, b: LM.lm_loss(p, b, tcfg),
                              OptimizerConfig(**opt), chaos_guard=True)
    tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                for k, v in batches[2].items()}, 0.0)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v, jnp.int32)
                                for k, v in batches[2].items()}, 0.0)
    rel = 8 * 2 * _model_depth(tcfg) * EPS32
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rel)
    ref = {k: v.detach() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tcfg,
        device="cpu").named_parameters()}
    got = dict(tstate["params"].named_parameters())
    diff = sum(float(((got[k].detach() - ref[k]) ** 2).sum())
               for k in ref) ** .5
    moved = sum(float(((ref[k] - p0[k]) ** 2).sum()) for k in ref) ** .5
    assert 0 < diff <= rel * moved
    assert int(tstate["step"]) == 3 == int(jstate["step"])
