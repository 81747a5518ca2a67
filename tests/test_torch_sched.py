"""The port's LSA scheduler (``repro_torch.sched``) and checkpoint manager
(``repro_torch.resilience.checkpoint``) against the JAX package's.

* ``LSAScheduler``/``EnergyModel`` on the cases of ``tests/test_sched.py``
  and on seeded random job sets: the same schedule log, misses, run
  counts and energy level as the reference's;
* ``CheckpointManager``: atomic versioned saves with garbage collection,
  torn writes skipped, dtype casts, restore onto a device, and each
  package restoring a checkpoint the other wrote with equal leaves.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.resilience.checkpoint import CheckpointManager as JCheckpointManager
from repro.sched.lsa import EnergyModel as JEnergy
from repro.sched.lsa import Job as JJob
from repro.sched.lsa import LSAScheduler as JLSA

from repro_torch.core.vm import vmstate as vms
from repro_torch.config import VMConfig
from repro_torch.resilience import CheckpointManager
from repro_torch.sched import EnergyModel, Job, LSAScheduler

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# LSA: the same decisions as the reference, step for step
# ---------------------------------------------------------------------------

def _run_both(energy, jobs, t_end, max_steps=100000):
    """Run one job set through both schedulers; ``jobs`` are Job kwargs
    (``fn`` omitted: each side records its own runs)."""
    out = []
    for job_cls, lsa_cls, energy_cls in ((Job, LSAScheduler, EnergyModel),
                                        (JJob, JLSA, JEnergy)):
        ran = []
        s = lsa_cls(energy_cls(*energy))
        for kw in jobs:
            s.add(job_cls(fn=(lambda name=kw["name"]: ran.append(name)), **kw))
        s.run_until(t_end, max_steps=max_steps)
        out.append((ran, s.log, s.miss_count(), s.energy.level, s.now,
                    [(j.name, j.runs, j.misses, j.deadline, j.arrival) for j in s.jobs]))
    return out


def mk(name, deadline, cost, dur, prio=1, period=None):
    return {"name": name, "priority": prio, "deadline": deadline, "e_cost": cost,
            "duration": dur, "period": period}


CASES = {
    "edf_zero_storage": ((100, 100, 0), [mk("late", 10, 1, 1), mk("soon", 2, 1, 1)], 20, 100000),
    "laziness_waits_for_refill": ((10, 0, 1.0), [mk("big", 30, 8, 1)], 40, 100000),
    "underprovisioned_misses": ((10, 0, 0.1), [mk("doomed", 5, 8, 1)], 20, 100000),
    "priority_breaks_ties": ((100, 100, 0), [mk("low", 10, 1, 1, prio=1),
                                             mk("high", 10, 1, 1, prio=9)], 20, 100000),
    "periodic_rearms": ((100, 100, 10), [mk("tick", 2, 1, 0.5, period=2)], 10.1, 200),
    "energy_conservation": ((5, 5, 0), [mk(f"j{i}", i + 1, 1, 0.1) for i in range(10)], 50,
                            100000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lsa_equals_reference(case):
    energy, jobs, t_end, max_steps = CASES[case]
    mine, ref = _run_both(energy, jobs, t_end, max_steps)
    assert mine == ref


def test_lsa_reference_properties_hold():
    """The reference tests' own assertions, on the port."""
    (ran, log, *_), _ = _run_both(*CASES["edf_zero_storage"])
    assert ran == ["soon", "late"]
    (ran, log, *_), _ = _run_both(*CASES["laziness_waits_for_refill"])
    assert ran == ["big"] and log[0][0] >= 8 - 1e-6
    (_, _, misses, *_), _ = _run_both(*CASES["underprovisioned_misses"])
    assert misses >= 1
    (ran, *_), _ = _run_both(*CASES["priority_breaks_ties"])
    assert ran[0] == "high"
    (ran, *_), _ = _run_both(*CASES["periodic_rearms"])
    assert len(ran) >= 4
    (_, log, _, level, *_), _ = _run_both(*CASES["energy_conservation"])
    assert sum(1 for *_, did_run in log if did_run) == 5 and level >= -1e-9


@pytest.mark.parametrize("seed", range(6))
def test_lsa_random_job_sets_equal_reference(seed):
    rng = np.random.default_rng(seed)
    jobs = []
    for k in range(int(rng.integers(3, 12))):
        dur = float(rng.uniform(0.05, 2.0))
        jobs.append(mk(f"j{k}", float(rng.uniform(dur, 40.0)), float(rng.uniform(0.0, 6.0)), dur,
                       prio=int(rng.integers(0, 5)),
                       period=float(rng.uniform(2.0, 10.0)) if rng.random() < 0.3 else None))
        jobs[-1]["arrival"] = float(rng.uniform(0.0, 10.0))
    energy = (float(rng.uniform(1, 20)), float(rng.uniform(0, 10)),
              float(rng.choice([0.0, rng.uniform(0.1, 3.0)])))
    mine, ref = _run_both(energy, jobs, 60.0, max_steps=3000)
    assert mine == ref


def test_energy_model_equals_reference():
    e, je = EnergyModel(10, 3, 0.5), JEnergy(10, 3, 0.5)
    for dt, cost in ((1.0, 2.0), (0.0, 5.0), (30.0, 9.5), (0.2, 0.7), (0.0, 0.4)):
        e.advance(dt)
        je.advance(dt)
        assert e.drain(cost) == je.drain(cost)
        assert e.level == je.level


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def test_checkpoint_atomic_versioned(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(10), "b": {"c": torch.ones(3, 3)}}
    cm.save(1, tree)
    cm.save(2, {"a": tree["a"] + 1, "b": {"c": tree["b"]["c"] + 1}})
    cm.save(3, {"a": tree["a"] + 2, "b": {"c": tree["b"]["c"] + 2}}, extra={"note": "x"})
    assert cm.latest_step() == 3
    assert not (tmp_path / "ckpt_0000000001").exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_0000000002", "ckpt_0000000003"]
    out, extra = cm.restore(tree, step=3)
    assert int(out["a"][1]) == 3 and extra == {"note": "x"}
    assert torch.equal(out["b"]["c"], torch.full((3, 3), 3.0))
    out2, _ = cm.restore(tree, step=2)
    assert int(out2["a"][0]) == 1


def test_checkpoint_incomplete_skipped(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(5, {"x": torch.zeros(3)})
    (tmp_path / "ckpt_0000000009").mkdir()             # a torn write: no meta.json
    assert cm.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"x": torch.zeros(3)})


def test_checkpoint_background_save_and_casts(tmp_path):
    cm = CheckpointManager(tmp_path)
    x = torch.ones(4, dtype=torch.float32)
    cm.save(1, {"x": x, "n": np.int32(7), "k": 3}, blocking=False)
    x.add_(5)                                            # the snapshot was taken before
    cm.wait()
    out, _ = cm.restore({"x": torch.zeros(4, dtype=torch.bfloat16), "n": np.int64(0), "k": 0},
                        device="cpu")
    assert out["x"].dtype == torch.bfloat16 and torch.equal(out["x"].float(), torch.ones(4))
    assert out["n"].dtype == np.int64 and int(out["n"]) == 7 and int(out["k"]) == 3


def _vm_state_tree(seed):
    """A VMState of numpy arrays with random contents (the reference's
    dtypes) under a dict, plus a numpy leaf."""
    st = vms.to_reference(vms.init_state(VMConfig(cs_size=256, mem_size=64), seed=seed))
    rng = np.random.default_rng(seed)
    st = st._replace(cs=rng.integers(-2 ** 31, 2 ** 31, 256).astype(np.int32),
                     mem=rng.integers(-100, 100, 64).astype(np.int32))
    return {"vm": st, "tag": np.int32(seed), "w": rng.standard_normal((3, 5)).astype(np.float32)}


def _leaves(tree):
    st = tree["vm"]
    return {**{f"vm/{f}": np.asarray(getattr(st, f)) for f in st._fields},
            "tag": np.asarray(tree["tag"]), "w": np.asarray(tree["w"])}


def test_port_restores_reference_checkpoint(tmp_path):
    tree = _vm_state_tree(3)
    jtree = {"vm": type(tree["vm"])(*[jnp.asarray(np.array(x)) for x in tree["vm"]]),
             "tag": jnp.int32(3), "w": jnp.asarray(np.array(tree["w"]))}
    from repro.core.vm.vmstate import VMState as JVMState

    jtree["vm"] = JVMState(*jtree["vm"])
    JCheckpointManager(tmp_path).save(4, jtree, extra={"by": "jax"})
    template = {"vm": vms.from_reference(tree["vm"], "cpu"), "tag": np.int32(0),
                "w": torch.zeros(3, 5)}
    cm = CheckpointManager(tmp_path)
    assert cm.latest_step() == 4
    out, extra = cm.restore(template)
    assert extra == {"by": "jax"}
    got = {"vm": vms.to_reference(out["vm"]), "tag": out["tag"], "w": out["w"].numpy()}
    want = _leaves(tree)
    for name, a in _leaves(got).items():
        assert np.array_equal(a.astype(want[name].dtype), want[name]), name


def test_reference_restores_port_checkpoint(tmp_path):
    tree = _vm_state_tree(5)
    ptree = {"vm": vms.from_reference(tree["vm"], "cpu"), "tag": np.int32(5),
             "w": torch.from_numpy(np.array(tree["w"]))}
    CheckpointManager(tmp_path, keep=1).save(7, ptree, extra={"by": "torch"})
    from repro.core.vm.vmstate import VMState as JVMState

    template = {"vm": JVMState(*[jnp.zeros_like(np.array(x)) for x in tree["vm"]]),
                "tag": jnp.int32(0), "w": jnp.zeros((3, 5), jnp.float32)}
    jcm = JCheckpointManager(tmp_path)
    assert jcm.latest_step() == 7
    out, extra = jcm.restore(template)
    assert extra == {"by": "torch"}
    got = {"vm": type(tree["vm"])(*[np.asarray(x) for x in out["vm"]]),
           "tag": np.asarray(out["tag"]), "w": np.asarray(out["w"])}
    want = _leaves(tree)
    for name, a in _leaves(got).items():
        assert np.array_equal(a.astype(want[name].dtype), want[name]), name
