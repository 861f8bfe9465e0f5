"""The port's ``ServingActuator`` against ``ClusterSim`` and against the
JAX ``ServingActuator``.

The first five tests are ``tests/test_actuator_parity.py`` run on the
port's copies: the serving actuator and the simulator, driven through the
same decision script, report identical ledger views step for step.  The
rest feed one call sequence (``reconfigure``, ``move``,
``set_io_throttle``, ``set_mps_quota``, ``free_slots``,
``headroom_units``) to the port's and the JAX actuator over live engines
of either backend, on the same ledger and rng seed, and then let the
port's and the JAX controller drive them through the same breaching
snapshots: pauses, compute scales, ledger views, fabric bandwidths,
engine quotas and the controllers' decisions must be identical."""
import dataclasses
import importlib
import json
import types

import numpy as np
import pytest

from repro_torch.core.ledger import DeviceLedger, LedgerError
from repro_torch.core.profiles import A100_MIG
from repro_torch.core.tenancy import TenantRegistry
from repro_torch.core.topology import make_p4d_cluster
from repro_torch.serving.actuator import FabricState, ServingActuator
from repro_torch.sim.cluster import ClusterSim
from repro_torch.sim.params import SimParams


class _FakeEngine:
    """Quota-bearing stand-in: the parity script never steps an engine."""

    def __init__(self):
        self.quota = 1.0

    def set_quota(self, q):
        self.quota = q


def make_pair(n_tenants=2, replicas=2):
    """One ClusterSim and one ServingActuator over the same registry,
    topology and ledger parameters."""
    reg = TenantRegistry.slo_fleet(n_tenants, replicas)
    specs = tuple(reg)
    p = SimParams(duration_s=60.0, schedule=(), tenants=specs)
    sim = ClusterSim(p)

    topo = make_p4d_cluster(2)
    reg2 = TenantRegistry(specs)
    ledger = DeviceLedger.from_registry(
        topo, reg2, A100_MIG, home_devices=p.home_devices,
        ambient_units=p.ambient_units)
    engines = {s.name: [_FakeEngine() for _ in range(replicas)]
               for s in reg2.latency()}
    act = ServingActuator(engines, FabricState(), topo, lambda: 0.0,
                          ledger=ledger, rng=np.random.default_rng(0))
    return sim, act


def assert_parity(sim, act):
    assert sim.ledger.view() == act.ledger.view()
    assert [s.key for s in sim.free_slots()] == \
        [s.key for s in act.free_slots()]
    for dev in sim.topo.devices():
        assert sim.headroom_units(dev) == act.headroom_units(dev)


def decision_script(sim):
    """A controller-shaped action sequence, chosen against the (shared)
    ledger state so it is identical for both actuators."""
    lat = list(sim.lat)
    first, second = lat[0], lat[1]
    cur_dev = sim.ledger.slots_of(second)[0].device
    target = next(s for s in sim.free_slots()
                  if s.device != cur_dev
                  and sim.headroom_units(s.device) >= 2)
    back = sim.ledger.slots_of(second)[0]
    return [
        ("reconfigure", first, A100_MIG["3g.40gb"]),
        ("throttle", "ETL", 3e8),
        ("move", second, target),
        ("reconfigure", second, A100_MIG["4g.40gb"]),
        ("reconfigure", first, A100_MIG["2g.20gb"]),   # relax path
        ("throttle", "ETL", None),
        ("reconfigure", second, A100_MIG["2g.20gb"]),
        ("move", second, back),
    ]


def apply(actuator, step):
    kind, tenant, arg = step
    if kind == "reconfigure":
        actuator.reconfigure(tenant, arg)
    elif kind == "move":
        actuator.move(tenant, arg)
    elif kind == "throttle":
        actuator.set_io_throttle(tenant, arg)


def test_ledger_views_identical_step_for_step():
    sim, act = make_pair()
    assert_parity(sim, act)                   # identical starting state
    for step in decision_script(sim):
        apply(sim, step)
        apply(act, step)
        assert_parity(sim, act)
    sim.ledger.check()
    act.ledger.check()


def test_parity_holds_across_fleet_shapes():
    for n, r in ((2, 1), (4, 2)):
        sim, act = make_pair(n, r)
        assert_parity(sim, act)
        first = next(iter(sim.lat))
        apply(sim, ("reconfigure", first, A100_MIG["4g.40gb"]))
        apply(act, ("reconfigure", first, A100_MIG["4g.40gb"]))
        assert_parity(sim, act)


def test_budget_checked_reconfigure_raises_identically():
    """An oversubscribing resize must be refused by BOTH ledgers."""
    sim, act = make_pair(2, 2)
    first = next(iter(sim.lat))
    dev = sim.ledger.slots_of(first)[0].device
    assert sim.ledger.used_units(dev) > sim.ledger._profile_units(
        A100_MIG, first)
    with pytest.raises(LedgerError):
        sim.reconfigure(first, A100_MIG["7g.80gb"])
    with pytest.raises(LedgerError):
        act.reconfigure(first, A100_MIG["7g.80gb"])
    assert_parity(sim, act)


def test_reconfig_pauses_vary_and_reseed_reproducibly():
    def pauses(seed):
        sim, act = make_pair()
        act.rng = np.random.default_rng(seed)
        first = next(iter(act.engines))
        return [act.reconfigure(first, A100_MIG[prof])
                for prof in ("3g.40gb", "4g.40gb", "3g.40gb", "2g.20gb")]

    a = pauses(7)
    assert len(set(a)) > 1                    # not the frozen constant
    assert a == pauses(7)                     # seeded: reproducible
    assert a != pauses(8)
    assert all(p >= 8.0 for p in a)


def test_io_throttle_is_per_tenant():
    fabric = FabricState(t2_active=True)
    fabric.set_on_root("T1", True)
    choked = fabric.bandwidth("T1")
    # throttling an unrelated tenant must NOT relieve the ETL stream
    fabric.set_io_throttle("TRAIN", 1e8)
    assert fabric.bandwidth("T1") == choked
    assert fabric.io_throttle_of("TRAIN") == 1e8
    assert fabric.io_throttle_of("T2") is None
    fabric.set_io_throttle("T2", 1e8)
    assert fabric.bandwidth("T1") > choked
    assert fabric.io_throttle == 1e8          # legacy view = T2's cap
    fabric.set_io_throttle("T2", None)
    assert fabric.bandwidth("T1") == choked
    assert fabric.io_throttle_of("TRAIN") == 1e8   # untouched


# ------------------------------------- the port's actuator against JAX's
NAMES = ("L0", "L1")


def _pkg(root):
    mods = ("configs.base", "core.controller", "core.ledger",
            "core.policy", "core.profiles", "core.signals", "core.tenancy",
            "core.topology", "serving.actuator", "serving.engine")
    ns = types.SimpleNamespace(root=root)
    for m in mods:
        setattr(ns, m.split(".")[1], importlib.import_module(f"{root}.{m}"))
    return ns


def _fleet(pkg, backend, seed=3):
    """serve()'s fleet: 2 latency tenants x 2 replicas spread breadth-first
    over the p4d testbed, the ETL (T2) and trainer (T3) background
    tenants, the shared ledger, interference on, one actuator."""
    cfg = pkg.base.reduced(pkg.base.get_config("stablelm_3b"))
    kw = {"device": "cpu"} if pkg.root == "repro_torch" else {}
    engines = {n: [pkg.engine.ServingEngine(cfg, max_slots=4, seq_cap=64,
                                            backend=backend, **kw)
                   for _ in range(2)] for n in NAMES}
    topo = pkg.topology.make_p4d_cluster(2)
    fabric = pkg.actuator.FabricState(t2_active=True)
    reserved = {("h0:g1", 0), ("h0:g0", 1)}
    free = [pkg.topology.Slot(int(d[1]), d, i) for i in range(2)
            for d in (f"h{h}:g{g}" for h in range(2) for g in range(8))
            if (d, i) not in reserved]
    reg = pkg.tenancy.TenantRegistry()
    placements = {}
    for i, n in enumerate(NAMES):
        placements[n] = free[2 * i:2 * i + 2]
        reg.add(pkg.tenancy.TenantSpec(
            name=n, replicas=2, rate=4.0, slo_s=0.2, priority=1 + 0.25 * i,
            placement=tuple(s.key for s in placements[n])))
    reg.add(pkg.tenancy.TenantSpec(
        name="T2", role=pkg.tenancy.BACKGROUND, profile="7g.80gb", units=0,
        pcie_demand=fabric.t2_demand, ps_weight=fabric.t2_ps_weight,
        placement=("h0:g1:s0",)))
    reg.add(pkg.tenancy.TenantSpec(
        name="T3", role=pkg.tenancy.BACKGROUND, profile="2g.20gb", units=2,
        sm_util=0.95, placement=("h0:g0:s1",)))
    ledger = pkg.ledger.DeviceLedger.from_registry(
        topo, reg, pkg.profiles.A100_MIG, home_devices=("h0:g0",),
        ambient_units=3)
    for n in NAMES:
        fabric.set_on_root(n, any(topo.root_of(s.device) == "h0:r0"
                                  for s in placements[n]))
    clock = [0.0]
    act = pkg.actuator.ServingActuator(
        engines, fabric, topo, lambda: clock[0], ledger=ledger,
        rng=np.random.default_rng(seed))
    return types.SimpleNamespace(act=act, topo=topo, reg=reg, clock=clock,
                                 placements=placements, pkg=pkg)


def _budget(eng):
    sched = eng.runtime.sched.budget if eng.runtime is not None else None
    return eng.quota, eng.active_slot_budget, sched


def _state(f):
    a = f.act
    return {
        "pauses": dict(a.pauses), "scales": dict(a.compute_scales),
        "reconfigs": list(a.reconfigs), "ledger": a.ledger.view(),
        "bandwidth": {n: a.fabric.bandwidth(n) for n in NAMES},
        "throttles": dict(a.fabric.io_throttles),
        "budgets": {n: [_budget(e) for e in a.engines[n]] for n in NAMES},
        "kv": {n: a.kv_pressure(n) for n in NAMES},
    }


def _call_sequence(f):
    """Each actuator call once or more, with what it returned."""
    a, lattice = f.act, f.pkg.profiles.A100_MIG
    out = []
    out.append(a.reconfigure("L0", lattice["3g.40gb"]))
    f.clock[0] = 3.0
    target = next(s for s in a.free_slots()
                  if f.topo.root_of(s.device) != "h0:r0"
                  and a.headroom_units(s.device) >= 2)
    out.append(a.move("L0", target))
    out.append(a.set_io_throttle("T2", 3e8))
    out.append(a.set_mps_quota("L1", 0.3))     # floored at 0.5
    out.append(a.set_mps_quota("L0", 0.8))
    out.append([s.key for s in a.free_slots()])
    out.append([a.headroom_units(d) for d in f.topo.devices()])
    f.clock[0] = 30.0
    out.append(a.reconfigure("L1", lattice["4g.40gb"]))
    out.append(a.set_io_throttle("T2", None))
    out.append(a.set_mps_quota("L1", 1.0))
    out.append(a.reconfigure("L0", lattice["2g.20gb"]))
    out.append([s.key for s in a.free_slots()])
    return out


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_call_sequence_matches_the_jax_actuator(backend):
    jax_f = _fleet(_pkg("repro"), backend)
    port_f = _fleet(_pkg("repro_torch"), backend)
    assert _state(port_f) == _state(jax_f)
    jax_out, port_out = _call_sequence(jax_f), _call_sequence(port_f)
    assert port_out == jax_out
    assert _state(port_f) == _state(jax_f)
    # the calls landed: paused, rescaled, moved off the hot root, quotas
    st = _state(port_f)
    assert st["pauses"]["L0"] > 30.0 and st["scales"]["L1"] < 1.0
    assert not port_f.act.fabric.shared_tenants["L0"]
    assert [b[0] for b in st["budgets"]["L0"]] == [0.8, 0.8]
    if backend == "paged":
        assert st["budgets"]["L0"][0][2] == 4       # ceil(0.8 * 4) lanes
    port_f.act.ledger.check()


def _snapshots(sig):
    """30 one-second samples: L0 breaches its 200 ms SLO from t=1 to
    t=12, then recovers; L1 stays well inside it."""
    out = []
    for t in range(1, 31):
        p0 = 0.45 if t <= 12 else 0.05
        tenants = {"L0": sig.TenantSignals(p99=p0, miss_rate=0.5 * (t <= 12),
                                           rps=1.0, ttft_p99=p0),
                   "L1": sig.TenantSignals(p99=0.05, miss_rate=0.0, rps=1.0,
                                           ttft_p99=0.05)}
        sys_sig = sig.SystemSignals()
        for root in ("h0:r0", "h0:r1", "h0:r2", "h0:r3", "h1:r0", "h1:r1",
                     "h1:r2", "h1:r3"):
            sys_sig.pcie_bytes[root] = 20e9 if root == "h0:r0" else 1e9
        out.append(sig.Snapshot(float(t), tenants, sys_sig))
    return out


def _drive_controller(f):
    pkg = f.pkg
    ctl = pkg.controller.Controller(
        f.topo, pkg.profiles.A100_MIG, f.act,
        pkg.controller.ControllerConfig(policy=pkg.policy.PolicyConfig(
            tau_s=0.200, persistence=2, dwell_obs=20, cooldown_obs=10)))
    ctl.register_registry(f.reg, placements={
        **f.placements, "T2": [pkg.topology.Slot(0, "h0:g1", 0)],
        "T3": [pkg.topology.Slot(0, "h0:g0", 1)]})
    states = []
    for snap in _snapshots(pkg.signals):
        f.clock[0] = snap.time
        ctl.on_snapshot(snap)
        states.append(_state(f))
    decisions = [json.dumps(dataclasses.asdict(d), default=str,
                            sort_keys=True) for d in ctl.audit.decisions]
    return decisions, ctl.audit.counts(), ctl.arbiter.max_used(), states


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_controller_drives_both_actuators_alike(backend):
    jax_run = _drive_controller(_fleet(_pkg("repro"), backend, seed=1))
    port_run = _drive_controller(_fleet(_pkg("repro_torch"), backend,
                                        seed=1))
    decisions, counts, max_units, states = port_run
    assert counts and sum(counts.values()) >= 1     # the controller acted
    assert max_units <= 7
    assert port_run == jax_run


def test_single_engine_wraps_as_t1_and_migration_is_refused():
    """(The name predates the port of ``migrate``, which no longer
    raises.)  A bare engine wraps as tenant T1; migrating off a dense replica
    ships no page (the dense slot cache holds no page chains), so every
    resident request comes back cold for the caller to redrive, priced at
    the planner's setup time."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    eng = ServingEngine(reduced(get_config("stablelm_3b")), max_slots=4,
                        seq_cap=64, device="cpu")
    act = ServingActuator(eng, FabricState(), make_p4d_cluster(2),
                          lambda: 0.0)
    assert list(act.engines) == ["T1"] and act.engine is eng
    assert [s.key for s in act.ledger.slots_of("T1")] == ["h0:g0:s0"]
    act.set_mps_quota("T1", 0.25)
    assert eng.quota == 0.5 and eng.active_slot_budget == 2
    eng.set_quota(0.01)
    assert eng.quota == 0.1 and eng.active_slot_budget == 1
    req = Request(req_id=0, tenant="T1", prompt_len=9, max_new_tokens=4,
                  arrival=0.0)
    assert eng.submit(req)
    eng.finalize_step(eng.step(), 0.01)
    assert act.migrate("T1", 0, 0) == pytest.approx(0.005)
    (rec,) = act.migrations
    assert rec["warm"] == [] and rec["cold"] == [req]
    assert rec["pages"] == rec["bytes"] == 0
    assert not eng.has_work() and req.generated == 0
