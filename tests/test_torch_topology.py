"""The port's ``core/topology.py`` (plain dicts, no networkx) answers every
public query as the reference's networkx graph does: the p4d testbed at
one and two hosts, an odd shape, the TPU-pod view and the named catalog."""
import pytest

from repro.core import topology as ref
from repro_torch.core import topology as twin

SHAPES = {
    "p4d-1": lambda m: m.make_p4d_cluster(1),
    "p4d-2": lambda m: m.make_p4d_cluster(2),
    # odd: 3 hosts of 6 devices, 3 per root, 3 NUMA domains, 3 slots
    "odd": lambda m: m.ClusterTopology(num_hosts=3, devices_per_host=6,
                                       devices_per_root=3, numa_per_host=3,
                                       slots_per_device=3, kind="gpu"),
    "tpu-pod": lambda m: m.make_tpu_pod_hosts(1, chips_per_host=4,
                                              hosts_per_pod=3),
}


def _slots(slots):
    return [(s.host, s.device, s.index, s.key) for s in slots]


def _answers(topo):
    """Every public query, over every device and pair of devices."""
    devs = topo.devices()
    out = {
        "attrs": (topo.kind, topo.num_hosts, topo.devices_per_host,
                  topo.slots_per_device),
        "devices": devs, "roots": topo.roots(), "numas": topo.numas(),
        "slots": _slots(topo.slots()),
    }
    for h in range(topo.num_hosts):
        out[f"devices(host={h})"] = topo.devices(h)
    for d in devs:
        out[f"per-device {d}"] = (topo.root_of(d), topo.numa_of(d),
                                  topo.host_of(d), topo.siblings(d),
                                  _slots(topo.slots(d)))
    out["pairs"] = [(a, b, topo.same_root(a, b), topo.same_numa(a, b))
                    for a in devs for b in devs]
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_twin_answers_every_query_as_the_reference(shape):
    r, t = SHAPES[shape](ref), SHAPES[shape](twin)
    assert _answers(t) == _answers(r)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_twin_holds_the_reference_graph(shape):
    """Nodes with their kinds, in insertion order, and the edges."""
    r, t = SHAPES[shape](ref), SHAPES[shape](twin)
    assert list(t.kinds.items()) == [(n, d["kind"])
                                     for n, d in r.g.nodes(data=True)]
    assert sorted(map(sorted, t.edges)) == sorted(map(sorted, r.g.edges()))


def test_catalog_and_refusals_match():
    assert sorted(twin.BUILTIN_TOPOLOGIES) == sorted(ref.BUILTIN_TOPOLOGIES)
    for name in sorted(ref.BUILTIN_TOPOLOGIES):
        assert _answers(twin.builtin_topology(name)) == \
            _answers(ref.builtin_topology(name))
    assert _answers(twin.make_p4d_fleet(4)) == _answers(ref.make_p4d_fleet(4))
    with pytest.raises(ValueError, match="unknown topology"):
        twin.builtin_topology("nope")
    with pytest.raises(ValueError, match="num_hosts must be >= 1"):
        twin.make_p4d_cluster(0)
    assert twin.Slot(0, "h0:g3", 1).key == ref.Slot(0, "h0:g3", 1).key
