"""The port's meshes and process-group entry (sgfhe_tpu_torch/parallel/
mesh.py, distributed.py) on the CPU: a (1, 1) mesh in a gloo world of
this process, its asserts and batch helpers, and how `initialize` maps
its arguments onto init_process_group."""

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from sgfhe_tpu_torch.parallel import distributed as pdist  # noqa: E402
from sgfhe_tpu_torch.parallel import mesh as pmesh  # noqa: E402


@pytest.fixture
def world1(tmp_path):
    pdist.initialize(f"file://{tmp_path / 'pg'}", 1, 0, device="cpu")
    yield pmesh.make_mesh()
    dist.destroy_process_group()


def test_mesh_shapes_and_asserts(world1):
    mesh = world1
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("dp", "tp")
    assert pmesh.make_mesh(dp=1, tp=1).shape == (1, 1)
    with pytest.raises(AssertionError, match="needs 2 devices, have 1"):
        pmesh.make_mesh(dp=2)
    with pytest.raises(AssertionError, match="needs 2 devices, have 1"):
        pmesh.make_mesh(dp=1, tp=2)
    group, index, count = pmesh.mesh_slot(mesh)
    assert (group, index, count) == (dist.group.WORLD, 0, 1)
    x = torch.arange(6).reshape(3, 2)
    assert torch.equal(pmesh.batch_sharding(mesh, x), x)
    assert pdist.process_count() == 1
    with pytest.raises(AssertionError, match="tp=2 must divide"):
        pdist.make_global_mesh(tp=2)
    assert pdist.make_global_mesh(tp=1).shape == (1, 1)


def test_initialize_maps_its_arguments(monkeypatch):
    """A "host:port" address becomes tcp://, one with a scheme passes as it
    is, none means env://; gloo on the CPU; no group, no silent CPU world
    on a host without a card."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    pdist.initialize("localhost:29500", 2, 1, device="cpu")
    pdist.initialize("file:///tmp/pg", 2, 0, device="cpu")
    pdist.initialize(device="cpu")
    assert calls == [
        dict(backend="gloo", init_method="tcp://localhost:29500", world_size=2, rank=1),
        dict(backend="gloo", init_method="file:///tmp/pg", world_size=2, rank=0),
        dict(backend="gloo", init_method="env://"),
    ]
    assert pdist.process_count() == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdist.initialize("localhost:29500", 1, 0)
