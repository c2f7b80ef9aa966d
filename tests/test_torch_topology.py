"""The port's hybrid-parallel topology (``distributed/topology.py``)
against the reference's, in one process: every rank list of
``CommunicateTopology`` and every group and accessor of
``HybridCommunicateGroup`` (as each global rank would build it) must be
the JAX package's exactly. (The groups' collectives over a world of
gloo ranks are in ``test_torch_collectives.py``.)"""

import pytest

from paddle_tpu.distributed import topology as jtopo
from paddle_tpu_torch.distributed import topology as ttopo

NAMES = ["data", "pipe", "sharding", "sep", "model"]
DIMS = [[2, 1, 1, 1, 2], [1, 2, 2, 1, 2], [2, 2, 1, 1, 2], [8, 1, 1, 1, 1],
        [1, 1, 1, 2, 4], [2, 1, 2, 2, 1]]


@pytest.mark.parametrize("dims", DIMS)
def test_communicate_topology_rank_lists(dims):
    j = jtopo.CommunicateTopology(NAMES, dims)
    t = ttopo.CommunicateTopology(NAMES, dims)
    assert t.world_size() == j.world_size()
    assert t.get_hybrid_group_names() == j.get_hybrid_group_names()
    for name in NAMES:
        assert t.get_dim(name) == j.get_dim(name)
        assert t.get_comm_list(name) == j.get_comm_list(name)
        for i in range(t.get_dim(name)):
            assert t.get_axis_list(name, i) == j.get_axis_list(name, i)
    for r in range(t.world_size()):
        assert tuple(t.get_coord(r)) == tuple(j.get_coord(r))
        assert t.get_rank(**dict(zip(NAMES, t.get_coord(r)))) == r
        for stage in range(t.get_dim("pipe")):
            assert t.get_rank_from_stage(r, pipe=stage) == \
                j.get_rank_from_stage(r, pipe=stage)


def _groups(hcg):
    out = {}
    for what in ("data_parallel", "model_parallel", "sharding_parallel"):
        g = getattr(hcg, f"get_{what}_group")()
        out[what] = (g.ranks, g.axis_name)
    g = hcg.get_pipe_parallel_group()
    out["pipe"] = (g.ranks, g.axis_name)
    sep = hcg.get_sep_parallel_group()
    out["sep"] = None if sep is None else (sep.ranks, sep.axis_name)
    out["fused"] = hcg._dp_sharding_fused.ranks
    for acc in ("get_parallel_mode", "get_global_rank",
                "get_data_parallel_world_size", "get_data_parallel_rank",
                "get_data_parallel_group_src_rank",
                "get_model_parallel_world_size", "get_model_parallel_rank",
                "get_model_parallel_group_src_rank",
                "get_pipe_parallel_world_size", "get_stage_id",
                "get_sharding_parallel_world_size",
                "get_sharding_parallel_rank", "get_sep_parallel_world_size",
                "get_sep_parallel_rank"):
        out[acc] = getattr(hcg, acc)()
    out["mesh"] = (hcg.mesh.shape, hcg.mesh.dim_names,
                   hcg.mesh.process_ids)
    return out


@pytest.mark.parametrize("dims,rank", [
    (dims, r) for dims in DIMS
    for r in sorted({0, 1, int(__import__("numpy").prod(dims)) - 1})])
def test_hybrid_communicate_group(dims, rank, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
    j = jtopo.HybridCommunicateGroup(jtopo.CommunicateTopology(NAMES, dims))
    t = ttopo.HybridCommunicateGroup(ttopo.CommunicateTopology(NAMES, dims))
    assert _groups(t) == _groups(j)
    for stage in range(dims[1]):
        assert t.get_rank_from_stage(stage) == j.get_rank_from_stage(stage)


def test_parallel_mode_constants():
    for name in ("DATA_PARALLEL", "TENSOR_PARALLEL", "PIPELINE_PARALLEL",
                 "SHARDING_PARALLEL", "SEGMENT_PARALLEL"):
        assert getattr(ttopo.ParallelMode, name) == \
            getattr(jtopo.ParallelMode, name)


def test_process_mesh_metadata_and_sub_meshes(monkeypatch):
    """The mesh's metadata as the reference's, its sub-meshes, and the
    reference's ``create_hybrid_mesh`` case (dp = dcn 2 x ici 1, tp =
    ici 4) over a world of 8 ranks."""
    import numpy as np

    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu_torch.distributed import mesh as tmesh

    ids = np.arange(8).reshape(2, 4)
    j = jmesh.ProcessMesh(ids, dim_names=["dp", "mp"])
    t = tmesh.ProcessMesh(ids, dim_names=["dp", "mp"])
    for attr in ("shape", "ndim", "dim_names", "process_ids", "size"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for name in ("dp", "mp"):
        assert t.get_dim_size(name) == j.get_dim_size(name)
        for pid in (0, 5, 9):
            assert t.get_rank_by_dim_and_process_id(name, pid) == \
                j.get_rank_by_dim_and_process_id(name, pid)
    assert t.coord(6) == (1, 2) and t.coord(9) is None
    assert t.group_ranks("mp", 6) == [4, 5, 6, 7]
    assert t.group_ranks("dp", 6) == [2, 6]
    assert t.group_ranks(("dp", "mp"), 6) == list(range(8))
    assert t.axis_index(("dp", "mp"), 6) == 6 and t.axis_index("mp", 6) == 2
    row = t[1]
    assert row.process_ids == [4, 5, 6, 7] and row.dim_names == ["mp"]
    monkeypatch.setenv("PADDLE_TRAINER_ID", "6")
    sub = t.get_submesh_with_dim("dp")
    assert sub.process_ids == [2, 6] and sub.dim_names == ["dp"]
    lay = tmesh.placements_to_layout(
        t, [tmesh.Replicate(), tmesh.Shard(1)], 2)
    assert lay.mesh_axes == (("dp", 2), ("mp", 4))
    assert lay.dim_placements == (None, "mp")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    h = tmesh.create_hybrid_mesh(ici_shape=[1, 4], dcn_shape=[2, 1],
                                 dim_names=["dp", "tp"])
    jh = jmesh.create_hybrid_mesh(ici_shape=[1, 4], dcn_shape=[2, 1],
                                  dim_names=["dp", "tp"])
    assert h.process_ids == jh.process_ids and h.shape == jh.shape
    assert h._dcn_shape == [2, 1] and h._ici_shape == [1, 4]
