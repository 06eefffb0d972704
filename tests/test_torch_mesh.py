"""``repro_torch.launch.mesh``: meshes of ranks over ``torch.distributed``.

A world of one rank runs in the test's own process (an in-process store,
destroyed after each test); worlds of 2 and 4 CPU ranks are spawned with
a ``file://`` store under ``tmp_path`` (``run_world``), each doing its
checks in one spawn.  Held here: the shapes and axis names of the
reference's meshes, one gloo group per axis holding the right ranks, a
rank's card (``rank_device``) and the refusal of more ranks per card
than ``ranks_per_device`` allows, no fall-through to the CPU without a
card, no process group at import or after a world ends, and a dead or
hung rank turning into an error, never a hang (the gloo timeout, and
``run_world``'s own deadline)."""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M  # noqa: E402


@pytest.fixture
def world1():
    with M.world():
        yield
    assert not torch.distributed.is_initialized()


def test_rank_device_maps_ranks_to_cards():
    assert M.rank_device(0, 1, 1, 1) == torch.device("cuda", 0)
    assert [M.rank_device(r, 4, 4, 1).index for r in range(4)] == [0] * 4
    assert [M.rank_device(r, 4, 2, 2).index for r in range(4)] == \
        [0, 0, 1, 1]
    assert [M.rank_device(r, 8, 1, 8).index for r in range(8)] == \
        list(range(8))


@pytest.mark.parametrize("local_world,rpd,cards", [(2, 1, 1), (4, 2, 1),
                                                   (4, 1, 2), (9, 1, 8)])
def test_rank_device_refuses_more_ranks_per_card(local_world, rpd, cards):
    with pytest.raises(ValueError) as e:
        M.rank_device(0, local_world, rpd, cards)
    need = -(-local_world // cards)
    assert f"{local_world} ranks" in str(e.value)
    assert f"put {need} ranks on a card" in str(e.value)
    assert f"ranks_per_device={rpd}" in str(e.value)


def test_no_card_raises_and_never_falls_back():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        M.rank_device(0, 1, 1, 0)
    with pytest.raises(ValueError):
        M.rank_device(0, 1, 0, 1)


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_from_env"):
        M.make_mesh((1,), ("step",), device="cpu")


def test_one_rank_world_meshes(world1):
    mesh = M.make_mesh((1,), ("step",), device="cpu")
    assert (mesh.shape, mesh.axis_names, mesh.size, mesh.index, mesh.root) \
        == ((1,), ("step",), 1, 0, 0)
    assert mesh.device == torch.device("cpu")
    assert M.mesh_device_count(mesh) == 1
    assert set(mesh.groups) == {"step"}
    assert M.make_batch_mesh(device="cpu").axis_names == ("data",)
    assert M.make_local_mesh(device="cpu").shape == (1, 1)
    cm = M.make_campaign_mesh(1, 1, device="cpu")
    assert cm.mesh.axis_names == ("batch", "step")
    assert (cm.batch_mesh.axis_names, cm.step_mesh.axis_names) == \
        (("batch",), ("step",))
    assert cm.batch_mesh.size == cm.step_mesh.size == 1
    assert "mesh(step=1) rank 0 shard 0 device cpu" in mesh.describe()


def test_one_rank_world_refusals(world1):
    with pytest.raises(ValueError, match="spans the world"):
        M.make_mesh((2,), ("step",), device="cpu")
    with pytest.raises(ValueError, match="pair up"):
        M.make_mesh((1,), ("a", "b"), device="cpu")
    with pytest.raises(ValueError, match="num_devices"):
        M.make_batch_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="256"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        M.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="batch >= 1"):
        M.make_campaign_mesh(0, 1, device="cpu")


def test_world_context_keeps_a_group_it_did_not_create(world1):
    assert not M.init_from_env()         # one exists: left as it is
    with M.world():
        pass
    assert torch.distributed.is_initialized()


def test_file_store_needs_rank_and_world_size():
    with pytest.raises(ValueError, match="rank and world_size"):
        M.init_from_env("file:///nonexistent/store")
    assert not torch.distributed.is_initialized()


def test_torchrun_environment_is_detected(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert not M.launched_by_torchrun()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert M.launched_by_torchrun()


# ---------------------------------------------------------------------------
# spawned worlds (module level: the ranks import this module)
# ---------------------------------------------------------------------------

def _axis_members(mesh, axis: str) -> list[int]:
    me = torch.tensor([torch.distributed.get_rank()])
    g = mesh.groups[axis]
    out = [torch.empty_like(me)
           for _ in range(torch.distributed.get_world_size(g))]
    torch.distributed.all_gather(out, me, group=g)
    return sorted(int(t) for t in out)


def _world4(rank: int, world: int) -> dict:
    out = {}
    grid = M.make_mesh((2, 2), ("batch", "step"), device="cpu")
    out["grid"] = (grid.shape, grid.index, grid.ranks.tolist(),
                   _axis_members(grid, "batch"), _axis_members(grid, "step"))
    out["local"] = M.make_local_mesh(device="cpu").shape
    out["batch"] = M.make_batch_mesh(device="cpu").shape
    cm = M.make_campaign_mesh(2, 2, device="cpu")
    out["campaign"] = (cm.mesh.axis_names, *(
        None if m is None else (m.axis_names, m.ranks.tolist(), m.index,
                                _axis_members(m, m.axis_names[0]))
        for m in (cm.batch_mesh, cm.step_mesh)))
    # four ranks on one card need ranks_per_device >= 4
    real = torch.cuda.device_count
    torch.cuda.device_count = lambda: 1
    try:
        M.make_mesh((world,), ("step",), ranks_per_device=2)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    finally:
        torch.cuda.device_count = real
    out["device"] = M.rank_device(rank, world, world, 1)
    return out


def test_world_of_four_meshes(tmp_path):
    ranks = M.run_world(_world4, 4, str(tmp_path / "w4"), timeout_s=120)
    for rank, out in enumerate(ranks):
        shape, index, grid, batch_axis, step_axis = out["grid"]
        assert shape == (2, 2) and index == rank
        assert grid == [[0, 1], [2, 3]]
        assert batch_axis == [rank % 2, rank % 2 + 2]    # a column
        assert step_axis == [rank // 2 * 2, rank // 2 * 2 + 1]   # a row
        assert out["local"] == (2, 2) and out["batch"] == (4,)
        # the reference's carving: batch_mesh the first column, step_mesh
        # the first row; grid[0, 0] has both roles, grid[1, 1] neither
        names, batch, step = out["campaign"]
        assert names == ("batch", "step")
        assert batch == ((("batch",), [0, 2], rank // 2, [0, 2])
                         if rank in (0, 2) else None)
        assert step == ((("step",), [0, 1], rank, [0, 1])
                        if rank in (0, 1) else None)
        assert "4 ranks" in out["refused"] and \
            "ranks_per_device=2" in out["refused"]
        assert out["device"] == torch.device("cuda", 0)


def _raises(rank: int, world: int) -> None:
    if rank == 1:
        raise RuntimeError("rank 1 gives up")
    torch.distributed.barrier()


def _exits(rank: int, world: int) -> None:
    if rank == 1:
        os._exit(7)
    torch.distributed.barrier()


def _hangs(rank: int, world: int) -> None:
    time.sleep(600)


def _times_out(rank: int, world: int):
    """Rank 1 never joins the collective: rank 0's gather must raise
    at the group's timeout."""
    from datetime import timedelta
    g = torch.distributed.new_group([0, 1], backend="gloo",
                                    timeout=timedelta(seconds=2))
    if rank == 1:
        time.sleep(5)
        return None
    t0 = time.monotonic()
    out = [torch.zeros(1) for _ in range(world)]
    try:
        torch.distributed.all_gather(out, torch.ones(1), group=g)
        return ("returned", time.monotonic() - t0)
    except RuntimeError as e:
        return (type(e).__name__, time.monotonic() - t0)


@pytest.mark.parametrize("fn,match", [(_raises, "raised"),
                                      (_exits, "exited")])
def test_a_failing_rank_fails_the_world(tmp_path, fn, match):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        M.run_world(fn, 2, str(tmp_path / "w"), timeout_s=60)
    assert time.monotonic() - t0 < 40


def test_a_hung_world_is_killed_at_its_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="outlived its timeout"):
        M.run_world(_hangs, 2, str(tmp_path / "w"), timeout_s=4)
    assert time.monotonic() - t0 < 30


def test_a_missing_rank_is_an_error_at_the_group_timeout(tmp_path):
    ranks = M.run_world(_times_out, 2, str(tmp_path / "w"), timeout_s=60)
    kind, seconds = ranks[0]
    assert kind != "returned" and 1.5 < seconds < 5
    assert ranks[1] is None


def test_world_results_come_back_in_rank_order(tmp_path):
    got = M.run_world(_square, 3, str(tmp_path / "w"), timeout_s=60)
    assert got == [0, 1, 4]
    assert not torch.distributed.is_initialized()
    assert np.array_equal(got, np.arange(3) ** 2)


def _square(rank: int, world: int) -> int:
    torch.distributed.barrier()
    return rank * rank
