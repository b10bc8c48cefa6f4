"""Data parallelism of the port (``roko_tpu_torch/parallel``) against one
process and against ``roko_tpu`` on the CPU.

Two gloo ranks (``tests/torch_dp_worker.py``, launched once for the
module) each take their rows of a global batch of 8 whose padding rows
fall unevenly (rank 0: four real rows, rank 1: one real and three of
padding) and run ``grad_step`` with dropout on; this process runs the
same step at the global batch. The gradients agree within rtol 1e-5 /
atol 1e-6 (the sums over rows group differently: the max |delta| is
printed), both ranks hold bitwise-equal gradients and, after K Adam
steps, bitwise-equal parameters. With dropout off the all-reduced
gradients meet ``jax.value_and_grad`` of the reference's loss on the
global batch at the one-step bar of ``tests/test_torch_train.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from roko_tpu.config import MeshConfig as JaxMeshConfig
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.parallel.mesh import mesh_shape as ref_mesh_shape
from roko_tpu.training.loop import _loss_and_stats
from roko_tpu_torch import cli
from roko_tpu_torch.config import MeshConfig
from roko_tpu_torch.models.convert import jax_from_state_dict
from roko_tpu_torch.models.layers import GlobalSlice, dropout
from roko_tpu_torch.parallel import Mesh, distributed, make_mesh, mesh_shape, shard_batch
from roko_tpu_torch.parallel.distributed import grid_members
from roko_tpu_torch.training.loop import evaluate, make_optimizer
from tests import torch_dp_worker as W
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-6
#: the reference's one-step bar (tests/test_torch_train.py)
REF_RTOL, REF_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    W.launch("steps", str(out))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in (0, 1)]


# -- mesh ------------------------------------------------------------------

MESHES = [(-1, 1, 1, 1), (-1, 1, 1, 4), (2, 1, 1, 2), (-1, 2, 1, 4), (-1, 1, 2, 8),
          (2, 2, 1, 4), (1, 1, 1, 1), (-1, -1, 1, 4), (-1, 3, 1, 4), (2, 1, 1, 1),
          (4, 1, 1, 2)]


@pytest.mark.parametrize("dp,tp,sp,n", MESHES)
def test_mesh_shape_matches_reference(dp, tp, sp, n):
    """The same sizes, or the same error, as ``roko_tpu``'s on the same
    inputs."""
    try:
        want = ref_mesh_shape(JaxMeshConfig(dp=dp, tp=tp, sp=sp), n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape(MeshConfig(dp=dp, tp=tp, sp=sp), n)
        assert str(got.value) == str(e)
    else:
        assert mesh_shape(MeshConfig(dp=dp, tp=tp, sp=sp), n) == want


def test_make_mesh_refuses_tp_sp_and_a_dp_beyond_the_processes():
    """A grid the processes cannot fill is refused with the reference's
    own wording; one process makes the grid of one point, no groups."""
    for cfg in (MeshConfig(tp=2), MeshConfig(sp=2), MeshConfig(dp=1, tp=2),
                MeshConfig(dp=2)):
        with pytest.raises(ValueError) as want:
            ref_mesh_shape(JaxMeshConfig(dp=cfg.dp, tp=cfg.tp, sp=cfg.sp), 1)
        with pytest.raises(ValueError) as got:
            make_mesh(cfg)
        assert str(got.value) == str(want.value)
    assert str(got.value) == "mesh [2, 1, 1] wants 2 devices, have 1"
    mesh = make_mesh()
    assert (mesh.dp, mesh.rank, mesh.collective) == (1, 0, False)
    assert (mesh.d, mesh.t, mesh.s) == (0, 0, 0)
    assert (mesh.dp_group, mesh.tp_group, mesh.sp_group, mesh.dp_sp_group) == (None,) * 4


@pytest.mark.parametrize("dp,tp,sp", [(2, 2, 3), (1, 2, 2), (3, 1, 2), (4, 2, 1)])
def test_grid_coordinates_and_groups_follow_the_references_layout(dp, tp, sp):
    """Rank r sits where the reference's ``make_mesh`` puts device r
    (``np.array(devices).reshape(dp, tp, sp)``), and each group holds the
    ranks that share the other coordinates."""
    grid = np.arange(dp * tp * sp).reshape(dp, tp, sp)
    members = grid_members(dp, tp, sp)
    want = {"dp": [grid[:, t, s] for t in range(tp) for s in range(sp)],
            "tp": [grid[d, :, s] for d in range(dp) for s in range(sp)],
            "sp": [grid[d, t, :] for d in range(dp) for t in range(tp)],
            "dp_sp": [grid[:, t, :].ravel() for t in range(tp)]}
    assert members == {axis: [g.tolist() for g in groups] for axis, groups in want.items()}
    for r in range(grid.size):
        mesh = Mesh(dp=dp, rank=r, tp=tp, sp=sp)
        assert grid[mesh.d, mesh.t, mesh.s] == r == mesh.rank_of(mesh.d, mesh.t, mesh.s)
    x = np.arange(4 * dp)
    assert shard_batch(Mesh(dp=dp, rank=grid[dp - 1, tp - 1, sp - 1], tp=tp, sp=sp),
                       (x,))[0].tolist() == x[-4:].tolist()


def test_initialize_stays_single_process_without_environment(monkeypatch):
    for name in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
                 distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.initialize(device="cuda") is False  # decided before any device
    assert not distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size(), distributed.is_primary()) == (0, 1, True)
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "2")
    with pytest.raises(ValueError, match="ROKO_COORDINATOR, ROKO_PROCESS_ID"):
        distributed.initialize(device="cpu")
    assert not distributed.is_initialized()


def test_two_ranks_on_one_card_under_nccl_are_refused_naming_gloo():
    distributed.refuse_shared_cards(["a:0", "a:1", "b:0"])
    with pytest.raises(ValueError, match="gloo"):
        distributed.refuse_shared_cards(["a:0", "a:0"])


def test_shard_batch_takes_this_ranks_rows_in_rank_order():
    x = np.arange(8)
    got = [shard_batch(dataclasses.replace(make_mesh(), dp=2, rank=r), (x, x * 2))
           for r in (0, 1)]
    assert [g[0].tolist() for g in got] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert got[1][1].tolist() == [8, 10, 12, 14]
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        shard_batch(dataclasses.replace(make_mesh(), dp=3), (x,))


def test_global_rows_dropout_is_the_global_batchs_mask():
    """Each rank's rows of the masks equal one process's at the global
    batch, and each rank's generator ends where that process's does."""
    x = torch.randn(6, 5, 7)
    one = torch.Generator().manual_seed(4)
    want = [dropout(x, 0.3, one), dropout(x, 0.3, one)]
    for r in (0, 1):
        g = torch.Generator().manual_seed(4)
        for k in range(2):
            got = dropout(x[3 * r : 3 * r + 3], 0.3, GlobalSlice(g, r, 2))
            assert torch.equal(got, want[k][3 * r : 3 * r + 3])
        assert torch.equal(g.get_state(), one.get_state())


@pytest.mark.parametrize("col_axis", [1, 2])
def test_global_slice_dropout_is_the_global_batchs_mask_cut_by_columns(col_axis):
    """On a dp=2 x sp=3 grid each rank's block of rows and columns of the
    masks equals one process's, on the column axis of each site (2 for the
    embedding's [B, R, T, D], 1 for [B, T, D, J] and the encoder's [B, T, d])."""
    shape = [4, 6, 6, 5]
    x = torch.randn(shape)
    one = torch.Generator().manual_seed(8)
    want = dropout(x, 0.25, one)
    for d in range(2):
        for s in range(3):
            g = torch.Generator().manual_seed(8)
            block = x[2 * d : 2 * d + 2].narrow(col_axis, 2 * s, 2)
            got = dropout(block, 0.25, GlobalSlice(g, d, 2, s, 3, col_axis))
            assert torch.equal(got, want[2 * d : 2 * d + 2].narrow(col_axis, 2 * s, 2))
            assert torch.equal(g.get_state(), one.get_state())


# -- two gloo ranks against one process ------------------------------------


def test_ranks_hold_their_rows_of_the_global_batch(ranks):
    assert [r["dp"] for r in ranks] == [2, 2]
    assert ranks[0]["local_w"] == [1.0] * 4 and ranks[1]["local_w"] == [1.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("kind", list(W.KINDS))
@pytest.mark.parametrize("drop", ["dropout", "nodrop"])
def test_two_rank_grad_step_matches_one_process(ranks, kind, drop):
    """The all-reduced step of two ranks against one process's at the
    global batch, the same masks drawn (dropout 0.2 or off): loss and
    every gradient within rtol 1e-5 / atol 1e-6, the ranks bitwise equal."""
    key = f"{kind}/{drop}"
    (l0, f0, g0), (l1, f1, g1) = (r["steps"][key]["result"] for r in ranks)
    assert l0 == l1 and f0 and f1
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    cfg = W.KINDS[kind] if drop == "dropout" else dataclasses.replace(W.KINDS[kind], dropout=0.0)
    model = W.fresh_model(cfg)
    state = ranks[0]["steps"][key]["state"]
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
    loss, finite, want = W.one_step(model, W.global_batch(), None,
                                    W.DROPOUT_SEED if drop == "dropout" else None)
    worst = max((g0[n] - want[n]).abs().max().item() for n in want)
    print(f"{key}: loss {l0} vs {loss}, max |delta grad| {worst:.3e}")
    np.testing.assert_allclose(l0, loss, rtol=RTOL, atol=ATOL)
    for n in want:
        torch.testing.assert_close(g0[n], want[n], rtol=RTOL, atol=ATOL, msg=n)


@pytest.mark.parametrize("kind", ["gru", "lingru"])
def test_two_rank_gradients_match_reference_value_and_grad(ranks, kind):
    """Dropout off: the two ranks' all-reduced gradients against
    ``jax.value_and_grad`` of ``roko_tpu``'s loss on the global batch."""
    key = f"{kind}/nodrop"
    loss, _, grads = ranks[0]["steps"][key]["result"]
    cfg = JaxModelConfig(kind=kind, embed_dim=8, read_mlp=(8, 4), hidden_size=16,
                         num_layers=2, dropout=0.0)
    params = jax_from_state_dict(ranks[0]["steps"][key]["state"])
    jmodel = JaxRokoModel(cfg)
    x, y, w = W.global_batch()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _loss_and_stats(jmodel, p, x, y, w, jax.random.PRNGKey(9)), has_aux=True
    ))(params)
    np.testing.assert_allclose(loss, float(jloss), rtol=REF_RTOL, atol=REF_ATOL)
    got = dict(jax.tree_util.tree_flatten_with_path(jax_from_state_dict(grads))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0])
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), g, rtol=REF_RTOL, atol=REF_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_replicas_are_bitwise_equal_after_k_steps(ranks):
    p0, p1 = (r["k_steps"]["params"] for r in ranks)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert ranks[0]["k_steps"]["losses"] == ranks[1]["k_steps"]["losses"]


def test_k_steps_follow_one_process(ranks):
    """K Adam steps of two ranks against one process at the global
    batches: losses within rtol 1e-5; parameters within 1e-3 of a step
    (lr): Adam divides by sqrt(v), so on an entry whose gradient is near
    0 a 1e-8 difference of the sums moves the update by a share of lr."""
    model = W.fresh_model(W.TINY)
    opt = make_optimizer(model, W.LR)
    losses = []
    for k in range(W.K_STEPS):
        loss, _, _ = W.one_step(model, W.global_batch(seed=100 + k), None, W.DROPOUT_SEED + k)
        opt.step()
        losses.append(loss)
    np.testing.assert_allclose(ranks[0]["k_steps"]["losses"], losses, rtol=RTOL, atol=ATOL)
    got = ranks[0]["k_steps"]["params"]
    for n, p in model.named_parameters():
        torch.testing.assert_close(got[n], p.detach(), rtol=0.0, atol=1e-3 * W.LR, msg=n)


def test_evaluate_equals_one_process(ranks):
    acc, loss = evaluate(W.fresh_model(W.TINY), W.eval_corpus(), W.EVAL_BATCH,
                         torch.device("cpu"))
    for r in ranks:
        assert r["evaluate"][0] == acc
        np.testing.assert_allclose(r["evaluate"][1], loss, rtol=RTOL)


# -- the command line ------------------------------------------------------


@pytest.mark.parametrize("command", ["train", "inference", "polish"])
@pytest.mark.parametrize("flags,message", [
    (["--tp", "2"], "mesh dp=-1: 1 devices not divisible by fixed axes product 2"),
    (["--sp", "2"], "mesh dp=-1: 1 devices not divisible by fixed axes product 2"),
    (["--dp", "1", "--tp", "2"], "mesh dp=1: mesh [1, 2, 1] wants 2 devices, have 1"),
    (["--dp", "2"], "mesh dp=2: mesh [2, 1, 1] wants 2 devices, have 1"),
])
def test_mesh_flags_are_usage_errors(tmp_path, capsys, command, flags, message):
    """In one process, a grid of more than one process (--tp, --sp or --dp
    2) is a usage error (rc 2) with ``roko_tpu``'s ``mesh_shape`` wording,
    before anything is read; --dp 1 and -1 parse."""
    positional = {"train": ["t.hdf5", "ckpt"], "inference": ["i.hdf5", "ckpt", "o.fasta"],
                  "polish": ["d.fasta", "r.bam", "ckpt", "o.fasta"]}[command]
    argv = [command, *[str(tmp_path / a) for a in positional], "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
    for dp in ("1", "-1"):
        args = cli.build_parser().parse_args([*argv, "--dp", dp])
        assert cli._build_config(args).mesh == MeshConfig(dp=int(dp))
