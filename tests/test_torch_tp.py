"""Tensor and sequence parallelism of the port (``roko_tpu_torch/parallel``
``tp.py``, ``ring.py`` and the dp x tp x sp grid of ``mesh.py``) against
one process and against ``roko_tpu`` on the CPU.

Gloo ranks (``tests/torch_tp_worker.py``, mode ``grid``) run the tiny
transformer (d_model 32, 4 heads, 2 layers; ``KINDS["transformer"]`` of
``tests/torch_dp_worker.py``) on four layouts: tp=2 and sp=2 on two ranks,
tp=2 x sp=2 and dp=2 x tp=2 on four, each launched once for the module.
Each rank takes its dp group's rows of the global batch of 8 (uneven
padding rows, as ``tests/test_torch_parallel.py``) and returns its block:
the eval logits of its rows and columns, and one ``grad_step`` with
dropout 0.2 and off, its gradients those of its tp part. This process
joins the blocks and holds them against:

- ``roko_tpu``'s ``RokoModel.apply`` logits at rtol = atol = 2e-5 (the
  bar of ``tests/test_transformer.py:53-71``);
- the port's one-process step at the global batch, the same dropout
  masks drawn, at rtol = atol = 3e-5 (``tests/test_transformer.py:74-125``);
- with dropout off, ``jax.value_and_grad`` of the reference's loss at the
  f32 bar (rtol 1e-4, atol 1e-5).

The ranks agree: the same loss everywhere, a replicated parameter's
gradient bitwise equal on every rank, a tp part's on every rank that
holds it, and after 3 Adam steps the parameters likewise. The gru kind
replicates over tp: at tp=2 its step equals its dp=2 run. A dp=2 x tp=2
``loop.train`` writes a checkpoint of full tensors that loads into one
process and holds that run's parameters, and resumes on the grid; on two
ranks, ``train --tp 2``, ``inference --tp 2`` and ``--sp 2`` and ``polish
--sp 2`` through ``cli.main`` write the FASTA of one process and of
``roko_tpu``. ``param_specs`` names the reference's split axes leaf for
leaf, and heads, MLP units or columns that a grid does not divide are
refused.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from roko_tpu.config import MeshConfig as JaxMeshConfig
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.config import RokoConfig as JaxRokoConfig
from roko_tpu.infer import polish_to_fasta as ref_polish_to_fasta
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.parallel.mesh import make_mesh as ref_make_mesh
from roko_tpu.parallel.tp import param_specs as ref_param_specs
from roko_tpu.training.loop import _loss_and_stats
from roko_tpu_torch import cli
from roko_tpu_torch.config import MeshConfig, ModelConfig
from roko_tpu_torch.models.convert import jax_from_state_dict
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.parallel.distributed import grid_members
from roko_tpu_torch.parallel.mesh import Mesh
from roko_tpu_torch.parallel.tp import check_divisible, param_specs, split_axis
from roko_tpu_torch.sim import build_synthetic_project
from roko_tpu_torch.training.checkpoint import CheckpointManager, load_params
from roko_tpu_torch.training.loop import make_optimizer
from tests import torch_dp_worker as W
from tests import torch_tp_worker as T
from tests.test_torch_multiprocess import _corpora
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

FWD, STEP = 2e-5, 3e-5
REF_RTOL, REF_ATOL = 1e-4, 1e-5
TRANSFORMER_LAYOUTS = ["tp2", "sp2", "tp2sp2", "dp2tp2"]
JAX_TRANSFORMER = JaxModelConfig(kind="transformer", hidden_size=16, d_model=32, num_heads=4,
                                 num_layers=2, embed_dim=8, read_mlp=(8, 4))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_files")
    paths = _corpora(tmp)
    project = build_synthetic_project(str(tmp / "sim"), seed=13, genome_len=4000)
    return {**paths, "draft": project["draft_fasta"], "bam": project["reads_bam"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, files):
    """{layout: [each rank's row]}, and each world's other results."""
    out = {}
    for n, args in ((2, (files["train"], files["infer"], files["draft"], files["bam"])),
                    (4, ())):
        d = tmp_path_factory.mktemp(f"grid{n}")
        W.launch("grid", str(d), *args, ranks=n, module="tests.torch_tp_worker")
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]
        out[n] = {"dir": d, "ranks": ranks}
        for name in ranks[0]["layouts"]:
            out[name] = [r["layouts"][name] for r in ranks]
    return out


def first(rows, **at):
    """The rows whose grid coordinates match ``at`` (d, t, s)."""
    keys = {"d": 0, "t": 1, "s": 2}
    return [r for r in rows if all(r["coords"][keys[k]] == v for k, v in at.items())]


def join_logits(rows, kind="transformer"):
    """The global batch's logits from the blocks of tp rank 0."""
    dp, _, sp = rows[0]["sizes"]
    return torch.cat([
        torch.cat([first(rows, d=d, t=0, s=s)[0][f"{kind}/logits"] for s in range(sp)], 1)
        for d in range(dp)], 0)


def join_grads(rows, key, kind="transformer"):
    """(loss, {name: the full gradient}) from the tp parts of grid point (0, t, 0)."""
    _, tp, _ = rows[0]["sizes"]
    parts = [first(rows, d=0, t=t, s=0)[0][key][2] for t in range(tp)]
    full = {}
    for name in parts[0]:
        axis = split_axis(name) if kind == "transformer" else None
        full[name] = parts[0][name] if axis is None else torch.cat([p[name] for p in parts], axis)
    return rows[0][key][0], full


def reference_grads(state, dropout):
    """``jax.value_and_grad`` of the reference's loss on the global batch."""
    params = jax_from_state_dict(state)
    jmodel = JaxRokoModel(dataclasses.replace(JAX_TRANSFORMER, dropout=dropout))
    x, y, w = W.global_batch()
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: _loss_and_stats(jmodel, p, x, y, w, None), has_aux=True))(params)
    return float(loss), grads


# -- the grid ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(T.LAYOUTS[2]) + list(T.LAYOUTS[4]))
def test_every_rank_holds_its_grid_point_and_groups(runs, name):
    """Rank (d * tp + t) * sp + s, as the reference reshapes its devices;
    each group the ranks that share the other coordinates."""
    rows = runs[name]
    dp, tp, sp = rows[0]["sizes"]
    grid = np.arange(dp * tp * sp).reshape(dp, tp, sp)
    members = grid_members(dp, tp, sp)
    for r, row in enumerate(rows):
        d, t, s = row["coords"]
        assert grid[d, t, s] == r
        want = {"dp": grid[:, t, s], "tp": grid[d, :, s], "sp": grid[d, t, :],
                "dp_sp": grid[:, t, :].ravel()}
        for axis, ranks in want.items():
            assert sorted(ranks.tolist()) in members[axis]
            got = row["groups"][axis]
            assert (got or [r]) == sorted(ranks.tolist()), (axis, got)


@pytest.mark.parametrize("name", TRANSFORMER_LAYOUTS)
def test_forward_logits_match_reference(runs, name):
    model = W.fresh_model(T.TRANSFORMER)
    want = np.asarray(JaxRokoModel(JAX_TRANSFORMER).apply(
        jax_from_state_dict(model.state_dict()), W.global_batch()[0]))
    got = join_logits(runs[name]).numpy()
    print(f"{name}: max |delta logits| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=FWD, atol=FWD)


@pytest.mark.parametrize("name", TRANSFORMER_LAYOUTS)
def test_grad_step_with_dropout_matches_one_process(runs, name):
    """Dropout 0.2: every mask is cut from the global batch's, so the grid's
    step is one process's at the global batch."""
    loss, grads = join_grads(runs[name], "transformer/dropout")
    want_loss, _, want = W.one_step(W.fresh_model(T.TRANSFORMER), W.global_batch(), None,
                                    W.DROPOUT_SEED)
    worst = max((grads[n] - want[n]).abs().max().item() for n in want)
    print(f"{name}: loss {loss} vs {want_loss}, max |delta grad| {worst:.3e}")
    np.testing.assert_allclose(loss, want_loss, rtol=STEP, atol=STEP)
    assert set(grads) == set(want)
    for n in want:
        torch.testing.assert_close(grads[n], want[n], rtol=STEP, atol=STEP, msg=n)


@pytest.mark.parametrize("name", TRANSFORMER_LAYOUTS)
def test_gradients_without_dropout_match_reference_value_and_grad(runs, name):
    loss, grads = join_grads(runs[name], "transformer/nodrop")
    cfg = dataclasses.replace(T.TRANSFORMER, dropout=0.0)
    jloss, jgrads = reference_grads(W.fresh_model(cfg).state_dict(), 0.0)
    np.testing.assert_allclose(loss, jloss, rtol=REF_RTOL, atol=REF_ATOL)
    got = dict(jax.tree_util.tree_flatten_with_path(jax_from_state_dict(grads))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0])
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), g, rtol=REF_RTOL, atol=REF_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_parts_agree(rows, tensors_of):
    """A replicated tensor bitwise equal on every rank; a tp part on every
    rank of its tp place."""
    for row in rows:
        ref = first(rows, t=row["coords"][1])[0]
        for n, v in tensors_of(row).items():
            other = tensors_of(rows[0] if split_axis(n) is None else ref)[n]
            assert torch.equal(v, other), (row["coords"], n)


@pytest.mark.parametrize("name", TRANSFORMER_LAYOUTS)
@pytest.mark.parametrize("drop", ["dropout", "nodrop"])
def test_ranks_agree_on_the_step(runs, name, drop):
    rows = runs[name]
    key = f"transformer/{drop}"
    assert len({r[key][0] for r in rows}) == 1 and all(r[key][1] for r in rows)
    _assert_parts_agree(rows, lambda r: r[key][2])


@pytest.mark.parametrize("name", T.ADAM_LAYOUTS)
def test_replicas_and_tp_peers_bitwise_equal_after_adam_steps(runs, name):
    rows = runs[name]
    assert len({tuple(r["k_steps"]["losses"]) for r in rows}) == 1
    _assert_parts_agree(rows, lambda r: r["k_steps"]["params"])


@pytest.mark.parametrize("name", T.ADAM_LAYOUTS)
def test_adam_steps_follow_one_process(runs, name):
    """The losses of 3 Adam steps against one process's at rtol = atol =
    3e-5. The parameters are not held to one process's: Adam's first step
    moves an entry by about lr whatever its gradient's size, so an entry
    whose gradient sums to 1e-9 in one order and to another 1e-9 in
    another (``pos_embed`` has such entries) moves by a different share of
    lr, as ``tests/test_transformer.py:79-82`` says of the reference."""
    model = W.fresh_model(T.TRANSFORMER)
    opt = make_optimizer(model, W.LR)
    losses = []
    for k in range(W.K_STEPS):
        loss, _, _ = W.one_step(model, W.global_batch(seed=100 + k), None, W.DROPOUT_SEED + k)
        opt.step()
        losses.append(loss)
    np.testing.assert_allclose(runs[name][0]["k_steps"]["losses"], losses, rtol=STEP, atol=STEP)


def test_gru_replicates_over_tp_and_equals_its_dp_run(runs):
    """gru at tp=2: each rank runs the whole batch, the same gradients on
    both, equal to the dp=2 run's (at the dp tests' bar) and to one
    process's."""
    tp_rows, dp_rows = runs["tp2"], runs["dp2"]
    for drop in ("dropout", "nodrop"):
        key = f"gru/{drop}"
        (l0, _, g0), (l1, _, g1) = (r[key] for r in tp_rows)
        assert l0 == l1 and all(torch.equal(g0[n], g1[n]) for n in g0)
        dl, _, dg = dp_rows[0][key]
        np.testing.assert_allclose(l0, dl, rtol=1e-5, atol=1e-6)
        for n in g0:
            torch.testing.assert_close(g0[n], dg[n], rtol=1e-5, atol=1e-6, msg=n)
        cfg = W.KINDS["gru"] if drop == "dropout" else dataclasses.replace(W.KINDS["gru"],
                                                                          dropout=0.0)
        _, _, want = W.one_step(W.fresh_model(cfg), W.global_batch(), None,
                                W.DROPOUT_SEED if drop == "dropout" else None)
        for n in want:
            torch.testing.assert_close(g0[n], want[n], rtol=1e-5, atol=1e-6, msg=n)
    np.testing.assert_array_equal(join_logits(tp_rows, "gru"), join_logits(dp_rows, "gru"))


# -- checkpoints and the command line ---------------------------------------


def test_grid_checkpoint_loads_in_one_process(runs):
    """dp=2 x tp=2 ``loop.train``: its checkpoint holds the keys and shapes
    of a one-process run, model and Adam state, and that run's parameters;
    every rank gathered the same."""
    ranks = runs[4]["ranks"]
    ckpt = str(runs[4]["dir"] / "ckpt")
    params = load_params(ckpt)
    one = RokoModel(T.TRANSFORMER)
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in one.state_dict().items()}
    one.load_state_dict(params, strict=True)
    train = ranks[0]["train"]
    assert all(torch.equal(params[k], train["resumed"][k].cpu()) for k in params)
    for r in ranks[1:]:
        assert all(torch.equal(r["train"]["full"][k].cpu(), train["full"][k].cpu())
                   for k in params)
    optimizer = CheckpointManager(ckpt).restore_latest()["optimizer"]
    shapes = [p.shape for p in one.parameters()]
    assert [st["exp_avg"].shape for _, st in sorted(optimizer["state"].items())] == shapes
    make_optimizer(one, 1e-3).load_state_dict(optimizer)


def test_grid_resumes_from_its_checkpoint(runs):
    train = runs[4]["ranks"][0]["train"]
    assert train["steps"] == (4, 8)
    assert any(line.startswith("resumed from step 4 (epoch 1, batch 0,")
               for line in train["log"])


def test_cli_on_the_grid_writes_the_fasta_of_one_process_and_reference(runs, files, tmp_path):
    """``train --tp 2`` on two ranks, then ``inference --tp 2`` and ``--sp 2``:
    the FASTA of one process's ``inference`` on the same checkpoint and of
    ``roko_tpu.infer.polish_to_fasta``; ``polish --sp 2`` that of one
    process's ``polish --staged``."""
    out = runs[2]["dir"]
    assert runs[2]["ranks"][0]["cli"] == {"train": 0, "inference_tp": 0, "inference_sp": 0,
                                          "polish_sp": 0}
    ckpt = str(out / "ckpt")
    one = tmp_path / "one.fasta"
    common = ["--b", "8", "--device", "cpu", *T.CLI_FLAGS]
    assert cli.main(["inference", files["infer"], ckpt, str(one), *common]) == 0
    want = one.read_bytes()
    assert want.count(b">") == 3
    assert (out / "tp.fasta").read_bytes() == want
    assert (out / "sp.fasta").read_bytes() == want
    ref = tmp_path / "ref.fasta"
    cfg = JaxRokoConfig(model=JaxModelConfig(kind="transformer", hidden_size=16, d_model=32,
                                             num_heads=4, num_layers=1),
                        mesh=JaxMeshConfig(dp=1))
    ref_polish_to_fasta(files["infer"], jax_from_state_dict(load_params(ckpt)), str(ref), cfg,
                        batch_size=8, mesh=ref_make_mesh(cfg.mesh, jax.devices()[:1]),
                        log=lambda *a: None)
    assert ref.read_bytes() == want
    staged = tmp_path / "staged.fasta"
    assert cli.main(["polish", files["draft"], files["bam"], ckpt, str(staged), "--staged",
                     *common]) == 0
    assert (out / "polish_sp.fasta").read_bytes() == staged.read_bytes()
    assert sorted(p.name for p in out.iterdir() if ".part" in p.name) == []


# -- the split rules and the refusals ----------------------------------------


@pytest.mark.parametrize("kind", ["transformer", "gru", "lingru"])
def test_param_specs_name_the_references_split_axes(kind):
    """Leaf for leaf: the reference's ``P(None, "tp")`` on an ``[in, out]``
    kernel is the port's axis 0 of its ``[out, in]`` weight, ``P("tp",
    None)`` its axis 1, ``P("tp")`` on a bias axis 0, ``P()`` None."""
    cfg = T.TRANSFORMER if kind == "transformer" else W.KINDS[kind]
    state = W.fresh_model(cfg).state_dict()
    specs = param_specs(cfg, state)
    # each tensor marked with its index, to find it in the converted tree
    names = list(state)
    marked = {n: torch.full_like(t, float(i)) for i, (n, t) in enumerate(state.items())}
    tree = jax_from_state_dict(marked)
    jcfg = dataclasses.replace(JAX_TRANSFORMER, kind=kind)
    ref = ref_param_specs(jcfg, tree)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    ref_leaves = dict(jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    assert len(leaves) == len(state)
    for path, leaf in leaves:
        name = names[int(np.asarray(leaf).flat[0])]
        spec = tuple(ref_leaves[path])
        ref_axis = spec.index("tp") if "tp" in spec else None
        transposed = name.endswith(".weight") and leaf.ndim == 2 and not name.startswith(
            ("embedding", "encoder.pos_embed"))
        want = None if ref_axis is None else (1 - ref_axis if transposed else ref_axis)
        assert specs[name] == want, (name, spec)
    assert any(v is not None for v in specs.values()) == (kind == "transformer")


def test_heads_mlp_units_and_columns_the_grid_does_not_divide_are_refused():
    cfg = T.TRANSFORMER  # 4 heads, mlp 128, 90 columns
    check_divisible(cfg, 4, 6)
    for tp, sp, message in ((3, 1, "num_heads 4 not divisible by tp=3"),
                            (1, 4, "window_cols 90 not divisible by sp=4"),
                            (8, 1, "num_heads 4 not divisible by tp=8")):
        with pytest.raises(ValueError, match=message):
            check_divisible(cfg, tp, sp)
        with pytest.raises(ValueError, match=message):
            RokoModel(cfg, mesh=Mesh(dp=1, tp=tp, sp=sp))
    # the recurrent kinds replicate over both axes
    check_divisible(W.KINDS["gru"], 3, 4)
    RokoModel(W.KINDS["gru"], mesh=Mesh(dp=1, tp=3, sp=4))


def test_a_grid_model_starts_from_the_one_process_draw_cut():
    """A tp model's parts are the one-process model's tensors cut; an sp
    model computes the columns of its block."""
    full = W.fresh_model(T.TRANSFORMER).state_dict()
    for t in range(2):
        part = RokoModel(T.TRANSFORMER, torch.Generator().manual_seed(3),
                         mesh=Mesh(dp=1, rank=t, tp=2)).state_dict()
        for n, v in part.items():
            axis = split_axis(n)
            assert torch.equal(v, full[n] if axis is None else full[n].chunk(2, axis)[t]), n
    model = RokoModel(T.TRANSFORMER, mesh=Mesh(dp=1, rank=1, sp=3))
    assert model.columns == slice(30, 60) and model.column_split
    assert not RokoModel(T.TRANSFORMER).column_split
