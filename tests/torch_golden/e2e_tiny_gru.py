"""Trained weights for the end-to-end parity test
``tests/test_torch_end_to_end.py::test_trained_weights_polish_the_same_bytes``.

``e2e_tiny_gru.npz`` holds the parameters that ``roko_tpu.training.loop.
train`` gives ``TINY_GRU`` (``kind="gru"``, embed 8, read MLP (8, 4),
hidden 16, 2 layers) on the simulated genome of sim seed ``TRAIN_SIM_SEED``
(``GENOME_LEN`` bases, contig ``train``; features seeded 3): ``EPOCHS``
epochs at batch 16, lr ``LR``, seed 0, 10 % of the windows held out, one
device. They are stored as ``param_000``, ``param_001``, ... in the order
``jax.tree_util`` flattens the model's parameter tree, with each leaf's
path in ``paths``. Training them anew takes some 25 s of JAX on one CPU,
which the test does not spend: it rebuilds the tree from the file.

    JAX_PLATFORMS=cpu python -m tests.torch_golden.e2e_tiny_gru   # rewrites the file
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np

PATH = Path(__file__).with_name("e2e_tiny_gru.npz")
TRAIN_SIM_SEED = 21
GENOME_LEN = 3_000
TRAIN_FEATURES_SEED = 3
EPOCHS = 12
LR = 1e-2
BATCH = 16


def model_config():
    """``TINY_GRU`` of ``tests/test_lingru.py``, as the reference's config."""
    from roko_tpu.config import ModelConfig

    return ModelConfig(kind="gru", embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2)


def load():
    """The stored parameters as the reference's parameter tree (numpy leaves)."""
    import jax

    from roko_tpu.models import RokoModel

    gold = np.load(PATH)
    template = jax.eval_shape(RokoModel(model_config()).init, jax.random.PRNGKey(0))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(template)[0]]
    if paths != list(gold["paths"]):
        raise ValueError(f"{PATH.name} does not hold the parameter tree of {model_config()}")
    treedef = jax.tree_util.tree_structure(template)
    return jax.tree_util.tree_unflatten(
        treedef, [gold[f"param_{i:03d}"] for i in range(treedef.num_leaves)])


def make() -> None:
    import jax

    from roko_tpu.config import MeshConfig, RokoConfig, TrainConfig
    from roko_tpu.features.pipeline import run_features
    from roko_tpu.parallel.mesh import make_mesh
    from roko_tpu.sim import build_synthetic_project
    from roko_tpu.training.loop import train

    with tempfile.TemporaryDirectory() as work:
        p = build_synthetic_project(f"{work}/sim", seed=TRAIN_SIM_SEED, genome_len=GENOME_LEN,
                                    contig="train")
        run_features(p["draft_fasta"], p["reads_bam"], f"{work}/train.hdf5",
                     bam_y=p["truth_bam"], seed=TRAIN_FEATURES_SEED, log=lambda *a: None)
        cfg = RokoConfig(model=model_config(),
                         train=TrainConfig(batch_size=BATCH, epochs=EPOCHS, lr=LR, seed=0,
                                           val_fraction=0.1))
        state = train(cfg, f"{work}/train.hdf5", f"{work}/ckpt",
                      mesh=make_mesh(MeshConfig(dp=1), jax.devices()[:1]), resume=False)
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state.params))[0]
    np.savez(PATH, paths=np.array([jax.tree_util.keystr(p) for p, _ in leaves]),
             **{f"param_{i:03d}": np.asarray(v, np.float32) for i, (_, v) in enumerate(leaves)})
    print(f"wrote {PATH} ({len(leaves)} arrays)")


if __name__ == "__main__":
    make()
