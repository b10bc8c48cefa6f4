"""Multi-species train/val/test protocol on synthetic genomes, through the
port (counterpart of the reference's ``examples/multispecies_protocol.py``).

Mirrors roko's published evaluation design (5 training species, 1
validation species for early stopping, 1 held-out test species) with
synthetic "species": independently drawn genomes, so the train, val and
test sequence content is disjoint and the val-based early stopping and
the generalisation claim are exercised as the real protocol exercises
them::

    python -m roko_tpu_torch.examples.multispecies_protocol [--workdir DIR] \\
        [--error-model {uniform,homopolymer}] [--device {cuda,cpu}]

Each species goes through the port's pipeline (sim -> features -> HDF5);
training reads the 5-file train DIRECTORY and the val file through
``--val`` (no test content reaches training); the test species is
polished and assessed against its truth with the built-in evaluator.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from roko_tpu_torch.eval.assess import assess_fastas, format_report
from roko_tpu_torch.examples.synthetic_e2e import (
    BATCH,
    ERROR_MODELS,
    error_model_knobs,
    run_cli,
)
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.sim import build_synthetic_project

#: species ``i`` of the roles (train0..trainN-1, val, test) draws its
#: genome with sim seed ``SPECIES_SEED + i`` and its features with seed
#: ``10 + i``; the test species' inference features with ``TEST_FEATURES_SEED``
SPECIES_SEED = 1000
TEST_FEATURES_SEED = 99


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m roko_tpu_torch.examples.multispecies_protocol")
    ap.add_argument("--workdir", default="/tmp/roko_tpu_multispecies")
    ap.add_argument("--genome-len", type=int, default=8_000)
    ap.add_argument("--coverage", type=int, default=30,
                    help="simulated read depth per species (deeper pileups are the "
                    "homopolymer length-call lever)")
    ap.add_argument("--train-species", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--patience", type=int, default=10)
    ap.add_argument("--dp", type=int, default=-1)
    ap.add_argument("--error-model", choices=ERROR_MODELS, default="uniform")
    # window stride knobs of the homopolymer recipe: a finer TRAIN stride
    # multiplies training windows from the same genomes; a finer INFER
    # stride multiplies votes per draft position
    ap.add_argument("--train-stride", type=int, default=None)
    ap.add_argument("--infer-stride", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains and polishes (default cuda; no card is an "
                    "error, never a silent move to the CPU)")
    args = ap.parse_args(argv)

    from roko_tpu_torch.infer import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    wd = args.workdir
    train_dir = os.path.join(wd, "train")
    os.makedirs(train_dir, exist_ok=True)

    roles = [f"train{i}" for i in range(args.train_species)] + ["val", "test"]
    projects = {}
    for i, role in enumerate(roles):
        sp_dir = os.path.join(wd, f"species_{role}")
        # an independent seed draws an independent genome: the species are
        # disjoint sequence content, like the real species split
        projects[role] = build_synthetic_project(
            sp_dir, seed=SPECIES_SEED + i, genome_len=args.genome_len, contig=f"ctg_{role}",
            coverage=args.coverage, **error_model_knobs(args.error_model))
        print(f"== species {role}: {sp_dir}")

    # features: each train species (with labels) -> one HDF5 in the train
    # DIRECTORY; the val species (with labels) -> its own file; the test
    # species -> inference-mode features only
    val_h5 = os.path.join(wd, "val.hdf5")
    for i, role in enumerate(roles[:-1]):
        p = projects[role]
        out = os.path.join(train_dir, f"{role}.hdf5") if role.startswith("train") else val_h5
        cmd = ["features", p["draft_fasta"], p["reads_bam"], out, "--Y", p["truth_bam"],
               "--seed", str(10 + i)]
        # train species only: the val window set stays fixed, so val
        # metrics compare across --train-stride settings
        if args.train_stride is not None and role.startswith("train"):
            cmd += ["--window-stride", str(args.train_stride)]
        run_cli(cmd)
    test_p = projects["test"]
    infer_h5 = os.path.join(wd, "test_infer.hdf5")
    cmd = ["features", test_p["draft_fasta"], test_p["reads_bam"], infer_h5,
           "--seed", str(TEST_FEATURES_SEED)]
    if args.infer_stride is not None:
        cmd += ["--window-stride", str(args.infer_stride)]
    run_cli(cmd)

    print(f"== train on {args.train_species} species, early stopping on the val species")
    ckpt = os.path.join(wd, "ckpt")
    run_cli(["train", train_dir, ckpt, "--val", val_h5, "--b", str(BATCH),
             "--epochs", str(args.epochs), "--lr", str(args.lr),
             "--patience", str(args.patience), "--dp", str(args.dp), "--no-resume",
             "--device", args.device])

    print("== polish the held-out test species")
    polished = os.path.join(wd, "test_polished.fasta")
    run_cli(["inference", infer_h5, ckpt, polished, "--b", str(BATCH), "--dp", str(args.dp),
             "--device", args.device])

    truth = {n: s.encode() for n, s in read_fasta(test_p["truth_fasta"])}
    draft = {n: s.encode() for n, s in read_fasta(test_p["draft_fasta"])}
    pol = {n: s.encode() for n, s in read_fasta(polished)}
    draft_res = assess_fastas(truth, draft)
    pol_res = assess_fastas(truth, pol)
    print("\n-- test species: draft vs truth (before)")
    print(format_report(draft_res))
    print("\n-- test species: polished vs truth (after)")
    print(format_report(pol_res))
    better = pol_res.error_rate < draft_res.error_rate
    print(
        f"\ngeneralisation to unseen species "
        f"{'holds' if better else 'FAILED'}: "
        f"{100 * draft_res.error_rate:.4f}% -> "
        f"{100 * pol_res.error_rate:.4f}% "
        f"({args.error_model} errors)"
    )
    return 0 if better else 1


if __name__ == "__main__":
    sys.exit(main())
