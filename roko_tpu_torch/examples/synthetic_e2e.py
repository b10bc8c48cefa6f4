"""End-to-end walkthrough of the port on synthetic data: no external tools
and no download (counterpart of the reference's ``examples/synthetic_e2e.py``).

Builds a small ground-truth genome, an error-bearing draft and noisy
reads with the port's simulator (exact alignments by construction, so no
assembler or aligner is needed), then drives the port's command line:

    features (train + inference HDF5)  ->  train  ->  inference  ->  assess

and prints the draft's error rate beside the polished assembly's, both
from the built-in evaluator (``python -m roko_tpu_torch assess``)::

    python -m roko_tpu_torch.examples.synthetic_e2e [--workdir DIR] [--epochs N] \\
        [--error-model {uniform,homopolymer}] [--device {cuda,cpu}]

The model trains and polishes on the card (``--device cuda``, the
default); without one, pass ``--device cpu``. The recipe's numbers are
module constants, and :func:`training_arrays` / :func:`inference_batches`
build the windows the ``features`` stages write to HDF5 in memory, for a
machine without ``h5py`` (``chip_smoke.py``'s ``quality`` phase trains
on them with ``training.loop.train`` and polishes with
``infer.run_inference``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from roko_tpu_torch.config import TrainConfig
from roko_tpu_torch.eval.assess import AssessResult, assess_fastas, format_report, write_bed
from roko_tpu_torch.features.pipeline import open_region_stream
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.sim import build_synthetic_project

#: the recipe (``examples/synthetic_e2e.py`` of the reference): a 12 kb
#: genome at 30x, the sim's default seed, batch 64, lr 3e-3, 25 epochs,
#: 10 % of the training windows held out; features seeded 3 (train) and 4
#: (inference)
GENOME_LEN = 12_000
COVERAGE = 30
EPOCHS = 25
LR = 3e-3
BATCH = 64
VAL_FRACTION = 0.1
TRAIN_FEATURES_SEED = 3
INFER_FEATURES_SEED = 4
#: the homopolymer regime: a run-rich truth with indels concentrated in
#: runs (nanopore's dominant error class)
HOMOPOLYMER = {"hp_indel_bias": 3.0, "hp_extend": 0.45}
ERROR_MODELS = ("uniform", "homopolymer")

Batch = Tuple[List[str], np.ndarray, np.ndarray]


def error_model_knobs(error_model: str) -> Dict[str, float]:
    """The simulator's keyword arguments of an error regime."""
    if error_model not in ERROR_MODELS:
        raise ValueError(f"error model {error_model!r} is not one of {ERROR_MODELS}")
    return dict(HOMOPOLYMER) if error_model == "homopolymer" else {}


def build_project(workdir: str, error_model: str = "uniform", *, genome_len: int = GENOME_LEN,
                  coverage: int = COVERAGE) -> Dict[str, str]:
    """The recipe's simulated project (truth and draft FASTA, reads and
    truth BAMs) under ``workdir``; returns its paths and contig name."""
    return build_synthetic_project(workdir, genome_len=genome_len, coverage=coverage,
                                   **error_model_knobs(error_model))


def training_arrays(paths: Dict[str, str]) -> Tuple[np.ndarray, np.ndarray]:
    """``(X uint8[N,200,90], Y int32[N,90])``: the training windows and
    labels ``features DRAFT READS OUT --Y TRUTH --seed 3`` writes, in its
    order (regions in job order), built in memory."""
    with open_region_stream(paths["draft_fasta"], paths["reads_bam"], paths["truth_bam"],
                            seed=TRAIN_FEATURES_SEED, log=lambda s: None) as stream:
        blocks = [r for r in stream.results if r is not None and len(r[1])]
    if not blocks:
        raise ValueError(f"no labelled windows in {paths['draft_fasta']}")
    X = np.concatenate([b[2] for b in blocks]).astype(np.uint8, copy=False)
    Y = np.concatenate([b[3] for b in blocks]).astype(np.int32)
    return X, Y


def inference_batches(paths: Dict[str, str]) -> List[Batch]:
    """The inference windows ``features DRAFT READS OUT --seed 4`` writes,
    in memory, as ``run_inference``'s ``(names, positions, examples)``
    batches of ``BATCH`` (each contig's windows in its regions' order)."""
    out: List[Batch] = []
    with open_region_stream(paths["draft_fasta"], paths["reads_bam"], seed=INFER_FEATURES_SEED,
                            log=lambda s: None) as stream:
        blocks = [r for r in stream.results if r is not None and len(r[1])]
    for contig in dict.fromkeys(b[0] for b in blocks):
        positions = np.concatenate([b[1] for b in blocks if b[0] == contig])
        examples = np.concatenate([b[2] for b in blocks if b[0] == contig])
        for i in range(0, len(positions), BATCH):
            p = positions[i : i + BATCH]
            out.append(([contig] * len(p), p, examples[i : i + BATCH]))
    return out


def train_config(epochs: int = EPOCHS, lr: float = LR) -> TrainConfig:
    """The ``train`` stage's settings: ``--b 64 --epochs N --lr LR
    --val-fraction 0.1``, every other field at its default."""
    return TrainConfig(batch_size=BATCH, epochs=epochs, lr=lr, val_fraction=VAL_FRACTION)


def assess_polish(paths: Dict[str, str], polished: Dict[str, str], *,
                  collect_errors: bool = False) -> Tuple[AssessResult, AssessResult]:
    """(the draft against the truth, ``polished`` against the truth)."""
    truth = {n: s.encode() for n, s in read_fasta(paths["truth_fasta"])}
    draft = {n: s.encode() for n, s in read_fasta(paths["draft_fasta"])}
    return (assess_fastas(truth, draft),
            assess_fastas(truth, {n: s.encode() for n, s in polished.items()},
                          collect_errors=collect_errors))


def run_cli(argv: List[str]) -> None:
    """One stage through ``python -m roko_tpu_torch``; raises unless it
    exits 0."""
    from roko_tpu_torch.cli import main as cli

    rc = cli(argv)
    if rc != 0:
        raise RuntimeError(f"`{argv[0]}` exited {rc}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m roko_tpu_torch.examples.synthetic_e2e")
    ap.add_argument("--workdir", default="/tmp/roko_tpu_example")
    ap.add_argument("--genome-len", type=int, default=GENOME_LEN)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--coverage", type=int, default=COVERAGE,
                    help="simulated read depth; deeper pileups give the model more evidence "
                    "per column")
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--dp", type=int, default=-1)
    ap.add_argument("--error-model", choices=ERROR_MODELS, default="uniform",
                    help="homopolymer: run-rich truth genome with indels concentrated in "
                    "homopolymer runs, the adversarial regime for consensus polishing")
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
    print(f"== building synthetic project in {wd} ({args.error_model} errors)")
    paths = build_project(wd, args.error_model, genome_len=args.genome_len,
                          coverage=args.coverage)

    print("== stage 1: features (training mode, with truth labels)")
    train_h5 = os.path.join(wd, "train.hdf5")
    run_cli(["features", paths["draft_fasta"], paths["reads_bam"], train_h5,
             "--Y", paths["truth_bam"], "--seed", str(TRAIN_FEATURES_SEED)])

    print("== stage 1b: features (inference mode)")
    infer_h5 = os.path.join(wd, "infer.hdf5")
    run_cli(["features", paths["draft_fasta"], paths["reads_bam"], infer_h5,
             "--seed", str(INFER_FEATURES_SEED)])

    print(f"== stage 2: train ({args.epochs} epochs, holdout val)")
    ckpt = os.path.join(wd, "ckpt")
    run_cli(["train", train_h5, ckpt, "--b", str(BATCH), "--epochs", str(args.epochs),
             "--lr", str(args.lr), "--val-fraction", str(VAL_FRACTION),
             "--dp", str(args.dp), "--no-resume", "--device", args.device])

    print("== stage 3: inference -> polished FASTA")
    polished = os.path.join(wd, "polished.fasta")
    run_cli(["inference", infer_h5, ckpt, polished, "--b", str(BATCH),
             "--dp", str(args.dp), "--device", args.device])

    print("== stage 4: assess (built-in pomoxis-assess_assembly analogue)")
    draft_res, pol_res = assess_polish(paths, dict(read_fasta(polished)), collect_errors=True)
    print("\n-- draft vs truth (before polishing)")
    print(format_report(draft_res))
    print("\n-- polished vs truth (after)")
    print(format_report(pol_res))
    bed = os.path.join(wd, "residual_errors.bed")
    write_bed(pol_res, bed)
    print(f"residual error loci: {bed}")
    better = pol_res.error_rate < draft_res.error_rate
    print(
        f"\npolishing {'reduced' if better else 'did NOT reduce'} the error "
        f"rate: {100 * draft_res.error_rate:.4f}% -> "
        f"{100 * pol_res.error_rate:.4f}%"
    )
    return 0 if better else 1


if __name__ == "__main__":
    sys.exit(main())
