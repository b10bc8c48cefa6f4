"""The port's end-to-end quality loop on the CPU, held against ``roko_tpu``
(counterpart of ``tests/test_end_to_end.py``, with the recipe of
``roko_tpu_torch/examples/synthetic_e2e.py``):

- the in-memory route that ``chip_smoke.py``'s ``quality`` phase trains
  and polishes on (``synthetic_e2e.training_arrays`` /
  ``inference_batches``) holds exactly the windows and labels that
  ``python -m roko_tpu_torch features`` writes to HDF5;
- the draft's ``assess_fastas`` report equals ``roko_tpu``'s, and the
  draft error rates BASELINE.md prints for the reference example
  (1.2083 % uniform, 4.2167 % homopolymer);
- with the same trained weights (``tests/torch_golden/e2e_tiny_gru.npz``,
  made by ``roko_tpu``'s train) the port polishes a held-out genome to the
  reference's FASTA byte for byte, through the HDF5 and the in-memory
  route, and the polish removes draft errors;
- the composed alignments of the accuracy test's genomes are consistent
  and equal to the reference's;
- ``test_polish_reduces_draft_error`` (slow, as the reference's): the
  port trains on genome A and polishes held-out genome B to under a third
  of the draft's error."""

import difflib
import random

import numpy as np
import pytest
import torch

from roko_tpu.config import RokoConfig
from roko_tpu.eval.assess import assess_fastas as ref_assess_fastas
from roko_tpu.eval.assess import format_report as ref_format_report
from roko_tpu.infer import polish_to_fasta as ref_polish_to_fasta
from roko_tpu_torch import cli
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ModelConfig, TrainConfig
from roko_tpu_torch.data.hdf5 import iter_inference_windows, load_contigs, read_training_groups
from roko_tpu_torch.eval.assess import assess_fastas, assess_pair, format_report
from roko_tpu_torch.examples import multispecies_protocol
from roko_tpu_torch.examples import synthetic_e2e as e2e
from roko_tpu_torch.features.pipeline import run_features
from roko_tpu_torch.infer import polish_to_fasta, run_inference
from roko_tpu_torch.io.bam import write_sorted_bam
from roko_tpu_torch.io.fasta import read_fasta, write_fasta
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.sim import (
    build_synthetic_project,
    compose_read_to_draft,
    make_record,
    mutate_with_cigar,
    random_genome,
    simulate_reads,
    truth_to_draft_map,
)
from roko_tpu_torch.training import loop
from tests.test_end_to_end import _build_genome as ref_build_genome
from tests.torch_golden import e2e_tiny_gru as golden
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the reference example's draft rows in BASELINE.md, to the printed digits
BASELINE_DRAFT_PCT = {"uniform": "1.2083", "homopolymer": "4.2167"}


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """The recipe's 12 kb / 30x project in each error regime."""
    root = tmp_path_factory.mktemp("torch_e2e")
    return {m: e2e.build_project(str(root / m), m) for m in e2e.ERROR_MODELS}


@pytest.mark.parametrize("regime", e2e.ERROR_MODELS)
def test_in_memory_windows_equal_the_cli_hdf5(projects, tmp_path, regime):
    p = projects[regime]
    train_h5, infer_h5 = str(tmp_path / "train.hdf5"), str(tmp_path / "infer.hdf5")
    assert cli.main(["features", p["draft_fasta"], p["reads_bam"], train_h5,
                     "--Y", p["truth_bam"], "--seed", str(e2e.TRAIN_FEATURES_SEED)]) == 0
    assert cli.main(["features", p["draft_fasta"], p["reads_bam"], infer_h5,
                     "--seed", str(e2e.INFER_FEATURES_SEED)]) == 0

    groups = list(read_training_groups(train_h5))
    X, Y = e2e.training_arrays(p)
    assert X.dtype == np.uint8 and Y.dtype == np.int32
    assert X.shape == (len(Y), C.WINDOW_ROWS, C.WINDOW_COLS) and len(X) > 500
    np.testing.assert_array_equal(X, np.concatenate([g[1] for g in groups]))
    np.testing.assert_array_equal(Y, np.concatenate([g[2] for g in groups]))

    want = list(iter_inference_windows(infer_h5, e2e.BATCH))
    got = e2e.inference_batches(p)
    assert len(got) == len(want) > 5
    for (n1, p1, x1), (n2, p2, x2) in zip(got, want):
        assert n1 == n2 == [p["contig"]] * len(p1)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(x1, x2)


@pytest.mark.parametrize("regime", e2e.ERROR_MODELS)
def test_draft_assess_equals_reference_and_baseline(projects, regime):
    p = projects[regime]
    truth = {n: s.encode() for n, s in read_fasta(p["truth_fasta"])}
    draft = {n: s.encode() for n, s in read_fasta(p["draft_fasta"])}
    got, want = assess_fastas(truth, draft), ref_assess_fastas(truth, draft)
    assert got.summary() == want.summary()
    assert [vars(c) for c in got.contigs] == [vars(c) for c in want.contigs]
    assert format_report(got) == ref_format_report(want)
    assert f"{100 * got.error_rate:.4f}" == BASELINE_DRAFT_PCT[regime]
    # the example's own scoring of the project
    draft_res, _ = e2e.assess_polish(p, {p["contig"]: draft[p["contig"]].decode()})
    assert draft_res.summary() == got.summary()


def test_trained_weights_polish_the_same_bytes(tmp_path):
    """``roko_tpu``-trained TINY_GRU weights polish a held-out genome to the
    same FASTA in both packages, and remove most of its draft errors."""
    params = golden.load()
    p = build_synthetic_project(str(tmp_path / "sim"), seed=golden.TRAIN_SIM_SEED + 1,
                                genome_len=golden.GENOME_LEN, contig="eval")
    infer_h5 = str(tmp_path / "infer.hdf5")
    run_features(p["draft_fasta"], p["reads_bam"], infer_h5, seed=e2e.INFER_FEATURES_SEED,
                 log=lambda *a: None)
    jcfg = golden.model_config()
    ref_out, port_out = tmp_path / "ref.fasta", tmp_path / "port.fasta"
    ref_polish_to_fasta(infer_h5, params, str(ref_out), RokoConfig(model=jcfg),
                        batch_size=e2e.BATCH, log=lambda s: None)
    model = RokoModel(ModelConfig(kind="gru", embed_dim=jcfg.embed_dim, read_mlp=jcfg.read_mlp,
                                  hidden_size=jcfg.hidden_size, num_layers=jcfg.num_layers))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    polished = polish_to_fasta(infer_h5, model, str(port_out), device="cpu",
                               batch_size=e2e.BATCH, log=lambda s: None)
    assert port_out.read_bytes() == ref_out.read_bytes()
    # the card's route: the same windows from memory, the same votes
    in_memory = run_inference(iter(e2e.inference_batches(p)), load_contigs(infer_h5), model,
                              device="cpu", log=lambda s: None)
    assert in_memory == polished

    draft_res, pol_res = e2e.assess_polish(p, polished)
    truth = {n: s.encode() for n, s in read_fasta(p["truth_fasta"])}
    want = ref_assess_fastas(truth, {n: s.encode() for n, s in read_fasta(str(ref_out))})
    assert pol_res.summary() == want.summary()
    assert [vars(c) for c in pol_res.contigs] == [vars(c) for c in want.contigs]
    draft = read_fasta(p["draft_fasta"])[0][1]
    assert polished["eval"] != draft and set(polished["eval"]) <= set("ACGT")
    assert pol_res.error_rate < draft_res.error_rate / 3, (draft_res.summary(),
                                                           pol_res.summary())


@pytest.mark.parametrize("example", [e2e, multispecies_protocol],
                         ids=["synthetic_e2e", "multispecies_protocol"])
def test_examples_refuse_cuda_without_a_card(example, tmp_path, monkeypatch, capsys):
    """No card and no ``--device cpu``: a usage error before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        example.main(["--workdir", str(tmp_path / "work")])
    assert exit_info.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "work").exists()


# -- the accuracy test's genomes ----------------------------------------------

def _build_genome(seed: int, length: int, contig: str, hp: bool = False):
    """The port's simulator in the reference test's recipe: truth, an
    error-bearing draft, and 30x reads re-mapped onto the draft."""
    rng = random.Random(seed)
    truth = random_genome(rng, length, hp_extend=0.45 if hp else 0.0)
    bias = 3.0 if hp else 0.0
    draft, cig = mutate_with_cigar(rng, truth, sub_rate=0.005, ins_rate=0.003,
                                   del_rate=0.003, hp_indel_bias=bias)
    t2d = truth_to_draft_map(cig)
    reads_t = simulate_reads(rng, truth, 0, coverage=30, read_len=400, sub_rate=0.02,
                             ins_rate=0.01, del_rate=0.01, hp_indel_bias=bias)
    reads_d = []
    for r in reads_t:
        res = compose_read_to_draft(r.pos, r.cigar, t2d)
        if res is None:
            continue
        pos_d, cigar_d = res
        reads_d.append(make_record(r.name, 0, pos_d, r.seq, cigar_d, flag=r.flag, mapq=60))
    return truth, draft, cig, reads_d


@pytest.mark.parametrize("hp", [False, True], ids=["uniform", "homopolymer"])
def test_composed_alignments_are_consistent(hp):
    """Query length of every composed CIGAR matches the read sequence, each
    read ends inside the draft, and the genome is the reference's."""
    truth, draft, cig, reads = _build_genome(3, 3000, "c", hp)
    assert reads
    for r in reads:
        qlen = sum(n for op, n in r.cigar if C.CIGAR_CONSUMES_QUERY[op])
        assert qlen == len(r.seq)
        ref_len = sum(n for op, n in r.cigar if C.CIGAR_CONSUMES_REF[op])
        assert r.pos + ref_len <= len(draft)
    want_truth, want_draft, want_cig, want_reads = ref_build_genome(3, 3000, "c", hp)
    assert (truth, draft, tuple(cig)) == (want_truth, want_draft, tuple(want_cig))
    fields = ("name", "flag", "tid", "pos", "mapq", "cigar", "seq", "qual")
    assert [tuple(getattr(r, f) for f in fields) for r in reads] == [
        tuple(getattr(r, f) for f in fields) for r in want_reads]


def _identity(a: str, b: str) -> float:
    return difflib.SequenceMatcher(None, a, b, autojunk=False).ratio()


# slow, as the reference's: each regime trains a model end to end on the
# CPU (full-width plain recurrences, minutes apiece). The code paths stay
# in tier-1 (features, train, inference and the stitch above and in the
# other test_torch_* files); chip_smoke.py's quality phase runs the
# example's recipe on the card.
@pytest.mark.slow
@pytest.mark.parametrize("hp", [False, True], ids=["uniform", "homopolymer"])
def test_polish_reduces_draft_error(tmp_path, hp):
    """Train on genome A, polish held-out genome B: the polished error must
    be well under the draft's, by sequence identity and by the assess tool."""
    truth_a, draft_a, cig_a, reads_a = _build_genome(1, 10000, "train", hp)
    write_fasta(str(tmp_path / "a.fasta"), [("train", draft_a)])
    write_sorted_bam(str(tmp_path / "a.bam"), [("train", len(draft_a))], reads_a)
    write_sorted_bam(str(tmp_path / "a_truth.bam"), [("train", len(draft_a))],
                     [make_record("truth", 0, 0, truth_a, cig_a)])
    n = run_features(str(tmp_path / "a.fasta"), str(tmp_path / "a.bam"),
                     str(tmp_path / "train.hdf5"), bam_y=str(tmp_path / "a_truth.bam"), seed=3,
                     log=lambda *a: None)
    assert n > 100

    truth_b, draft_b, _, reads_b = _build_genome(2, 6000, "eval", hp)
    write_fasta(str(tmp_path / "b.fasta"), [("eval", draft_b)])
    write_sorted_bam(str(tmp_path / "b.bam"), [("eval", len(draft_b))], reads_b)
    infer_h5 = str(tmp_path / "infer.hdf5")
    run_features(str(tmp_path / "b.fasta"), str(tmp_path / "b.bam"), infer_h5, seed=4,
                 log=lambda *a: None)

    cfg = ModelConfig(embed_dim=32, read_mlp=(64, 8), hidden_size=64, num_layers=2)
    result = loop.train(str(tmp_path / "train.hdf5"), str(tmp_path / "ckpt"), model_cfg=cfg,
                        train_cfg=TrainConfig(batch_size=64, epochs=10, lr=1.5e-3, patience=10),
                        device="cpu", log=lambda s: None)
    polished = run_inference(iter_inference_windows(infer_h5, 64), load_contigs(infer_h5),
                             result.model, device="cpu", log=lambda s: None)["eval"]

    draft_err = 1.0 - _identity(draft_b, truth_b)
    pol_err = 1.0 - _identity(polished, truth_b)
    assert draft_err > 0.004  # the fixture's draft is bad
    assert pol_err < draft_err / 3, (draft_err, pol_err)
    draft_q = assess_pair(truth_b.encode(), draft_b.encode(), truth_name="eval")
    pol_q = assess_pair(truth_b.encode(), polished.encode(), truth_name="eval")
    assert pol_q.error_rate < draft_q.error_rate / 3, (draft_q, pol_q)
