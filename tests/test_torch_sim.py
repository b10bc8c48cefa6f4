"""``roko_tpu_torch.sim.build_synthetic_project`` against
``roko_tpu.sim``: for a seed, the truth and draft FASTA, the reads and
truth BAMs and both ``.bai`` are byte-identical, in the uniform and the
homopolymer error regimes."""

import pytest

from roko_tpu.sim import build_synthetic_project as ref_project
from roko_tpu_torch.sim import build_synthetic_project as port_project

FILES = ("truth.fasta", "draft.fasta", "reads.bam", "reads.bam.bai", "truth.bam",
         "truth.bam.bai")


@pytest.mark.parametrize("kwargs", [
    dict(seed=7, genome_len=5000),
    dict(seed=3, genome_len=8000, read_len=200, coverage=20),
    dict(seed=11, genome_len=6000, hp_indel_bias=0.5, hp_extend=0.45),
], ids=["default", "short-reads", "homopolymer"])
def test_project_byte_identical(tmp_path, kwargs):
    want = ref_project(str(tmp_path / "ref"), **kwargs)
    got = port_project(str(tmp_path / "port"), **kwargs)
    assert {k: v.replace(str(tmp_path / "port"), "") for k, v in got.items()} == {
        k: v.replace(str(tmp_path / "ref"), "") for k, v in want.items()}
    for name in FILES:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), name
    assert (tmp_path / "port" / "reads.bam").stat().st_size > 10_000
