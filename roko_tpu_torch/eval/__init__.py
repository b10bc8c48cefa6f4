"""Assembly assessment: the error rates and Q score of a polished
assembly against a truth assembly, the built-in equivalent of pomoxis'
``assess_assembly`` (copy of ``roko_tpu/eval``; host code)."""

from roko_tpu_torch.eval.align import banded_align, AlignResult
from roko_tpu_torch.eval.assess import (
    AssessResult,
    ContigAssessment,
    assess_fastas,
    assess_pair,
    format_report,
    write_bed,
    write_json,
)

__all__ = [
    "AlignResult",
    "AssessResult",
    "ContigAssessment",
    "assess_fastas",
    "assess_pair",
    "banded_align",
    "format_report",
    "write_bed",
    "write_json",
]
