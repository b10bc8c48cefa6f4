"""Alphabet, class count, window geometry and the encodings of the
feature extractor.

The port keeps its own copy of these values; they equal
``roko_tpu/constants.py`` (the tests hold the two against each other).
"""

from __future__ import annotations

GAP = "*"
UNKNOWN = "N"
ALPHABET = "ACGT" + GAP + UNKNOWN  # index == encoded value

ENCODING = {base: i for i, base in enumerate(ALPHABET)}

ENCODED_GAP = ENCODING[GAP]  # 4
ENCODED_UNKNOWN = ENCODING[UNKNOWN]  # 5

#: classes the model predicts: A, C, G, T, GAP
NUM_CLASSES = 5

#: feature values 0-5 encode a forward-strand base; the reverse strand adds
#: this offset
STRAND_OFFSET = 6
FEATURE_VOCAB = 2 * len(ALPHABET)  # 12

#: rows per feature window (reads sampled with replacement)
WINDOW_ROWS = 200
#: columns per feature window: (position, insertion-slot) pairs
WINDOW_COLS = 90
#: windows slide by this many columns
WINDOW_STRIDE = WINDOW_COLS // 3  # 30
#: insertion slots tracked after each draft position
MAX_INS = 3
#: rows reserved for the draft sequence itself (0, as in roko)
REF_ROWS = 0

#: contigs are cut into regions of this many bases, overlapping by
#: REGION_OVERLAP, one extraction job each
REGION_SIZE = 100_000
REGION_OVERLAP = 300

#: reads below this mapping quality are left out of the pileup
MIN_MAPQ = 10

# BAM flag bits (SAM spec section 1.4)
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAP = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

#: reads with any of these flags are left out of the pileup
FILTER_FLAG = FLAG_UNMAP | FLAG_DUP | FLAG_QCFAIL | FLAG_SUPPLEMENTARY | FLAG_SECONDARY

#: base letter -> encoded base, for read and draft sequences (lowercase
#: and N accepted, as in soft-masked FASTAs)
CHAR_TO_CODE = {
    "A": 0, "a": 0,
    "C": 1, "c": 1,
    "G": 2, "g": 2,
    "T": 3, "t": 3,
    "N": ENCODED_UNKNOWN, "n": ENCODED_UNKNOWN, "-": ENCODED_UNKNOWN,
    "*": ENCODED_GAP,
}

# CIGAR operation codes (SAM spec section 1.4.6): MIDNSHP=X
CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N, CIGAR_S, CIGAR_H, CIGAR_P, CIGAR_EQ, CIGAR_X = range(9)
CIGAR_OPS = "MIDNSHP=X"
#: ops that consume the query sequence / the reference sequence
CIGAR_CONSUMES_QUERY = (True, True, False, False, True, False, False, True, True)
CIGAR_CONSUMES_REF = (True, False, True, True, False, False, False, True, True)
