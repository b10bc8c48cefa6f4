"""Alphabet, class count and window geometry of the port.

The port keeps its own copy of these values; they equal
``roko_tpu/constants.py`` (the tests hold the two against each other).
"""

from __future__ import annotations

GAP = "*"
UNKNOWN = "N"
ALPHABET = "ACGT" + GAP + UNKNOWN  # index == encoded value

ENCODED_GAP = ALPHABET.index(GAP)  # 4

#: classes the model predicts: A, C, G, T, GAP
NUM_CLASSES = 5

#: feature values 0-5 encode a forward-strand base; the reverse strand adds 6
FEATURE_VOCAB = 2 * len(ALPHABET)  # 12

#: rows per feature window (reads sampled with replacement)
WINDOW_ROWS = 200
#: columns per feature window: (position, insertion-slot) pairs
WINDOW_COLS = 90
#: windows slide by this many columns
WINDOW_STRIDE = WINDOW_COLS // 3  # 30
#: insertion slots tracked after each draft position
MAX_INS = 3
