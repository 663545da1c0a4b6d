"""Host-side char tokenizer: each character → ``min(ord(c), 127)``.

The empty string becomes the single code 0, and the ``[U, L]`` matrix is
padded to a length that is a multiple of 8 (the JAX package's
``utils/text.py`` without its native branch).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from graph_hypernetwork_forge_tpu_torch.utils.shapes import pad_bucket_textlen

ASCII_VOCAB = 128  # codes clamped to [0, 127]


def tokenize_texts(texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize → (``char_ids [U, L]`` int32, ``lengths [U]`` int32).

    Padded positions hold code 0 and are masked out by length.
    """
    codes: List[List[int]] = []
    for t in texts:
        c = [min(ord(ch), ASCII_VOCAB - 1) for ch in t]
        codes.append(c if c else [0])
    lengths = np.asarray([len(c) for c in codes], dtype=np.int32)
    max_len = pad_bucket_textlen(int(lengths.max()) if len(codes) else 1)
    char_ids = np.zeros((len(codes), max_len), dtype=np.int32)
    for i, c in enumerate(codes):
        char_ids[i, : len(c)] = c
    return char_ids, lengths
