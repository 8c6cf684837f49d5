"""Token ids of a prompt when no tokenizer is installed (the model's weights
are random, so the ids only have to be the same on both sides): numbers
drawn by NumPy's legacy generator seeded from the first four bytes of the
prompt's SHA-256, one per position in [3, vocab - 1), the first set to 0
and the last to 2.  A plain restatement of the rule the serving code
applies, so that the check works the ids out again."""
from __future__ import annotations

import hashlib

import numpy as np


def demo_ids(text: str, length: int, vocab: int) -> np.ndarray:
    digest = hashlib.sha256(text.encode()).digest()
    rng = np.random.RandomState(int.from_bytes(digest[:4], "little"))
    ids = rng.randint(3, vocab - 1, size=(length,))
    ids[0], ids[-1] = 0, 2
    return ids[None]
