"""Synthetic Bard corpus: byte-level char-LM data (paper §9.3 proxy); a copy
of ``repro/data/char_corpus.py`` (numpy only, so the bytes are equal).

The real Shakespeare file is unavailable offline, so we synthesize ~1MB of
byte text from a 3-gram Markov chain seeded with an embedded public-domain
passage.  The corpus has realistic char-LM statistics (entropy ~2 bits/char
of structure above uniform) — enough to test the paper's claim that SPM
matches dense NLL trajectories at ~4x lower step cost at d=4096.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_corpus", "corpus_batches", "VOCAB"]

VOCAB = 256

_SEED_TEXT = b"""
Shall I compare thee to a summer's day? Thou art more lovely and more
temperate: rough winds do shake the darling buds of May, and summer's
lease hath all too short a date. Sometime too hot the eye of heaven
shines, and often is his gold complexion dimm'd; and every fair from
fair sometime declines, by chance or nature's changing course untrimm'd.
But thy eternal summer shall not fade nor lose possession of that fair
thou ow'st; nor shall Death brag thou wander'st in his shade, when in
eternal lines to time thou grow'st: so long as men can breathe or eyes
can see, so long lives this, and this gives life to thee.
To be, or not to be, that is the question: whether 'tis nobler in the
mind to suffer the slings and arrows of outrageous fortune, or to take
arms against a sea of troubles and by opposing end them. To die - to
sleep, no more; and by a sleep to say we end the heart-ache and the
thousand natural shocks that flesh is heir to: 'tis a consummation
devoutly to be wish'd. To die, to sleep; to sleep, perchance to dream -
ay, there's the rub: for in that sleep of death what dreams may come,
when we have shuffled off this mortal coil, must give us pause - there's
the respect that makes calamity of so long life.
All the world's a stage, and all the men and women merely players; they
have their exits and their entrances, and one man in his time plays many
parts, his acts being seven ages. At first the infant, mewling and
puking in the nurse's arms. Then the whining schoolboy, with his satchel
and shining morning face, creeping like snail unwillingly to school.
"""


def build_corpus(n_bytes: int = 1_100_000, order: int = 3,
                 seed: int = 0) -> np.ndarray:
    """Markov-chain extension of the seed passage to ``n_bytes`` bytes."""
    rng = np.random.default_rng(seed)
    seedb = np.frombuffer(_SEED_TEXT, dtype=np.uint8)
    # transition table: context (order bytes) -> list of next bytes
    table: dict = {}
    for i in range(len(seedb) - order):
        ctx = bytes(seedb[i: i + order])
        table.setdefault(ctx, []).append(seedb[i + order])
    ctxs = list(table.keys())
    out = np.empty(n_bytes, np.uint8)
    out[: len(seedb)] = seedb
    pos = len(seedb)
    ctx = bytes(seedb[-order:])
    while pos < n_bytes:
        nexts = table.get(ctx)
        if not nexts:
            ctx = ctxs[rng.integers(len(ctxs))]
            continue
        b = nexts[rng.integers(len(nexts))]
        out[pos] = b
        pos += 1
        ctx = ctx[1:] + bytes([b])
    return out


def corpus_batches(corpus: np.ndarray, batch: int, seq_len: int,
                   rng: np.random.Generator):
    """Yield {tokens, labels} windows forever (deterministic given rng)."""
    n = len(corpus) - seq_len - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        idx = starts[:, None] + np.arange(seq_len + 1)[None, :]
        chunk = corpus[idx]
        yield {"tokens": chunk[:, :-1].astype(np.int32),
               "labels": chunk[:, 1:].astype(np.int32)}
