"""Data: the synthetic char-LM corpus and the deterministic loader."""

from repro_torch.data.char_corpus import (VOCAB, build_corpus,  # noqa: F401
                                          corpus_batches)
from repro_torch.data.loader import DeterministicLoader  # noqa: F401
