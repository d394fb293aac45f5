"""Data: the paper-experiment generators (the compositional teacher, hashed
text, the synthetic char-LM corpus) and the deterministic loader."""

from repro_torch.data.teacher import (TeacherConfig,  # noqa: F401
                                      make_teacher, teacher_batch,
                                      teacher_labels, teacher_logits)
from repro_torch.data.hashed_text import (HashedTextConfig,  # noqa: F401
                                          hashed_text_batch,
                                          hashed_text_build,
                                          hashed_text_draws)
from repro_torch.data.char_corpus import (VOCAB, build_corpus,  # noqa: F401
                                          corpus_batches)
from repro_torch.data.loader import (DataCursor,  # noqa: F401
                                    DeterministicLoader)
