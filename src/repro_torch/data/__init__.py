"""Data pipeline: synthetic translation and LM corpora, bucketing, batching."""
from repro_torch.data.pipeline import (  # noqa: F401
    LMBatchIterator,
    MTBatchIterator,
    SyntheticLMTask,
    SyntheticMTTask,
    pad_to,
)
