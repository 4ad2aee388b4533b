"""Data pipeline: synthetic translation corpus, bucketing, batching."""
from repro_torch.data.pipeline import MTBatchIterator, SyntheticMTTask, pad_to  # noqa: F401
