"""Training loop of the port."""
from repro_torch.train.evaluate import perplexity  # noqa: F401
from repro_torch.train.trainer import TrainState, Trainer, make_train_step  # noqa: F401
