from repro_torch.optim.optimizers import (  # noqa: F401
    SGD,
    Adam,
    OptState,
    adam,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from repro_torch.optim.schedule import PlateauDecay, warmup_cosine  # noqa: F401
