from repro_torch.serve.engine import ContinuousEngine, RequestError  # noqa: F401
from repro_torch.serve.sampling import greedy, make_sampler, temperature_sample  # noqa: F401
