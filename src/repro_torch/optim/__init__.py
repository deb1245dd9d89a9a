from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    make_optimizer,
)
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
