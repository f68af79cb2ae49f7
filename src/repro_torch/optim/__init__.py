from repro_torch.optim.optim import (  # noqa: F401
    OptimizerSpec,
    adamw_init,
    adamw_update,
    apply_updates,
    make_optimizer,
    sgd_init,
    sgd_update,
)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine  # noqa: F401
