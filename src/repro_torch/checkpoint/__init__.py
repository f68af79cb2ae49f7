from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_pytree,
    save_pytree,
)
