from repro_torch.checkpoint.ckpt import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
