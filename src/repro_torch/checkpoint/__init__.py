from repro_torch.checkpoint.ckpt import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
