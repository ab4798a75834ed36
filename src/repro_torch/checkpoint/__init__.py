"""Checkpoint files (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.ckpt import (CheckpointCorruptError,  # noqa: F401
                                         load_manifest, restore_checkpoint,
                                         save_checkpoint)
