from repro_torch.checkpoint.io import (latest_step, read_manifest,
                                       restore_checkpoint, save_checkpoint)

__all__ = ["latest_step", "read_manifest", "restore_checkpoint",
           "save_checkpoint"]
