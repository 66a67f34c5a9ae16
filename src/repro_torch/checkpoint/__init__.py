from repro_torch.checkpoint.checkpointer import (save, restore, latest_step,
                                                 gc_old, COMMIT_MARKER)

__all__ = ["save", "restore", "latest_step", "gc_old", "COMMIT_MARKER"]
