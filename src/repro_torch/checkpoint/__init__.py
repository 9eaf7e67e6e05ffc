from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager, load_metadata, load_pytree, save_pytree)
