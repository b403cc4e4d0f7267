"""Checkpoints in the reference's ``.npz`` + JSON layout (``checkpoint.io``)."""

from repro_torch.checkpoint.io import (  # noqa: F401
    load_checkpoint,
    load_pytree,
    load_round_state,
    save_checkpoint,
    save_pytree,
    save_round_state,
)
