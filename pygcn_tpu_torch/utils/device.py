"""The CLIs' device rule: ``--device cuda`` (their default) needs a card.

A module of its own, so that every CLI takes it from here, and an app that
must not import the model code (``apps/predict --from_export``) resolves its
device as the others do.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; raises for a CUDA request on a machine without a card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device cpu "
            "to run the plain versions on the CPU)"
        )
    return device
