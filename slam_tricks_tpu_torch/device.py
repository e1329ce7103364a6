"""Where the port's entry points put their tensors."""

import torch


def resolve(device=None):
    """The device an entry point uses: the card (``cuda``) unless the caller
    names another, e.g. ``device="cpu"``."""
    return torch.device("cuda") if device is None else torch.device(device)
