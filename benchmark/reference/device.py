"""Device choice of the reference: the device asked for, ``cuda`` by default.

Unlike the program's, it leaves the TF32 switches as the caller set them:
the benchmark turns TF32 off before it runs the reference, and the control
(``control.py``) turns it on.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    return torch.device("cuda" if device is None else device)
