"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
`device` argument they take `cuda`, and they raise when no card is
present instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mmgt_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def disable_tf32() -> None:
    """Run f32 matrix products and convolutions in full f32 on the card.
    PyTorch lets cuDNN convolutions use TF32 by default; the port's f32
    models (wav2vec2, WavLM, the SMGA decoder) are held to the JAX
    package's f32, so its entry points call this first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
