"""mmgt_tpu_torch: the PyTorch/CUDA port of `mmgt_tpu` for NVIDIA Hopper.

Same modules, same channel-last layouts and the same math as the JAX
package; every Pallas kernel of the Stage-2 pose->video path is a kernel
written by hand for sm_90a (`ops/`, sources under `csrc/`). The package
imports torch, numpy and the standard library only.
"""
from mmgt_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
