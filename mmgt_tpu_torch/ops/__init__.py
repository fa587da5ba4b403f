"""The port's ops: plain PyTorch versions and the four Hopper kernels.

K1 `attention.flash_attention`     CUDA C++  csrc/flash_attn.cu
K2 `norms.group_norm`              Triton    ops/norms.py
K3 `fused_ln.ln_projections`       CUDA C++  csrc/ln_proj.cu
K4 `motion_attention.motion_attention`  CUDA C++  csrc/motion_attn.cu (+ ln_proj.cu)

Each wrapper adds one to its module's `LAUNCHES` where it launches its
kernel, and nowhere else.
"""
from mmgt_tpu_torch.ops import attention as _attention
from mmgt_tpu_torch.ops import fused_ln as _fused_ln
from mmgt_tpu_torch.ops import motion_attention as _motion
from mmgt_tpu_torch.ops import norms as _norms

KERNEL_MODULES = {
    "flash_attention": _attention,
    "group_norm": _norms,
    "ln_projections": _fused_ln,
    "motion_attention": _motion,
}


def launch_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0
