"""The port's ops: plain PyTorch versions and the five Hopper kernels.

K1 `attention.flash_attention`     CUDA C++  csrc/flash_attn.cu
K2 `norms.group_norm`              CUDA C++  csrc/group_norm.cu
K3 `fused_ln.ln_projections`       CUDA C++  csrc/ln_proj.cu
K4 `motion_attention.motion_attention`  CUDA C++  csrc/motion_attn.cu (+ ln_proj.cu)
K5 `attention.flash_attention_bwd` CUDA C++  csrc/flash_attn_bwd.cu

Each wrapper adds one to its counter where it launches its kernel, and
nowhere else: `LAUNCHES` in each module, `BWD_LAUNCHES` in `attention`
for K5. `launch_counts()` reports them by kernel name.
"""
from mmgt_tpu_torch.ops import attention as _attention
from mmgt_tpu_torch.ops import fused_ln as _fused_ln
from mmgt_tpu_torch.ops import motion_attention as _motion
from mmgt_tpu_torch.ops import norms as _norms

# (module, counter attribute) of every kernel, by name
KERNEL_COUNTERS = {
    "flash_attention": (_attention, "LAUNCHES"),
    "group_norm": (_norms, "LAUNCHES"),
    "ln_projections": (_fused_ln, "LAUNCHES"),
    "motion_attention": (_motion, "LAUNCHES"),
    "flash_attention_bwd": (_attention, "BWD_LAUNCHES"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
